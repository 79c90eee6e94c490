"""Device kernels (copies and memsets left out) in the traced sub-window,
over the frames it served."""


def read(run: dict):
    trace = run.get("trace")
    if not trace or not trace["kernels"]:
        return None
    return trace["kernels"] / run["trace_frames"]
