"""The share of the traced sub-window in which no operation ran on the
device: one minus the union of the device's intervals over the window's
span, from the end of the traced calls' lead-in (``benchmark/trace.py``)."""


def read(run: dict):
    trace = run.get("trace")
    if not trace or not trace.get("window_s") or not trace["busy_s"]:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
