"""The stream driver's host time: the benchmark's own host-clock span around
each call of the entry in the measured window, summed, over the frames
those calls enqueued (ms per frame)."""


def read(run: dict):
    if not run["frames"]:
        return None
    return run["enqueue_s"] / run["frames"] * 1e3
