"""Frames of every lane whose detections reached the host in the measured
window, over the window's seconds (host clock; the window ends at the
read-back of the last call enqueued before its time was up)."""


def read(run: dict):
    return run["frames"] / run["window_s"]
