"""The NMS kernel's share of its roofline in the traced sub-window: the sum
of the least times of every NMS the frames needed (``benchmark/peaks.py``:
the RPN's and the per-class NMS of each frame, at the H100's float32 and
HBM peaks) over the device time of the NMS kernels by name."""

from benchmark.peaks import nms_bound_per_frame_s

NAMES = ("nms", "build_sup", "sweep_fixpoint")


def read(run: dict):
    trace = run.get("trace")
    if not trace:
        return None
    spent = sum(s for n, s in trace["by_name"].items() if any(k in n for k in NAMES))
    if spent <= 0:
        return None
    return 100.0 * run["trace_frames"] * nms_bound_per_frame_s(run["cfg"]) / spent
