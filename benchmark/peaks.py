"""The yardstick's peaks and analytic counts (frozen here so that no change
to the program moves them).

Peaks of one NVIDIA H100 SXM from NVIDIA's data sheet (dense, no
sparsity), at its full 700 W power limit. The NMS fixpoint's operations
and bytes are counted from its shape (B items of N boxes), as the port's
``ops/nms_cuda.py`` counted them when this benchmark was written: one IoU
test of 16 float32 operations per pair of the strict upper triangle;
boxes and validity read once, the alive mask and a flag per item written
once.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
NMS_FLOPS_PER_PAIR = 16


def nms_flops(b: int, n: int) -> float:
    return NMS_FLOPS_PER_PAIR * b * n * (n - 1) / 2


def nms_bytes(b: int, n: int) -> int:
    return b * n * 16 + b * n + b * n + b


def nms_bound_s(b: int, n: int) -> float:
    """The least time of one NMS fixpoint over (b, n) boxes on an H100:
    the larger of its operations at the float32 peak and its bytes at the
    HBM peak."""
    return max(nms_flops(b, n) / PEAK_F32_FLOPS, nms_bytes(b, n) / PEAK_HBM_BYTES)


def nms_bound_per_frame_s(cfg: dict) -> float:
    """The NMS bound of one frame's detection under configuration `cfg`:
    the RPN's NMS over min(pre_nms, tier) candidates, and the per-class
    NMS of the NUM_CLASSES - 1 foreground classes over the post-NMS rois.
    Both scale with the items, so a batch of frames has the sum."""
    t = cfg["TEST"]
    n_rpn = t["RPN_PRE_NMS_TOP_N"]
    tier = cfg["tpu"]["nms_tier"]
    if tier:
        n_rpn = min(n_rpn, tier)
    classes = cfg["dataset"]["NUM_CLASSES"] - 1
    return nms_bound_s(1, n_rpn) + nms_bound_s(classes, t["RPN_POST_NMS_TOP_N"])
