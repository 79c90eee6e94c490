"""Host-side image helpers, copied from ``lsfa_tpu.data.image`` without PIL."""

from __future__ import annotations

import numpy as np


def pad_to_bucket(tensor: np.ndarray, bucket_hw, axis_h: int = 1,
                  axis_w: int = 2) -> np.ndarray:
    """Zero-pad an NHWC array to a fixed (H, W) bucket."""
    bh, bw = bucket_hw
    h, w = tensor.shape[axis_h], tensor.shape[axis_w]
    if h > bh or w > bw:
        raise ValueError(f"({h}, {w}) does not fit the bucket {tuple(bucket_hw)}")
    pads = [(0, 0)] * tensor.ndim
    pads[axis_h] = (0, bh - h)
    pads[axis_w] = (0, bw - w)
    return np.pad(tensor, pads)


def small_pool_factor(small_net_stride: int) -> int:
    """Host-side downscale factor feeding the small net: the model pools
    4x for stride 4 (backbone stage 1 adds /4) and 2x for stride 8 (stage 2
    adds /4)."""
    return 4 if small_net_stride == 4 else 2
