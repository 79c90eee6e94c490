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


def resized_dims(h: int, w: int, target_size: int, max_size: int):
    """Post-resize dims under the short-side/long-side rule."""
    smin, smax = min(h, w), max(h, w)
    im_scale = float(target_size) / smin
    if round(im_scale * smax) > max_size:
        im_scale = float(max_size) / smax
    return int(round(h * im_scale)), int(round(w * im_scale))


def pick_bucket(h: int, w: int, buckets, target_size: int, max_size: int):
    """Smallest configured (H, W) bucket that fits the resized image, so
    that portrait and landscape streams each run at their own shape and
    not at one worst-case square."""
    rh, rw = resized_dims(h, w, target_size, max_size)
    best = None
    for bh, bw in buckets:
        if rh <= bh and rw <= bw:
            if best is None or bh * bw < best[0] * best[1]:
                best = (bh, bw)
    if best is None:
        raise ValueError(
            f"no bucket in {list(buckets)} fits resized {rh}x{rw}; add one "
            f"to cfg.tpu.image_buckets")
    return best


def bgr_to_i420(frames: np.ndarray) -> np.ndarray:
    """(B, H, W, 3) uint8 BGR -> (B, H*3/2, W, 1) planar I420 uint8.

    BT.601 limited range with a 2x2 chroma mean: the inverse of the
    model's converter (``models/lsfa.py::LSFA._preprocess_i420``) up to
    rounding, and the packing the native data plane emits. BGR (0, 0, 0)
    padding maps to Y=16, U=V=128, which the model converts back to exact
    zeros. H and W must be multiples of 4."""
    b, g, r = (frames[..., i].astype(np.float32) for i in range(3))
    y = 16.0 + (65.481 * r + 128.553 * g + 24.966 * b) / 255.0
    cb = 128.0 + (-37.797 * r - 74.203 * g + 112.0 * b) / 255.0
    cr = 128.0 + (112.0 * r - 93.786 * g - 18.214 * b) / 255.0
    n, h, w = y.shape
    yp = np.clip(np.round(y), 0, 255).astype(np.uint8)

    def sub(c):
        c = c.reshape(n, h // 2, 2, w // 2, 2).mean((2, 4))
        return np.clip(np.round(c), 0, 255).astype(np.uint8)

    packed = np.concatenate([yp,
                             sub(cb).reshape(n, h // 4, w),
                             sub(cr).reshape(n, h // 4, w)], axis=1)
    return packed[..., None]
