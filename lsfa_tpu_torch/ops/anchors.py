"""Anchor generation (host-side numpy, computed once per feature shape).

The same enumeration as ``lsfa_tpu.ops.anchors``: ratio/scale anchors
around the (0, 0, base-1, base-1) window with rounded ratio widths, shifted
over the feature grid in (h, w, a) order.
"""

from __future__ import annotations

import numpy as np


def generate_anchors(base_size: int = 16, ratios=(0.5, 1, 2), scales=(8, 16, 32)) -> np.ndarray:
    """Return (A, 4) base anchors centered on the stride-`base_size` cell."""
    ratios = np.asarray(ratios, dtype=np.float64)
    scales = np.asarray(scales, dtype=np.float64)
    w = h = float(base_size)
    cx = cy = (base_size - 1) * 0.5
    size = w * h
    ws_r = np.round(np.sqrt(size / ratios))          # per-ratio width
    hs_r = np.round(ws_r * ratios)                   # per-ratio height
    ws = (ws_r[:, None] * scales[None, :]).reshape(-1)
    hs = (hs_r[:, None] * scales[None, :]).reshape(-1)
    return np.stack(
        [cx - 0.5 * (ws - 1), cy - 0.5 * (hs - 1), cx + 0.5 * (ws - 1), cy + 0.5 * (hs - 1)],
        axis=1,
    )


def anchor_grid(feat_h: int, feat_w: int, stride: int = 16,
                ratios=(0.5, 1, 2), scales=(8, 16, 32)) -> np.ndarray:
    """All shifted anchors for a (feat_h, feat_w) map, shape (H*W*A, 4),
    ordered (h, w, a) slowest-to-fastest — the layout the RPN head's
    (H, W, A*4) output flattens to."""
    base = generate_anchors(stride, ratios, scales)            # (A, 4)
    sx = np.arange(feat_w) * stride
    sy = np.arange(feat_h) * stride
    shift = np.stack(np.meshgrid(sx, sy), axis=-1)             # (H, W, 2) [x, y]
    shift4 = np.concatenate([shift, shift], axis=-1)           # (H, W, 4)
    all_anchors = shift4[:, :, None, :] + base[None, None]     # (H, W, A, 4)
    return all_anchors.reshape(-1, 4).astype(np.float32)
