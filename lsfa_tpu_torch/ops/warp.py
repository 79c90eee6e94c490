"""Bilinear feature warping by a flow field (zero contribution from every
corner outside the map), the counterpart of ``lsfa_tpu.ops.warp``.

``F.grid_sample`` with ``align_corners=True`` and ``padding_mode="zeros"``
computes exactly this sample once pixel coordinates are normalized by
(W-1, H-1): each of the four corners that falls outside adds zero. The
normalization round trip moves a sample position by float rounding only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def flow_warp(feat, flow):
    """Warp NHWC `feat` (B, H, W, C) by `flow` (B, H, W, 2) whose channels
    are (dx, dy). Computes in float32; returns feat's dtype."""
    b, h, w, _ = feat.shape
    fl = flow.float()
    gy = torch.arange(h, device=feat.device, dtype=torch.float32).view(1, h, 1)
    gx = torch.arange(w, device=feat.device, dtype=torch.float32).view(1, 1, w)
    sx = gx + fl[..., 0]
    sy = gy + fl[..., 1]
    grid = torch.stack([sx * (2.0 / max(w - 1, 1)) - 1.0,
                        sy * (2.0 / max(h - 1, 1)) - 1.0], dim=-1)
    out = F.grid_sample(feat.float().permute(0, 3, 1, 2), grid, mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    return out.permute(0, 2, 3, 1).to(feat.dtype)
