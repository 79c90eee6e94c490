"""Box geometry under the legacy "+1" width convention.

Boxes are (..., 4) float tensors [x1, y1, x2, y2] with inclusive corners,
as in ``lsfa_tpu.ops.boxes``; every function broadcasts over leading dims.
"""

from __future__ import annotations

import torch


def box_wh_ctr(boxes):
    """Width/height/center under the +1 convention."""
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    cx = boxes[..., 0] + 0.5 * (w - 1.0)
    cy = boxes[..., 1] + 0.5 * (h - 1.0)
    return w, h, cx, cy


def box_area(boxes):
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    return w * h


def bbox_pred(boxes, deltas):
    """Apply center/log-size deltas. boxes (..., N, 4); deltas (..., N, 4*K)
    -> (..., N, 4*K)."""
    w, h, cx, cy = box_wh_ctr(boxes)
    d = deltas.reshape(deltas.shape[:-1] + (-1, 4))
    pcx = d[..., 0] * w[..., None] + cx[..., None]
    pcy = d[..., 1] * h[..., None] + cy[..., None]
    pw = torch.exp(d[..., 2]) * w[..., None]
    ph = torch.exp(d[..., 3]) * h[..., None]
    out = torch.stack([pcx - 0.5 * (pw - 1.0), pcy - 0.5 * (ph - 1.0),
                       pcx + 0.5 * (pw - 1.0), pcy + 0.5 * (ph - 1.0)], dim=-1)
    return out.reshape(deltas.shape)


def iou_pred(boxes, deltas):
    """Per-corner additive offsets (the IoU-loss decode)."""
    d = deltas.reshape(deltas.shape[:-1] + (-1, 4))
    return (d + boxes[..., None, :]).reshape(deltas.shape)


def clip_boxes(boxes, im_hw):
    """Clamp (class-expanded) boxes to [0, W-1] x [0, H-1]. boxes
    (..., 4*K); im_hw (2,) shared, or (B, 2) for boxes with a leading B."""
    b = boxes.reshape(boxes.shape[:-1] + (-1, 4))
    h = im_hw[..., 0]
    w = im_hw[..., 1]
    bshape = h.shape + (1,) * (b.ndim - 1 - h.ndim)
    h = h.reshape(bshape)
    w = w.reshape(bshape)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    x1 = torch.minimum(torch.maximum(b[..., 0], zero), w - 1.0)
    y1 = torch.minimum(torch.maximum(b[..., 1], zero), h - 1.0)
    x2 = torch.minimum(torch.maximum(b[..., 2], zero), w - 1.0)
    y2 = torch.minimum(torch.maximum(b[..., 3], zero), h - 1.0)
    return torch.stack([x1, y1, x2, y2], dim=-1).reshape(boxes.shape)


def pairwise_iou(boxes_a, boxes_b):
    """IoU matrix (..., N, M) under the +1 convention; 0 where union <= 0."""
    ax1, ay1, ax2, ay2 = boxes_a.unbind(-1)
    bx1, by1, bx2, by2 = boxes_b.unbind(-1)
    iw = (torch.minimum(ax2[..., :, None], bx2[..., None, :])
          - torch.maximum(ax1[..., :, None], bx1[..., None, :]) + 1.0)
    ih = (torch.minimum(ay2[..., :, None], by2[..., None, :])
          - torch.maximum(ay1[..., :, None], by1[..., None, :]) + 1.0)
    inter = iw.clamp(min=0.0) * ih.clamp(min=0.0)
    union = box_area(boxes_a)[..., :, None] + box_area(boxes_b)[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))
