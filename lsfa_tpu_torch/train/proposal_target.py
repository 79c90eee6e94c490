"""ROI targets with fixed shapes, batched over images; the counterpart of
``lsfa_tpu.train.proposal_target``.

`proposal_target` appends the gt boxes to the proposals as rois, labels
each roi with the class of its best gt where that IoU reaches fg_thresh
(else background), and expands regression targets toward the best gt into
the class-agnostic slot 1 or the roi's own class slot. `sample_rois_fixed`
is the BATCH_ROIS > 0 recipe: a fixed fg/bg minibatch drawn without
replacement, with the three uniform draws passed in.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from lsfa_tpu_torch.ops.boxes import bbox_transform, pairwise_iou


def proposal_target(rois, gt_boxes, gt_valid, fg_thresh: float = 0.5,
                    bbox_means=(0.0, 0.0, 0.0, 0.0),
                    bbox_stds=(0.1, 0.1, 0.2, 0.2),
                    bbox_weights=(1.0, 1.0, 1.0, 1.0),
                    num_reg_classes: int = 2,
                    normalization_precomputed: bool = True):
    """rois (B, R, 5) [batch_idx, x1, y1, x2, y2]; gt_boxes (B, G, 5)
    [x1, y1, x2, y2, cls] padded; gt_valid (B, G) bool.

    Returns a dict with N = R + G: rois (B, N, 5), label (B, N) float in
    {-1, 0, 1..C-1} (-1 on invalid gt slots), bbox_target and bbox_weight
    (B, N, 4 * num_reg_classes), valid (B, N) bool, max_iou (B, N)."""
    bsz, r = rois.shape[:2]
    g = gt_boxes.shape[1]
    dev = rois.device

    def const(values):
        return torch.as_tensor(values, dtype=torch.float32, device=dev)

    gt_as_rois = torch.cat([torch.zeros_like(gt_boxes[..., :1]), gt_boxes[..., :4]], dim=-1)
    all_rois = torch.cat([rois, gt_as_rois.to(rois.dtype)], dim=1)
    valid = torch.cat([torch.ones((bsz, r), dtype=torch.bool, device=dev), gt_valid], 1)
    n = r + g

    iou = pairwise_iou(all_rois[..., 1:5], gt_boxes[..., :4])       # (B, N, G)
    iou = torch.where(gt_valid[:, None, :], iou, torch.full((), -1.0, device=dev))
    max_iou, argmax_gt = iou.max(dim=-1)
    any_gt = gt_valid.any(dim=-1, keepdim=True)

    is_fg = (max_iou >= fg_thresh) & valid & any_gt
    label = torch.where(is_fg, torch.gather(gt_boxes[..., 4], 1, argmax_gt), 0.0)
    label = torch.where(valid, label, -1.0)

    best = torch.gather(gt_boxes[..., :4], 1, argmax_gt[..., None].expand(-1, -1, 4))
    targets = bbox_transform(all_rois[..., 1:5], best)
    if normalization_precomputed:
        targets = (targets - const(bbox_means)) / const(bbox_stds)
    # select, not multiply: a degenerate roi gives nan/inf targets, and
    # 0 * nan would leak through the one-hot expansion into the loss
    targets = torch.where(is_fg[..., None], targets, 0.0)
    if num_reg_classes == 2:
        slot = torch.ones((bsz, n), dtype=torch.long, device=dev)
    else:
        slot = label.long().clamp(0, num_reg_classes - 1)
    onehot = F.one_hot(slot, num_reg_classes).float() * is_fg[..., None]
    bbox_target = (onehot[..., None] * targets[..., None, :]).reshape(bsz, n, 4 * num_reg_classes)
    bbox_weight = (onehot[..., None] * const(bbox_weights)).reshape(
        bsz, n, 4 * num_reg_classes)
    return {"rois": all_rois, "label": label, "bbox_target": bbox_target,
            "bbox_weight": bbox_weight, "valid": valid, "max_iou": max_iou}


def _rank_among(mask, u):
    """Rank (B, N) of each mask member in the order of its draw u (ties by
    index); N for non-members."""
    n = mask.shape[-1]
    order = torch.argsort(torch.where(mask, u, float("inf")), dim=-1, stable=True)
    idx = torch.arange(n, device=mask.device).expand_as(order)
    rank = torch.empty_like(order).scatter_(-1, order, idx)
    return torch.where(mask, rank, n)


def sample_rois_fixed(tgt: dict, u_fg, u_bg, u_gap, batch_rois: int = 128,
                      fg_fraction: float = 0.25, bg_thresh_hi: float = 0.5,
                      bg_thresh_lo: float = 0.0):
    """BATCH_ROIS > 0 sampling over `proposal_target`'s output: up to
    round(fg_fraction * batch_rois) fg rois, then bg rois from the
    [bg_thresh_lo, bg_thresh_hi) IoU band, then any valid rois relabeled
    background to fill the batch. u_fg, u_bg, u_gap (B, N): uniform draws.

    Returns the same keys shaped (B, batch_rois, ...), valid all True."""
    bsz, n = tgt["label"].shape
    fg_n = int(round(fg_fraction * batch_rois))
    valid = tgt["valid"]
    is_fg = (tgt["label"] > 0) & valid
    is_bg = (tgt["max_iou"] < bg_thresh_hi) & (tgt["max_iou"] >= bg_thresh_lo) & valid

    fg_sel = _rank_among(is_fg, u_fg) < fg_n
    n_fg = fg_sel.sum(-1, keepdim=True)
    bg_sel = _rank_among(is_bg, u_bg) < batch_rois - n_fg
    n_bg = bg_sel.sum(-1, keepdim=True)
    gap_sel = _rank_among(valid, u_gap) < batch_rois - n_fg - n_bg

    # compact [fg | bg | gap] into batch_rois slots; slot batch_rois is a dump
    dump = torch.full_like(n_fg, batch_rois)
    sel_idx = torch.zeros((bsz, batch_rois + 1), dtype=torch.long, device=valid.device)
    idx = torch.arange(n, device=valid.device).expand(bsz, n)
    for sel, base in ((fg_sel, 0), (bg_sel, n_fg), (gap_sel, n_fg + n_bg)):
        slot = torch.where(sel, base + torch.cumsum(sel.long(), -1) - 1, dump)
        sel_idx = sel_idx.scatter(-1, slot, torch.where(sel, idx, 0))
    sel_idx = sel_idx[:, :batch_rois]

    keep_fg = torch.arange(batch_rois, device=valid.device) < n_fg   # (B, batch_rois)

    def take(x):
        return torch.gather(x, 1, sel_idx.reshape(sel_idx.shape + (1,) * (x.ndim - 2))
                            .expand((-1, -1) + x.shape[2:]))

    return {"rois": take(tgt["rois"]),
            "label": torch.where(keep_fg, take(tgt["label"]), 0.0),
            "bbox_target": torch.where(keep_fg[..., None], take(tgt["bbox_target"]), 0.0),
            "bbox_weight": torch.where(keep_fg[..., None], take(tgt["bbox_weight"]), 0.0),
            "valid": torch.ones((bsz, batch_rois), dtype=torch.bool, device=valid.device)}
