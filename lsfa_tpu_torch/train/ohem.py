"""Online hard example mining, batched over images; the counterpart of
``lsfa_tpu.train.ohem``: per-roi loss = cross-entropy + weighted
smooth-L1, keep the roi_per_img highest-loss eligible rois, and give every
other roi label -1 and zero bbox weight."""

from __future__ import annotations

import torch

from lsfa_tpu_torch.train.losses import smooth_l1


def ohem_select(cls_logits, bbox_deltas, labels, bbox_targets, bbox_weights,
                valid, roi_per_img: int = 128):
    """cls_logits (B, N, C); bbox_deltas, bbox_targets, bbox_weights
    (B, N, 4K); labels (B, N); valid (B, N) bool. Pass detached scores:
    the selection carries no gradient.

    Returns (labels (B, N) with -1 off the selection, bbox_weights zeroed
    off it)."""
    n, c = cls_logits.shape[-2:]
    labels_i = labels.long().clamp(0, c - 1)
    logp = torch.log_softmax(cls_logits.float(), dim=-1)
    cls_loss = -torch.gather(logp, -1, labels_i[..., None])[..., 0]
    box_loss = (bbox_weights * smooth_l1(bbox_deltas - bbox_targets, 1.0)).sum(-1)
    elig = valid & (labels >= 0)
    per_roi = torch.where(elig, cls_loss + box_loss, float("-inf"))
    # rank by (loss descending, index): a stable sort selects exactly the
    # top roi_per_img eligible rois, never -inf padding
    order = torch.argsort(-per_roi, dim=-1, stable=True)
    idx = torch.arange(n, device=labels.device).expand_as(order)
    rank = torch.empty_like(order).scatter_(-1, order, idx)
    keep = elig & (rank < roi_per_img)
    return (torch.where(keep, labels, -1.0),
            torch.where(keep[..., None], bbox_weights, 0.0))
