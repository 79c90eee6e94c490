"""Loss primitives with MXNet's op semantics, the counterparts of
``lsfa_tpu.train.losses``."""

from __future__ import annotations

import torch


def smooth_l1(x, sigma: float = 1.0):
    """MXNet smooth_l1 with scalar sigma: 0.5 (sigma x)^2 where |x| <
    1/sigma^2, else |x| - 0.5/sigma^2."""
    s2 = sigma * sigma
    ax = x.abs()
    return torch.where(ax < 1.0 / s2, 0.5 * s2 * x * x, ax - 0.5 / s2)


def softmax_ce_ignore(logits, labels, ignore_label: int = -1):
    """Softmax cross-entropy with an ignore label and 'valid' normalization
    (MXNet SoftmaxOutput(use_ignore, normalization='valid')).

    logits (..., C); labels (...,) float or int. Returns (the loss summed
    over labeled entries / max(#labeled, 1), per-entry loss, labeled mask).
    """
    labels_i = labels.long()
    mask = labels_i != ignore_label
    safe = labels_i.clamp(0, logits.shape[-1] - 1)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    nll = torch.where(mask, nll, torch.zeros_like(nll))
    return nll.sum() / mask.sum().clamp(min=1), nll, mask


def rpn_pair(rpn_cls_logits, num_anchors: int):
    """(..., 2A) [bg A | fg A] logits -> (..., A, 2) (bg, fg) pairs."""
    a = num_anchors
    return torch.stack([rpn_cls_logits[..., :a], rpn_cls_logits[..., a:]], dim=-1)


def rpn_losses(rpn_cls_logits, rpn_bbox_deltas, labels, bbox_targets,
               bbox_weights, num_anchors: int, rpn_batch: int = 256,
               normalized: bool = True):
    """RPN cross-entropy over labeled anchors and smooth-L1 (sigma 1 with
    normalized targets, else 3) over rpn_batch * B.

    rpn_cls_logits (B, H, W, 2A); labels (B, H, W, A); deltas, targets and
    weights (B, H, W, 4A)."""
    cls_loss, _, _ = softmax_ce_ignore(rpn_pair(rpn_cls_logits, num_anchors), labels)
    sigma = 1.0 if normalized else 3.0
    l1 = bbox_weights * smooth_l1(rpn_bbox_deltas - bbox_targets, sigma)
    return cls_loss, l1.sum() / (rpn_batch * max(labels.shape[0], 1))


def rcnn_losses(cls_logits, bbox_deltas, labels, bbox_targets, bbox_weights,
                ohem_count: int = 128):
    """R-FCN head losses after OHEM: cross-entropy normalized 'valid',
    smooth-L1 over ohem_count per image (labels (B, N) or (N,))."""
    cls_loss, _, _ = softmax_ce_ignore(cls_logits, labels)
    l1 = bbox_weights * smooth_l1(bbox_deltas - bbox_targets, 1.0)
    batch = labels.shape[0] if labels.ndim > 1 else 1
    return cls_loss, l1.sum() / (ohem_count * batch)
