"""Named training metrics (the reference's six EvalMetrics), the
counterparts of ``lsfa_tpu.train.metrics``: functions on the train step's
tensors with ignore-label (-1) filtering, and a host-side running average.
"""

from __future__ import annotations

import torch

from lsfa_tpu_torch.train.losses import rpn_pair, smooth_l1


def _labeled_mean(hit, labels):
    mask = labels >= 0
    return (hit & mask).sum() / mask.sum().clamp(min=1)


def _labeled_nll(logits, labels):
    logp = torch.log_softmax(logits.float(), dim=-1)
    mask = labels >= 0
    lbl = labels.long().clamp(0, logits.shape[-1] - 1)
    nll = -torch.gather(logp, -1, lbl[..., None])[..., 0]
    return torch.where(mask, nll, torch.zeros_like(nll)).sum() / mask.sum().clamp(min=1)


def rpn_acc(rpn_cls_logits, labels, num_anchors: int):
    pred = rpn_pair(rpn_cls_logits, num_anchors).argmax(dim=-1)
    return _labeled_mean(pred == labels, labels)


def rpn_log_loss(rpn_cls_logits, labels, num_anchors: int):
    return _labeled_nll(rpn_pair(rpn_cls_logits, num_anchors), labels)


def rpn_l1_loss(deltas, targets, weights, rpn_batch: int = 256):
    return (weights * smooth_l1(deltas - targets, 1.0)).sum() / rpn_batch


def rcnn_acc(cls_logits, labels):
    return _labeled_mean(cls_logits.argmax(dim=-1) == labels, labels)


def rcnn_log_loss(cls_logits, labels):
    return _labeled_nll(cls_logits, labels)


def rcnn_l1_loss(deltas, targets, weights, ohem_count: int = 128):
    return (weights * smooth_l1(deltas - targets, 1.0)).sum() / ohem_count


class MetricAverager:
    """Host-side running averages (the EvalMetric reset/update/get cycle).
    `update` reads each value with float(), a host sync for device tensors."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._sums: dict = {}
        self._n = 0

    def update(self, metrics: dict):
        for k, v in metrics.items():
            self._sums[k] = self._sums.get(k, 0.0) + float(v)
        self._n += 1

    def get(self) -> dict:
        return {k: v / max(self._n, 1) for k, v in self._sums.items()}
