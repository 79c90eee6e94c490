"""Fixed-shape greedy NMS, batched over a leading dim.

The counterpart of ``lsfa_tpu.ops.nms``: sort by score (stable) unless the
caller passes rank order, derive the greedy keep set as the fixpoint of

    alive <- valid & (alive . sup == 0),  sup[i, j] = (i < j) & (IoU(i, j) > t)

starting from f(valid), exiting at the fixpoint or after `num_sweeps`
applications (default min(N, 31), odd: an unconverged odd iterate is a
subset of the greedy keeps), then compact the alive ranks into `max_out`
slots with a cumsum scatter.

The fixpoint of a CUDA tensor runs in the kernel of ``ops/nms_cuda.py``,
whose exit test stays on the device; `greedy_alive` below is the plain
version, which CPU tensors take and against which the kernel is checked.
"""

from __future__ import annotations

import torch

from lsfa_tpu_torch.ops import nms_cuda


def suppression_matrix(boxes, iou_thresh: float):
    """(B, N, N) bool: sup[b, i, j] = (i < j) & (IoU(i, j) > iou_thresh),
    with IoU = inter / max(union, 1e-10) in the kernel's operation order."""
    x1, y1, x2, y2 = boxes.float().unbind(-1)
    area = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
    iw = (torch.minimum(x2[:, :, None], x2[:, None, :])
          - torch.maximum(x1[:, :, None], x1[:, None, :]) + 1.0)
    ih = (torch.minimum(y2[:, :, None], y2[:, None, :])
          - torch.maximum(y1[:, :, None], y1[:, None, :]) + 1.0)
    inter = iw.clamp(min=0.0) * ih.clamp(min=0.0)
    union = area[:, :, None] + area[:, None, :] - inter
    iou = inter / union.clamp(min=1e-10)
    n = boxes.shape[1]
    idx = torch.arange(n, device=boxes.device)
    upper = idx[:, None] < idx[None, :]
    return upper & (iou > iou_thresh)


def greedy_alive(boxes, valid, iou_thresh: float, num_sweeps: int,
                 with_converged: bool = False, init_alive=None):
    """Plain fixpoint sweeps on rank-sorted boxes (B, N, 4) with valid
    (B, N) bool. Returns the (B, N) alive mask, or (alive, converged (B,))
    when `with_converged`. Each item exits at its own fixpoint; the loop
    runs while any item is still changing, which leaves converged items
    unchanged."""
    sup = suppression_matrix(boxes, iou_thresh).float()

    def f(alive):
        hit = torch.bmm(alive.float()[:, None, :], sup)[:, 0]
        return valid & (hit == 0.0)

    start = valid if init_alive is None else init_alive
    alive = start
    if num_sweeps > 0:
        prev, alive, i = start, f(start), 1
        while i < num_sweeps and bool((alive != prev).any()):
            prev, alive, i = alive, f(alive), i + 1
    if not with_converged:
        return alive
    return alive, (f(alive) == alive).all(dim=-1)


def _alive(boxes, valid, iou_thresh, num_sweeps, with_converged):
    """The fixpoint by device: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if boxes.is_cuda:
        alive, converged = nms_cuda.greedy_alive_cuda(
            boxes.float().contiguous(), valid.contiguous(), iou_thresh, num_sweeps)
        return (alive, converged) if with_converged else alive
    return greedy_alive(boxes, valid, iou_thresh, num_sweeps,
                        with_converged=with_converged)


def nms_fixed(boxes, scores, iou_thresh: float, max_out: int, valid=None,
              max_iters: int | None = None, presorted: bool = False,
              return_converged: bool = False):
    """Greedy NMS with static shapes over a batch.

    boxes (B, N, 4); scores (B, N); valid (B, N) bool or None. Suppresses
    IoU > iou_thresh. With `presorted` the input is already in descending
    score order with invalid entries at the tail.

    Returns keep_idx (B, max_out) int64 indices into the input order by
    descending score, padding slots repeating the last kept index (0 when
    nothing is kept); keep_valid (B, max_out) bool; and with
    `return_converged` a (B,) bool that certifies the fixpoint was reached
    (the keep set then equals sequential greedy NMS).
    """
    bsz, n = scores.shape
    dev = boxes.device
    if max_iters is None:
        max_iters = min(n, 31)
    if valid is None:
        valid = torch.ones((bsz, n), dtype=torch.bool, device=dev)
    if presorted:
        order = torch.arange(n, device=dev).expand(bsz, n)
        b, v = boxes, valid
    else:
        masked = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
        order = torch.argsort(-masked, dim=-1, stable=True)
        b = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
        v = torch.gather(valid, 1, order)

    got = _alive(b, v, iou_thresh, max_iters, return_converged)
    alive, converged = got if return_converged else (got, None)

    # slot(i) = #alive with rank < i; alive rank i writes itself to slot(i),
    # every other rank to the dump slot max_out
    slot = torch.cumsum(alive.long(), dim=-1) - 1
    tgt = torch.where(alive & (slot < max_out), slot, torch.full_like(slot, max_out))
    kept_pos = torch.full((bsz, max_out + 1), -1, dtype=torch.long, device=dev)
    kept_pos.scatter_(1, tgt, torch.arange(n, device=dev).expand(bsz, n))
    kept_pos = kept_pos[:, :max_out]
    keep_valid = kept_pos >= 0
    num_kept = keep_valid.sum(dim=-1, keepdim=True)
    last = torch.gather(kept_pos, 1, (num_kept - 1).clamp(min=0))
    last = torch.where(num_kept > 0, last, torch.zeros_like(last))
    kept_pos = torch.where(keep_valid, kept_pos, last)
    keep_idx = torch.gather(order, 1, kept_pos)
    if return_converged:
        return keep_idx, keep_valid, converged
    return keep_idx, keep_valid
