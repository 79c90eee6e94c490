"""RPN proposal generation with fixed shapes, batched over frames.

The counterpart of ``lsfa_tpu.ops.proposal``: decode deltas on the anchor
grid (h, w, a), clip to the real image extent, mask anchors whose cell lies
outside the real feature extent and boxes under the min size, take the top
`min(pre_nms_top_n, nms_tier)` by fg score, greedy NMS, and emit
`post_nms_top_n` rois [0, x1, y1, x2, y2] padded with the last kept roi.
"""

from __future__ import annotations

import torch

from lsfa_tpu_torch.ops.boxes import bbox_pred, clip_boxes, iou_pred
from lsfa_tpu_torch.ops.nms import nms_fixed


def proposal_candidates(fg_scores, bbox_deltas, anchors, im_info,
                        pre_nms_top_n: int = 6000, min_size: int = 16,
                        feat_stride: int = 16, nms_tier: int = 0,
                        iou_loss: bool = False):
    """The NMS input of `rpn_proposals`: the top `min(pre_nms_top_n,
    nms_tier)` decoded boxes (B, K, 4) by fg score, their scores (B, K)
    (-inf where masked) and validity (B, K), in rank order."""
    bsz, h, w, a = fg_scores.shape
    dev = fg_scores.device
    scores = fg_scores.reshape(bsz, -1).float()
    deltas = bbox_deltas.reshape(bsz, -1, 4).float()
    im_info = im_info.float()

    decode = iou_pred if iou_loss else bbox_pred
    proposals = clip_boxes(decode(anchors, deltas), im_info[:, :2])

    real_h = (im_info[:, 0:1] / feat_stride).int()
    real_w = (im_info[:, 1:2] / feat_stride).int()
    cell = torch.arange(h * w * a, device=dev)
    in_real = ((cell // (w * a)) < real_h) & (((cell // a) % w) < real_w)

    ws = proposals[..., 2] - proposals[..., 0] + 1.0
    hs = proposals[..., 3] - proposals[..., 1] + 1.0
    ms = min_size * im_info[:, 2:3]
    keep_mask = in_real & (ws >= ms) & (hs >= ms)
    masked = torch.where(keep_mask, scores, torch.full_like(scores, float("-inf")))

    k = min(pre_nms_top_n, scores.shape[1])
    if nms_tier and nms_tier < k:
        k = nms_tier
    # a stable descending sort keeps lax.top_k's tie rule (lower index
    # first), which torch.topk does not promise
    top_scores, top_idx = torch.sort(masked, dim=-1, descending=True, stable=True)
    top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
    top_boxes = torch.gather(proposals, 1, top_idx[..., None].expand(-1, -1, 4))
    return top_boxes, top_scores, torch.isfinite(top_scores)


def rpn_proposals(fg_scores, bbox_deltas, anchors, im_info,
                  pre_nms_top_n: int = 6000, post_nms_top_n: int = 300,
                  nms_thresh: float = 0.7, min_size: int = 16,
                  feat_stride: int = 16, nms_tier: int = 0,
                  iou_loss: bool = False):
    """fg_scores (B, H, W, A); bbox_deltas (B, H, W, 4A) un-normalized;
    anchors (H*W*A, 4); im_info (B, 3) [im_h, im_w, im_scale].

    Returns rois (B, post, 5) float32, scores (B, post) (0 on padding) and
    valid (B, post) bool."""
    top_boxes, top_scores, top_valid = proposal_candidates(
        fg_scores, bbox_deltas, anchors, im_info, pre_nms_top_n, min_size,
        feat_stride, nms_tier, iou_loss)
    keep_idx, keep_valid = nms_fixed(top_boxes, top_scores, nms_thresh,
                                     post_nms_top_n, valid=top_valid,
                                     presorted=True)
    out_boxes = torch.gather(top_boxes, 1, keep_idx[..., None].expand(-1, -1, 4))
    out_scores = torch.where(keep_valid, torch.gather(top_scores, 1, keep_idx),
                             torch.zeros_like(keep_valid, dtype=torch.float32))
    rois = torch.cat([torch.zeros_like(out_boxes[..., :1]), out_boxes], dim=-1)
    return rois, out_scores, keep_valid
