"""RPN anchor assignment with fixed shapes, batched over images; the
counterpart of ``lsfa_tpu.train.anchor_assign``.

Anchors fully inside the real image take part. An anchor is background
where its best IoU is under the negative threshold, foreground where it is
some gt's best anchor (ties included) or its IoU reaches the positive
threshold (`clobber_positives` applies background last); with no gt every
inside anchor is background. Foreground is then cut to fg_fraction *
rpn_batch and background to the rest of rpn_batch by keeping the members
whose uniform draw is at most the quota-th smallest. Regression targets
point at each anchor's best gt, normalized by the anchor means/stds, with
weights on foreground only.

The uniform draws come in as tensors, so a caller chooses the generator:
the trainer draws them on the device, a test passes in the draws the JAX
package makes.
"""

from __future__ import annotations

import torch

from lsfa_tpu_torch.ops.boxes import bbox_transform, pairwise_iou


def assign_anchors(anchors, gt_boxes, gt_valid, im_info, u_fg, u_bg,
                   rpn_batch: int = 256, fg_fraction: float = 0.5,
                   pos_thresh: float = 0.7, neg_thresh: float = 0.3,
                   clobber_positives: bool = False,
                   allowed_border: float = 0.0,
                   normalize: bool = True,
                   means=(0.0, 0.0, 0.0, 0.0), stds=(0.1, 0.1, 0.4, 0.4),
                   rpn_bbox_weights=(1.0, 1.0, 1.0, 1.0)):
    """anchors (K, 4); gt_boxes (B, G, 5) [x1, y1, x2, y2, cls] padded;
    gt_valid (B, G) bool; im_info (B, 3) [h, w, scale]; u_fg, u_bg (B, K)
    uniform draws in [0, 1) for the fg and bg subsampling. means, stds and
    rpn_bbox_weights: sequences of 4, or float32 tensors on the device.

    Returns a dict: label (B, K) float in {-1, 0, 1}; bbox_target and
    bbox_weight (B, K, 4)."""
    k = anchors.shape[0]
    dev = anchors.device
    neg1 = torch.full((), -1.0, device=dev)
    ab = allowed_border
    inside = ((anchors[:, 0] >= -ab) & (anchors[:, 1] >= -ab)
              & (anchors[:, 2] < im_info[:, 1:2] + ab)
              & (anchors[:, 3] < im_info[:, 0:1] + ab))              # (B, K)

    iou = pairwise_iou(anchors, gt_boxes[..., :4])                  # (B, K, G)
    iou = torch.where(gt_valid[:, None, :], iou, neg1)
    any_gt = gt_valid.any(dim=-1, keepdim=True)                     # (B, 1)
    max_iou, argmax_gt = iou.max(dim=-1)

    # each gt's best inside anchors, all ties
    iou_in = torch.where(inside[..., None], iou, neg1)
    gt_max = iou_in.max(dim=1, keepdim=True).values                 # (B, 1, G)
    is_gt_best = ((iou_in == gt_max) & gt_valid[:, None, :] & (gt_max > 0)).any(dim=-1)

    label = torch.full_like(max_iou, -1.0)
    max_iou_in = torch.where(inside, max_iou, neg1)
    is_bg = inside & (max_iou_in < neg_thresh)
    is_fg = is_gt_best | (inside & (max_iou_in >= pos_thresh))
    if not clobber_positives:
        label = torch.where(is_fg, 1.0, torch.where(is_bg, 0.0, label))
    else:
        label = torch.where(is_bg, 0.0, torch.where(is_fg, 1.0, label))
    label = torch.where(any_gt, label, torch.where(inside, 0.0, neg1))

    fg_quota = int(fg_fraction * rpn_batch)
    is_fg = label == 1.0
    if fg_quota <= 0:
        label = torch.where(is_fg, neg1, label)
    else:
        r = torch.where(is_fg, u_fg, 2.0)                           # non-members last
        kth = torch.kthvalue(r, min(fg_quota, k), dim=-1, keepdim=True).values
        drop = is_fg & (r > kth) & (is_fg.sum(-1, keepdim=True) > fg_quota)
        label = torch.where(drop, neg1, label)
    is_bg = label == 0.0
    bg_quota = rpn_batch - (label == 1.0).sum(-1, keepdim=True)
    r = torch.where(is_bg, u_bg, 2.0)
    kth = torch.gather(torch.sort(r, dim=-1).values, 1, bg_quota.clamp(1, k) - 1)
    drop = is_bg & (r > kth) & (is_bg.sum(-1, keepdim=True) > bg_quota)
    label = torch.where(drop, neg1, label)

    tgt_gt = torch.gather(gt_boxes[..., :4], 1, argmax_gt[..., None].expand(-1, -1, 4))
    bbox_target = bbox_transform(anchors, tgt_gt)
    bbox_target = torch.where(any_gt[..., None], bbox_target, 0.0)
    if normalize:
        bbox_target = ((bbox_target - torch.as_tensor(means, dtype=torch.float32, device=dev))
                       / torch.as_tensor(stds, dtype=torch.float32, device=dev))
    bbox_weight = torch.where((label == 1.0)[..., None], torch.as_tensor(
        rpn_bbox_weights, dtype=torch.float32, device=dev), 0.0)
    bbox_target = bbox_target * (bbox_weight > 0)
    return {"label": label, "bbox_target": bbox_target, "bbox_weight": bbox_weight}
