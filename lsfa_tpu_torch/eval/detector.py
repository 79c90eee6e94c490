"""Test-time detection: proposals -> PSROI scoring -> per-class NMS, over a
batch of frames.

The counterpart of ``lsfa_tpu.eval.detector``, with the `vmap` written out
as a leading batch dim: every step after the network forward runs on the
device, and a frame's detections come back as one fixed-size (M, 6)
[label, score, x1, y1, x2, y2] tensor in original-image coordinates.
"""

from __future__ import annotations

import torch

from lsfa_tpu_torch.ops.anchors import anchor_grid
from lsfa_tpu_torch.ops.boxes import bbox_pred, clip_boxes
from lsfa_tpu_torch.ops.nms import nms_fixed
from lsfa_tpu_torch.ops.proposal import rpn_proposals
from lsfa_tpu_torch.ops.psroi_pool import psroi_pool
from lsfa_tpu_torch.utils.profiler import count, span


def postprocess_detections(cls_prob, bbox_deltas, rois, roi_valid, im_info,
                           num_classes: int, max_per_image: int = 300,
                           nms_thresh: float = 0.3, score_thresh: float = 1e-3,
                           bbox_stds=(0.1, 0.1, 0.2, 0.2),
                           bbox_means=(0.0, 0.0, 0.0, 0.0),
                           num_reg_classes: int = 2):
    """cls_prob (B, R, C) softmax scores; bbox_deltas (B, R, 4*num_reg)
    normalized deltas (class-agnostic fg slot 1 when num_reg_classes == 2);
    rois (B, R, 5); roi_valid (B, R); im_info (B, 3).

    Returns dets (B, max_per_image, 6) and valid (B, max_per_image)."""
    bsz, r, _ = cls_prob.shape
    # un-normalize with Python scalars: a host-made tensor would cost a copy
    d = bbox_deltas.reshape(bsz, r, num_reg_classes, 4)[:, :, 1:]  # bg slot never decoded
    deltas = torch.stack([d[..., k] * bbox_stds[k] + bbox_means[k] for k in range(4)],
                         dim=-1).reshape(bsz, r, -1)
    boxes = clip_boxes(bbox_pred(rois[..., 1:5], deltas), im_info[:, :2])
    boxes = boxes / im_info[:, 2].reshape(bsz, 1, 1)         # back to original coords
    boxes = boxes.reshape(bsz, r, num_reg_classes - 1, 4).transpose(1, 2)  # (B, K, R, 4)

    c1 = num_classes - 1
    fg_scores = cls_prob[:, :, 1:].transpose(1, 2)           # (B, C-1, R)
    if num_reg_classes == 2:
        cls_boxes = boxes.expand(bsz, c1, r, 4)
    else:
        cls_boxes = boxes
    ok = roi_valid[:, None, :] & (fg_scores > score_thresh)
    keep_idx, keep_valid = nms_fixed(cls_boxes.reshape(bsz * c1, r, 4),
                                     fg_scores.reshape(bsz * c1, r), nms_thresh,
                                     max_per_image, valid=ok.reshape(bsz * c1, r))
    m = keep_idx.shape[1]
    keep_idx = keep_idx.reshape(bsz, c1, m)
    keep_valid = keep_valid.reshape(bsz, c1, m)
    scores = torch.gather(fg_scores, 2, keep_idx)
    scores = torch.where(keep_valid, scores, torch.full_like(scores, -1.0))
    flat_boxes = torch.gather(cls_boxes, 2, keep_idx[..., None].expand(-1, -1, -1, 4))

    # global top max_per_image across classes; a stable sort keeps
    # lax.top_k's tie rule (lower index first)
    top_scores, top_i = torch.sort(scores.reshape(bsz, -1), dim=-1, descending=True,
                                   stable=True)
    top_scores, top_i = top_scores[:, :max_per_image], top_i[:, :max_per_image]
    labels = (top_i // m + 1).float()
    out_boxes = torch.gather(flat_boxes.reshape(bsz, -1, 4), 1,
                             top_i[..., None].expand(-1, -1, 4))
    dets = torch.cat([labels[..., None], top_scores[..., None], out_boxes], dim=-1)
    return dets, top_scores > 0


def detect_batch(out, anchors, im_info, num_classes: int, pre_nms: int = 6000,
                 post_nms: int = 300, rpn_nms_thresh: float = 0.7, min_size: int = 0,
                 feat_stride: int = 16, max_per_image: int = 300,
                 nms_thresh: float = 0.3, score_thresh: float = 1e-3,
                 bbox_stds=(0.1, 0.1, 0.2, 0.2), nms_tier: int = 0,
                 group_size: int = 7, num_reg_classes: int = 2):
    """Detections for every frame of a phase-graph output dict (leading
    batch dim B). im_info: (3,) shared across the batch, or (B, 3)."""
    fg = out["rpn_fg"]
    bsz = fg.shape[0]
    count("detect.frames", bsz)
    with span("detect"):
        im_info = im_info.float().reshape(-1, 3).expand(bsz, 3)
        with span("detect.proposals"):
            rois, _, roi_valid = rpn_proposals(
                fg, out["rpn_deltas"], anchors, im_info, pre_nms_top_n=pre_nms,
                post_nms_top_n=post_nms, nms_thresh=rpn_nms_thresh, min_size=min_size,
                feat_stride=feat_stride, nms_tier=nms_tier)
        with span("detect.psroi"):
            pool = dict(group_size=group_size, pooled_size=group_size,
                        spatial_scale=1.0 / feat_stride)
            pooled_cls = psroi_pool(out["rfcn_cls_map"], rois, num_classes, **pool)
            pooled_bbox = psroi_pool(out["rfcn_bbox_map"], rois, 4 * num_reg_classes, **pool)
            cls_prob = torch.softmax(pooled_cls.mean(dim=(2, 3)), dim=-1)
            bbox_deltas = pooled_bbox.mean(dim=(2, 3))
        with span("detect.classes"):
            return postprocess_detections(
                cls_prob, bbox_deltas, rois, roi_valid, im_info,
                num_classes=num_classes, max_per_image=max_per_image, nms_thresh=nms_thresh,
                score_thresh=score_thresh, bbox_stds=bbox_stds,
                num_reg_classes=num_reg_classes)


def detect_single(rpn_fg, rpn_deltas, cls_map, bbox_map, anchors, im_info, **kw):
    """One frame's unbatched maps (fh, fw, A), (fh, fw, 4A) and the R-FCN
    maps (fh, fw, .) -> its detections (M, 6) and validity (M,):
    `detect_batch` at B = 1, with its keyword arguments. The JAX
    package's `nms_pallas` has no counterpart: on a card the NMS kernel
    always runs."""
    out = {"rpn_fg": rpn_fg[None], "rpn_deltas": rpn_deltas[None],
           "rfcn_cls_map": cls_map[None], "rfcn_bbox_map": bbox_map[None]}
    dets, valid = detect_batch(out, anchors, im_info, **kw)
    return dets[0], valid[0]


def detect_from_maps(out, anchors, im_info, **kw):
    """One frame's output dict (leading batch dim 1) -> its detections
    (M, 6) and validity (M,): `detect_batch` at B = 1."""
    dets, valid = detect_batch(out, anchors, im_info, **kw)
    return dets[0], valid[0]


def detection_kwargs(cfg) -> dict:
    """The keyword arguments of `detect_batch` that a config sets (TEST.*
    proposal and NMS settings, the RPN tier, the class count)."""
    return dict(
        num_classes=cfg.dataset.NUM_CLASSES,
        pre_nms=cfg.TEST.RPN_PRE_NMS_TOP_N,
        post_nms=cfg.TEST.RPN_POST_NMS_TOP_N,
        rpn_nms_thresh=cfg.TEST.RPN_NMS_THRESH,
        min_size=cfg.TEST.RPN_MIN_SIZE,
        feat_stride=cfg.network.RPN_FEAT_STRIDE,
        max_per_image=cfg.TEST.max_per_image,
        nms_thresh=cfg.TEST.NMS,
        score_thresh=cfg.TEST.SCORE_THRESH,
        bbox_stds=tuple(cfg.TRAIN.BBOX_STDS),
        nms_tier=cfg.tpu.nms_tier,
        num_reg_classes=2 if cfg.CLASS_AGNOSTIC else cfg.dataset.NUM_CLASSES,
    )


def anchors_for(cfg, image_hw, device):
    """The anchor grid of the feature map of an image_hw bucket, on
    `device`."""
    stride = cfg.network.RPN_FEAT_STRIDE
    return torch.from_numpy(anchor_grid(
        image_hw[0] // stride, image_hw[1] // stride, stride,
        tuple(cfg.network.ANCHOR_RATIOS), tuple(cfg.network.ANCHOR_SCALES))).to(device)
