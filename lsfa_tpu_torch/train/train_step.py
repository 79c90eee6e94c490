"""The end-to-end LSFA training step; the counterpart of
``lsfa_tpu.train.train_step``.

From the head maps of `LSFA.forward_train` (or of `RFCN`, in
`make_rfcn_train_step`) to the four losses: anchor assignment and RPN
losses, proposals from the detached RPN outputs (on a card the RPN NMS
fixpoint runs in the ``nms_sweep`` kernel), roi targets, PSROI
mean-pooled scores, OHEM on detached scores, and the R-FCN losses.
Everything stays on the device: the step reaches no ``.item()``,
``nonzero`` or host-built tensor, so it is enqueued without waiting.

The JAX step splits one PRNG key per step; here the uniform draws of the
subsampling are tensors (`draw_uniforms` makes them from a
``torch.Generator``), so a test can pass in the draws JAX makes.

Under a process group of several ranks (``parallel/mesh.py``) the step
keeps the JAX step's global-batch semantics: each rank draws the global
batch's uniforms and keeps its rows, normalizes its losses by the counts
over the global batch (images, labeled anchors, labeled rois), sums the
gradients over the ranks before the update and reports metrics over the
global batch, so every rank applies the update of one step on the whole
global batch.
"""

from __future__ import annotations

import dataclasses

import torch

from lsfa_tpu_torch.models.layers import full_float32
from lsfa_tpu_torch.ops.anchors import anchor_grid
from lsfa_tpu_torch.ops.proposal import rpn_proposals
from lsfa_tpu_torch.ops.psroi_pool import psroi_pool
from lsfa_tpu_torch.parallel import mesh
from lsfa_tpu_torch.train.anchor_assign import assign_anchors
from lsfa_tpu_torch.train.losses import rcnn_losses, rpn_losses, rpn_pair
from lsfa_tpu_torch.train.metrics import rcnn_acc, rpn_acc
from lsfa_tpu_torch.train.ohem import ohem_select
from lsfa_tpu_torch.train.proposal_target import proposal_target, sample_rois_fixed


@dataclasses.dataclass(frozen=True)
class TrainSettings:
    """Training knobs read from the config, field for field those of
    ``lsfa_tpu.train.train_step.TrainSettings`` but nms_pallas: the port
    takes the NMS kernel wherever the tensors are on a card."""

    num_classes: int = 31
    num_reg_classes: int = 2
    bbox_normalization_precomputed: bool = True
    num_anchors: int = 9
    feat_stride: int = 16
    anchor_scales: tuple = (8, 16, 32)
    anchor_ratios: tuple = (0.5, 1, 2)
    anchor_means: tuple = (0.0, 0.0, 0.0, 0.0)
    anchor_stds: tuple = (0.1, 0.1, 0.4, 0.4)
    normalize_rpn: bool = True
    rpn_batch: int = 256
    rpn_fg_fraction: float = 0.5
    rpn_pos_thresh: float = 0.7
    rpn_neg_thresh: float = 0.3
    rpn_clobber_positives: bool = False
    rpn_bbox_weights: tuple = (1.0, 1.0, 1.0, 1.0)
    pre_nms_top_n: int = 6000
    post_nms_top_n: int = 300
    nms_thresh: float = 0.7
    min_size: int = 0
    fg_thresh: float = 0.5
    bbox_means: tuple = (0.0, 0.0, 0.0, 0.0)
    bbox_stds: tuple = (0.1, 0.1, 0.2, 0.2)
    bbox_weights: tuple = (1.0, 1.0, 1.0, 1.0)
    ohem_rois: int = 128
    group_size: int = 7
    enable_ohem: bool = True
    batch_rois: int = -1
    fg_fraction: float = 0.25
    bg_thresh_hi: float = 0.5
    bg_thresh_lo: float = 0.0
    nms_tier: int = 0

    @classmethod
    def from_config(cls, cfg):
        t, n = cfg.TRAIN, cfg.network
        return cls(
            num_classes=cfg.dataset.NUM_CLASSES,
            num_reg_classes=2 if cfg.CLASS_AGNOSTIC else cfg.dataset.NUM_CLASSES,
            bbox_normalization_precomputed=t.BBOX_NORMALIZATION_PRECOMPUTED,
            num_anchors=n.NUM_ANCHORS,
            feat_stride=n.RPN_FEAT_STRIDE,
            anchor_scales=tuple(n.ANCHOR_SCALES),
            anchor_ratios=tuple(n.ANCHOR_RATIOS),
            anchor_means=tuple(n.ANCHOR_MEANS),
            anchor_stds=tuple(n.ANCHOR_STDS),
            normalize_rpn=n.NORMALIZE_RPN,
            rpn_batch=t.RPN_BATCH_SIZE,
            rpn_fg_fraction=t.RPN_FG_FRACTION,
            rpn_pos_thresh=t.RPN_POSITIVE_OVERLAP,
            rpn_neg_thresh=t.RPN_NEGATIVE_OVERLAP,
            rpn_clobber_positives=t.RPN_CLOBBER_POSITIVES,
            rpn_bbox_weights=tuple(t.RPN_BBOX_WEIGHTS),
            pre_nms_top_n=t.RPN_PRE_NMS_TOP_N,
            post_nms_top_n=t.RPN_POST_NMS_TOP_N,
            nms_thresh=t.RPN_NMS_THRESH,
            min_size=t.RPN_MIN_SIZE,
            fg_thresh=t.FG_THRESH,
            bbox_means=tuple(t.BBOX_MEANS),
            bbox_stds=tuple(t.BBOX_STDS),
            bbox_weights=tuple(t.BBOX_WEIGHTS),
            ohem_rois=t.BATCH_ROIS_OHEM,
            enable_ohem=t.ENABLE_OHEM,
            batch_rois=t.BATCH_ROIS,
            fg_fraction=t.FG_FRACTION,
            bg_thresh_hi=t.BG_THRESH_HI,
            bg_thresh_lo=t.BG_THRESH_LO,
            nms_tier=int(cfg.tpu.nms_tier),
        )


class DeviceConstants:
    """The step's constant tensors on one device, made once: anchor grids
    per feature shape and the mean/std/weight vectors, so that no step
    builds a tensor on the host."""

    def __init__(self, s: TrainSettings, device):
        self.s = s
        self.device = torch.device(device)
        self._anchors = {}

        def put(v):
            return torch.tensor(v, dtype=torch.float32).to(self.device)

        a = s.num_anchors
        self.anchor_means, self.anchor_stds = put(s.anchor_means), put(s.anchor_stds)
        self.rpn_means, self.rpn_stds = put(list(s.anchor_means) * a), put(list(s.anchor_stds) * a)
        self.rpn_bbox_weights = put(s.rpn_bbox_weights)
        self.bbox_means, self.bbox_stds = put(s.bbox_means), put(s.bbox_stds)
        self.bbox_weights = put(s.bbox_weights)

    def anchors(self, fh: int, fw: int):
        if (fh, fw) not in self._anchors:
            s = self.s
            self._anchors[fh, fw] = torch.from_numpy(anchor_grid(
                fh, fw, s.feat_stride, s.anchor_ratios, s.anchor_scales)).to(self.device)
        return self._anchors[fh, fw]


def draw_uniforms(s: TrainSettings, batch, generator: torch.Generator, rank: int = 0,
                  world: int = 1) -> dict:
    """The step's uniform draws on the generator's device: rpn_fg, rpn_bg
    (B, H*W*A) for anchor subsampling over the feature map of data's
    bucket (H, W = its size // feat_stride) and, when batch_rois > 0,
    roi_fg, roi_bg, roi_gap (B, post_nms_top_n + max_gt) for roi
    sampling. With `world` ranks, B is a rank's batch: the draws are made
    for the global batch of B * world images and rank `rank` keeps its
    rows, so equal generators give each image the draws of the
    single-process step."""
    b, h, w = batch["data"].shape[:3]
    fh, fw = h // s.feat_stride, w // s.feat_stride
    dev = generator.device

    def u(n):
        return torch.rand((b * world, n), generator=generator, device=dev)[rank * b:(rank + 1) * b]

    out = {"rpn_fg": u(fh * fw * s.num_anchors), "rpn_bg": u(fh * fw * s.num_anchors)}
    if s.batch_rois > 0:
        n = s.post_nms_top_n + batch["gt_boxes"].shape[1]
        out.update(roi_fg=u(n), roi_bg=u(n), roi_gap=u(n))
    return out


def detection_losses(out, batch, consts: DeviceConstants, draws: dict, s: TrainSettings,
                     world: int = 1):
    """Head maps + gt -> (total loss, metric dict), batched over images.
    Over `world` ranks the normalizers count the global batch (the label
    counts summed over the ranks), so each loss and metric is the rank's
    share of the global one."""
    b, fh, fw, _ = out["rpn_cls"].shape
    a = s.num_anchors
    anchors = consts.anchors(fh, fw)

    # RPN targets and losses
    assign = assign_anchors(
        anchors, batch["gt_boxes"], batch["gt_valid"], batch["im_info"],
        draws["rpn_fg"], draws["rpn_bg"], rpn_batch=s.rpn_batch,
        fg_fraction=s.rpn_fg_fraction, pos_thresh=s.rpn_pos_thresh,
        neg_thresh=s.rpn_neg_thresh, clobber_positives=s.rpn_clobber_positives,
        normalize=s.normalize_rpn, means=consts.anchor_means, stds=consts.anchor_stds,
        rpn_bbox_weights=consts.rpn_bbox_weights)
    rpn_labels = assign["label"].reshape(b, fh, fw, a)
    n_rpn = mesh.sum_over_ranks((rpn_labels.long() != -1).sum())
    rpn_cls_loss, rpn_bbox_loss = rpn_losses(
        out["rpn_cls"], out["rpn_bbox"], rpn_labels,
        assign["bbox_target"].reshape(b, fh, fw, a * 4),
        assign["bbox_weight"].reshape(b, fh, fw, a * 4),
        num_anchors=a, rpn_batch=s.rpn_batch, normalized=s.normalize_rpn,
        num_images=b * world, valid_count=n_rpn)

    # proposals and roi targets, without gradient
    with torch.no_grad():
        fg = torch.softmax(rpn_pair(out["rpn_cls"], a), dim=-1)[..., 1]
        deltas = out["rpn_bbox"]
        if s.normalize_rpn:
            deltas = deltas * consts.rpn_stds + consts.rpn_means
        rois, _, _ = rpn_proposals(
            fg, deltas, anchors, batch["im_info"], pre_nms_top_n=s.pre_nms_top_n,
            post_nms_top_n=s.post_nms_top_n, nms_thresh=s.nms_thresh,
            min_size=s.min_size, feat_stride=s.feat_stride, nms_tier=s.nms_tier)
        tgt = proposal_target(
            rois, batch["gt_boxes"], batch["gt_valid"], fg_thresh=s.fg_thresh,
            bbox_means=consts.bbox_means, bbox_stds=consts.bbox_stds,
            bbox_weights=consts.bbox_weights, num_reg_classes=s.num_reg_classes,
            normalization_precomputed=s.bbox_normalization_precomputed)
        if s.batch_rois > 0:
            tgt = sample_rois_fixed(
                tgt, draws["roi_fg"], draws["roi_bg"], draws["roi_gap"],
                batch_rois=s.batch_rois, fg_fraction=s.fg_fraction,
                bg_thresh_hi=s.bg_thresh_hi, bg_thresh_lo=s.bg_thresh_lo)

    # R-FCN scores: position-sensitive pooling, mean over the P x P bins
    scale = 1.0 / s.feat_stride
    cls_scores = psroi_pool(out["rfcn_cls_map"], tgt["rois"], s.num_classes,
                            s.group_size, s.group_size, scale).mean(dim=(2, 3))
    bbox_preds = psroi_pool(out["rfcn_bbox_map"], tgt["rois"], 4 * s.num_reg_classes,
                            s.group_size, s.group_size, scale).mean(dim=(2, 3))

    if s.enable_ohem:
        lab, w = ohem_select(cls_scores.detach(), bbox_preds.detach(), tgt["label"],
                             tgt["bbox_target"], tgt["bbox_weight"], tgt["valid"],
                             roi_per_img=s.ohem_rois)
        norm = s.ohem_rois
    else:
        lab = torch.where(tgt["valid"], tgt["label"], -1.0)
        w = tgt["bbox_weight"]
        norm = max(s.batch_rois, 1)
    n_rcnn = mesh.sum_over_ranks((lab.long() != -1).sum())
    rcnn_cls_loss, rcnn_bbox_loss = rcnn_losses(cls_scores, bbox_preds, lab,
                                                tgt["bbox_target"], w, ohem_count=norm,
                                                num_images=b * world, valid_count=n_rcnn)

    losses = {"rpn_cls_loss": rpn_cls_loss, "rpn_bbox_loss": rpn_bbox_loss,
              "rcnn_cls_loss": rcnn_cls_loss, "rcnn_bbox_loss": rcnn_bbox_loss}
    metrics = {"rpn_acc": rpn_acc(out["rpn_cls"].detach(), rpn_labels, a, n_rpn),
               "rcnn_acc": rcnn_acc(cls_scores.detach(), lab, n_rcnn),
               **{k: v.detach() for k, v in losses.items()}}
    return sum(losses.values()), metrics


def _make_step(model, settings: TrainSettings, optimizer, scheduler, forward):
    """step(batch, draws) around forward(batch) -> the head maps, over the
    ranks of the process group when there is one."""
    consts = DeviceConstants(settings, next(model.parameters()).device)
    world = mesh.world_size()

    def train_step(batch, draws):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        total, metrics = detection_losses(forward(batch), batch, consts, draws, settings, world)
        with full_float32():     # the float32 convs' backward reads the flag when it runs
            total.backward()
        mesh.all_reduce_gradients(model)
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        metrics["total_loss"] = total.detach()
        if mesh.active():        # the ranks' shares -> the global batch's metrics
            summed = mesh.sum_over_ranks(torch.stack(list(metrics.values())))
            metrics = dict(zip(metrics, summed.unbind()))
        return metrics

    return train_step


def make_train_step(model, settings: TrainSettings, optimizer, scheduler=None):
    """Build step(batch, draws) -> metric dict (device scalars) for LSFA:
    `forward_train`, losses, backward, one optimizer step and one
    scheduler step. `batch` holds device tensors
    (``data.loader.batch_to_device``); `draws` comes from `draw_uniforms`
    or a test. The model runs in training mode, so its train-mode
    BatchNorms update their running statistics."""
    return _make_step(model, settings, optimizer, scheduler, lambda b: model.forward_train(
        b["data"], b["data_ref"], b["data_ref_old"], b["eq_flag"], b["eq_flag_old"],
        b["motion_vector"], b["res_diff"]))


def make_rfcn_train_step(model, settings: TrainSettings, optimizer, scheduler=None):
    """The step of `make_train_step` for the single-frame R-FCN: the same
    losses and update on the forward of batch["data"] alone (a train batch's
    reference frames, motion vectors and residuals are not read)."""
    return _make_step(model, settings, optimizer, scheduler, lambda b: model(b["data"]))
