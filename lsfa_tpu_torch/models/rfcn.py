"""The single-frame R-FCN baseline and the detector LSFA is built on.

The counterpart of ``lsfa_tpu.models.rfcn``. `RFCNBase` holds what R-FCN
and LSFA share: the ResNet trunk with the dilated ``feat_conv_3x3``, the
on-device normalization of raw BGR frames, and the RPN and R-FCN heads on
the (rpn_feat, rfcn_feat) channel halves of the feature, with the head
conventions of the JAX package (RPN logits [bg A | fg A] and deltas in
float32, the position-sensitive maps in the compute dtype). `RFCN` runs
every frame through it, with no video machinery.

Public methods take and return NHWC tensors; the modules run NCHW views.
Submodule names equal the flax module names (``backbone``,
``feat_conv_3x3``, ``rpn_cls_score``, ``rpn_bbox_pred``, ``rfcn_cls``,
``rfcn_bbox``), so ``convert.flax_to_torch`` maps either model's flax
variables onto its `state_dict()`.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from lsfa_tpu_torch.models.layers import Conv
from lsfa_tpu_torch.models.resnet import ResNetBackbone


def nchw(x):
    return x.permute(0, 3, 1, 2)


def nhwc(x):
    return x.permute(0, 2, 3, 1)


class RFCNBase(nn.Module):
    """Trunk, normalization and heads. A subclass's __init__ calls this
    one, which builds the trunk, then adds its own modules, then calls
    `_build_heads`: the order of registration fixes the order of
    `state_dict()` and of ``init_params``' draws."""

    def __init__(self, num_classes: int, num_reg_classes: int, feat_dim: int, num_layer: int,
                 num_anchors: int, add_dcn: bool, anchor_means: Sequence[float],
                 anchor_stds: Sequence[float], normalize_rpn: bool,
                 pixel_means: Sequence[float], pixel_scale: float, dtype, device):
        super().__init__()
        self.num_classes = num_classes
        self.num_reg_classes = num_reg_classes
        self.feat_dim = feat_dim
        self.num_anchors = num_anchors
        self.normalize_rpn = normalize_rpn
        self.pixel_scale = pixel_scale
        self.dtype = dtype
        self._device = device
        kw = dict(dtype=dtype, device=device)
        dcn_u = (0, 1, 1, 3) if add_dcn else (0, 0, 0, 0)
        dcn_g = (0, 4, 4, 4) if add_dcn else (0, 0, 0, 0)
        self.backbone = ResNetBackbone(num_layer, 16, dcn_u, dcn_g, **kw)
        self.feat_conv_3x3 = Conv(self.backbone.out_channels[-1], feat_dim, 3, dilate=6,
                                  init="normal01", **kw)
        f32 = torch.float32
        self.register_buffer("pixel_means_rgb", torch.tensor(
            list(pixel_means)[::-1], dtype=f32, device=device), persistent=False)
        self.register_buffer("rpn_stds", torch.tensor(
            list(anchor_stds) * num_anchors, dtype=f32, device=device), persistent=False)
        self.register_buffer("rpn_means", torch.tensor(
            list(anchor_means) * num_anchors, dtype=f32, device=device), persistent=False)

    def _build_heads(self):
        half, a, g = self.feat_dim // 2, self.num_anchors, 7
        head = dict(init="normal01", dtype=self.dtype, device=self._device)
        self.rpn_cls_score = Conv(half, 2 * a, 1, **head)
        self.rpn_bbox_pred = Conv(half, 4 * a, 1, **head)
        self.rfcn_cls = Conv(half, self.num_classes * g * g, 1, **head)
        self.rfcn_bbox = Conv(half, 4 * self.num_reg_classes * g * g, 1, **head)

    def preprocess(self, img):
        """Raw resized BGR frame (B, H, W, 3), u8 or float -> normalized
        RGB float32."""
        x = torch.flip(img.float(), dims=[-1])
        return (x - self.pixel_means_rgb) * self.pixel_scale

    def conv_feat(self, ims):
        """Backbone + dilated 3x3 -> the feature (NCHW)."""
        return torch.relu(self.feat_conv_3x3(self.backbone(ims)[-1]))

    def rpn_fg_probs(self, cls_logits):
        """Per-anchor fg probability from NHWC [bg A | fg A] logits."""
        a = self.num_anchors
        pair = torch.stack([cls_logits[..., :a], cls_logits[..., a:]], dim=-1)
        return torch.softmax(pair, dim=-1)[..., 1]

    def rpn_decode_deltas(self, deltas):
        """Un-normalize NHWC RPN deltas."""
        if not self.normalize_rpn:
            return deltas
        return deltas * self.rpn_stds + self.rpn_means

    def head_maps(self, feat):
        """NCHW feature -> NHWC raw RPN logits and deltas (float32) and the
        R-FCN maps (compute dtype)."""
        half = self.feat_dim // 2
        rpn_feat, rfcn_feat = feat[:, :half], feat[:, half:]
        return {
            "rpn_cls": nhwc(self.rpn_cls_score(rpn_feat).float()),
            "rpn_bbox": nhwc(self.rpn_bbox_pred(rpn_feat).float()),
            "rfcn_cls_map": nhwc(self.rfcn_cls(rfcn_feat)),
            "rfcn_bbox_map": nhwc(self.rfcn_bbox(rfcn_feat)),
        }

    def detection_maps(self, feat):
        """NCHW feature -> the inference output dict (NHWC): the feature,
        fg probabilities, decoded deltas and the R-FCN maps."""
        maps = self.head_maps(feat)
        return {"feat": nhwc(feat), "rpn_fg": self.rpn_fg_probs(maps.pop("rpn_cls")),
                "rpn_deltas": self.rpn_decode_deltas(maps.pop("rpn_bbox")), **maps}


class RFCN(RFCNBase):
    """R-FCN on single frames: ResNet (DCN only when add_dcn), the dilated
    3x3, the RPN and the position-sensitive heads."""

    def __init__(self, num_classes: int = 31, num_reg_classes: int = 2,
                 feat_dim: int = 1024, num_layer: int = 101, num_anchors: int = 9,
                 add_dcn: bool = False,
                 anchor_means: Sequence[float] = (0.0, 0.0, 0.0, 0.0),
                 anchor_stds: Sequence[float] = (0.1, 0.1, 0.4, 0.4),
                 normalize_rpn: bool = True,
                 pixel_means: Sequence[float] = (0.0, 0.0, 0.0),   # BGR order
                 pixel_scale: float = 1.0, dtype=torch.float32, device=None):
        super().__init__(num_classes, num_reg_classes, feat_dim, num_layer, num_anchors,
                         add_dcn, anchor_means, anchor_stds, normalize_rpn, pixel_means,
                         pixel_scale, dtype, device)
        self._build_heads()

    def forward(self, data):
        """data: raw resized BGR frames (B, H, W, 3), u8 or float. Returns
        the NHWC feature (compute dtype), raw RPN logits and deltas
        (rpn_cls, rpn_bbox), fg probabilities and decoded deltas (rpn_fg,
        rpn_deltas), all float32, and the R-FCN maps."""
        feat = self.conv_feat(nchw(self.preprocess(data)))
        out = {"feat": nhwc(feat), **self.head_maps(feat)}
        out.update(rpn_fg=self.rpn_fg_probs(out["rpn_cls"]),
                   rpn_deltas=self.rpn_decode_deltas(out["rpn_bbox"]))
        return out
