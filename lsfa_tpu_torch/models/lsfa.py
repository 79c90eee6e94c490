"""The LSFA model: R-FCN detection over long/short-term aggregated features.

The counterpart of ``lsfa_tpu.models.lsfa``: the key-frame graph
(`forward_key`: backbone, dilated 3x3, FlowNet warp of the cached key
feature and Nq-net or FGFA fusion), the non-key graph (`forward_cur`:
motion-vector warp, R-net residual fused by add or concat, the F-net,
small-net fusion), the training graph (`forward_train`: both, with
ChooseFeat selects) and the batched-GOP graph (`forward_batch_gop`: one
key frame and N-1 frames FlowNet-warped from it), each followed by the
RPN and R-FCN heads of ``models.rfcn.RFCNBase``, which also holds the
trunk (ResNet, MobileNetV2 or Hobot MobileNetV2). The 1024-ch feature
splits along channels into (rpn_feat, rfcn_feat) halves.

The public methods take and return NHWC tensors with the JAX package's
channel orders (RPN logits [bg A | fg A], flow (dx, dy)); inside, the
modules run NCHW views of them, which for NHWC-contiguous inputs are
channels_last tensors. Submodule names equal the flax module names, so
``convert.flax_to_torch`` maps a flax variable tree onto `state_dict()`.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from lsfa_tpu_torch.config import compute_dtype
from lsfa_tpu_torch.models.aggregation import FgfaEmbed, FNet, NqNet, RNet, SmallNetFuse
from lsfa_tpu_torch.models.flownet import FlowNetS
from lsfa_tpu_torch.models.layers import Conv, Deconv2x, FrozenBN
from lsfa_tpu_torch.models.resnet import DeformConv2d, ResNetBackbone
from lsfa_tpu_torch.models.rfcn import RFCNBase, nchw as _nchw, nhwc as _nhwc
from lsfa_tpu_torch.ops.warp import flow_warp
from lsfa_tpu_torch.utils.profiler import count, span


def _warp(feat, flow):
    """flow_warp on NCHW tensors."""
    return _nchw(flow_warp(_nhwc(feat), _nhwc(flow)))


class LSFA(RFCNBase):
    def __init__(self, num_classes: int = 31, num_reg_classes: int = 2,
                 feat_dim: int = 1024, num_layer: int = 101, nettype: str = "resnet",
                 num_anchors: int = 9, add_dcn: bool = True, rnet_num_conv: int = 0,
                 fnet_type: str = "None", fuse_type: str = "add",
                 res_diff_bn: bool = False, add_small_net: bool = True,
                 small_net_stride: int = 4, small_net_fuse_type: str = "add",
                 small_net_bn_before_fuse: bool = False,
                 small_net_scale_before_fuse: bool = False, add_Nq_net: bool = True,
                 add_Fgfa_net: bool = False, add_rnet: bool = True,
                 add_lt_aggregation: bool = True,
                 anchor_means: Sequence[float] = (0.0, 0.0, 0.0, 0.0),
                 anchor_stds: Sequence[float] = (0.1, 0.1, 0.4, 0.4),
                 normalize_rpn: bool = True,
                 pixel_means: Sequence[float] = (0.0, 0.0, 0.0),   # BGR order
                 pixel_scale: float = 1.0, dtype=torch.float32, device=None):
        if nettype in ("mobilenet", "mobilenet_hobot") and add_small_net:
            # the MobileNet trunks expose no per-stage feature to copy
            raise ValueError("add_small_net requires nettype='resnet' (the MobileNet trunks "
                             "have no small-net stages)")
        super().__init__(num_classes, num_reg_classes, feat_dim, num_layer, num_anchors,
                         add_dcn, anchor_means, anchor_stds, normalize_rpn, pixel_means,
                         pixel_scale, dtype, device, nettype=nettype)
        self.add_small_net = add_small_net
        self.small_net_stride = small_net_stride
        self.add_rnet = add_rnet
        self.add_lt_aggregation = add_lt_aggregation
        self.fuse_type = fuse_type
        if fuse_type not in ("add", "concat"):
            raise ValueError(f"unknown fuse_type: {fuse_type}")
        kw = dict(dtype=dtype, device=device)

        # the long-term aggregator: the Nq-net before FGFA; neither averages
        self.aggregator = None
        if add_lt_aggregation:
            self.flownet = FlowNetS(feat_dim, **kw)
            if add_Nq_net:
                self.nq_net = NqNet(feat_dim, **kw)
                self.aggregator = "nq_net"
            elif add_Fgfa_net:
                self.fgfa_net = FgfaEmbed(feat_dim, **kw)
                self.aggregator = "fgfa_net"
        if add_rnet:
            self.rnet = RNet(rnet_num_conv, feat_dim, res_diff_bn, **kw)
        # the JAX package runs the F-net only for 'conv#N' types, so only
        # those have weights
        self.fnet = FNet(fnet_type, feat_dim, **kw) if "conv" in fnet_type else None
        if add_small_net:
            stages = 1 if small_net_stride == 4 else 2
            self.small_net_backbone = ResNetBackbone(num_layer, 16, num_stages=stages, **kw)
            self.small_fuse = SmallNetFuse(
                self.small_net_backbone.out_channels[-1], small_net_stride,
                small_net_bn_before_fuse, small_net_scale_before_fuse, feat_dim, **kw,
                fuse_type=small_net_fuse_type)
        if fuse_type == "concat" and add_rnet:
            self.fuse_downsample = Conv(2 * feat_dim, feat_dim, 1, init="normal01", **kw)
        self._build_heads()

    # ------- building blocks -------

    def preprocess(self, img):
        """Raw resized frame -> normalized RGB float32 (B, H, W, 3).

        (B, H, W, 3) packed BGR u8/float, or (B, H*3/2, W, 1) planar I420
        u8 converted with BT.601 limited range and nearest chroma
        upsampling (the data plane's Y=16, U=V=128 pad converts to zero)."""
        if img.shape[-1] == 1:
            return self._preprocess_i420(img[..., 0])
        return super().preprocess(img)

    def _preprocess_i420(self, packed):
        h = packed.shape[-2] * 2 // 3
        w = packed.shape[-1]
        lead = tuple(packed.shape[:-2])
        y = packed[..., :h, :].float()
        u = packed[..., h:h + h // 4, :].reshape(lead + (h // 2, w // 2))
        v = packed[..., h + h // 4:, :].reshape(lead + (h // 2, w // 2))
        uv = torch.stack([u, v], dim=-1).float() - 128.0
        uv = uv.repeat_interleave(2, dim=-3).repeat_interleave(2, dim=-2)
        yf = (y - 16.0) * 1.164384
        cb, cr = uv[..., 0], uv[..., 1]
        r = yf + 1.596027 * cr
        g = yf - 0.391762 * cb - 0.812968 * cr
        b = yf + 2.017232 * cb
        rgb = torch.stack([r, g, b], dim=-1).clamp(0.0, 255.0)
        return (rgb - self.pixel_means_rgb) * self.pixel_scale

    def long_term_aggregate(self, fresh_feat, old_feat, img_cur, img_old):
        """FlowNet warp of the previous key feature, fused with the fresh
        one by the Nq-net (or averaged). NCHW."""
        if not self.add_lt_aggregation:
            return fresh_feat
        with span("model.long_term"):
            flow, scale_map = self.flownet(img_cur, img_old)
            warped = _warp(old_feat, flow) * scale_map
            if self.aggregator is not None:
                return getattr(self, self.aggregator)(warped, fresh_feat)
            return 0.5 * (warped + fresh_feat)

    def short_term_propagate(self, key_feat, motion_vector, res_diff, small_img):
        """MV warp + R-net residual (added, or concatenated [warped,
        residual] and reduced by fuse_downsample) + the F-net + small-net
        fusion. NCHW; small_img is the preprocessed, already downscaled
        frame."""
        with span("model.mv_warp"):
            fused = _warp(key_feat, motion_vector)
        if self.add_rnet:
            with span("model.rnet"):
                r = self.rnet(res_diff)
                if self.fuse_type == "add":
                    fused = fused + r
                else:
                    fused = self.fuse_downsample(torch.cat([fused, r], dim=1))
        if self.fnet is not None:
            fused = self.fnet(fused)
        if self.add_small_net:
            with span("model.small_net"):
                parts = self.small_net_backbone(small_img)
                small_feat = parts[0] if self.small_net_stride == 4 else parts[1]
                fused = self.small_fuse(fused, small_feat)
        return fused

    # ------- phase graphs -------

    def forward_key(self, data, data_key_old, feat_key_old, is_first):
        """Key-frame inference. data: raw frame (BGR or I420); data_key_old:
        the cached preprocessed previous key frame (B, H, W, 3) float32;
        feat_key_old: (B, fh, fw, feat_dim) float32; is_first (B,): where
        > 0 the fresh feature replaces the cached one (stream start)."""
        count("model.frames.key", data.shape[0])
        with span("model.forward_key"):
            data = self.preprocess(data)
            b = data.shape[0]
            x = _nchw(data)
            fresh = self.conv_feat(x)
            first = (is_first > 0).reshape(b, 1, 1, 1)
            old = torch.where(first, fresh, _nchw(feat_key_old))
            prop = self.long_term_aggregate(fresh, old, x, _nchw(data_key_old))
            # the key-feature carry is float32 by design
            feat = torch.where(first, fresh, prop).float()
            out = self.detection_maps(feat)
            out["prep"] = data
            return out

    def forward_cur(self, small_img, feat_key, motion_vector, res_diff):
        """Non-key inference: small_img is the raw 1/small_net_stride frame;
        feat_key (B, fh, fw, feat_dim); motion_vector (B, fh, fw, 2) as
        (dx, dy); res_diff (B, fh, fw, 3)."""
        count("model.frames.cur", small_img.shape[0])
        with span("model.forward_cur"):
            feat = self.short_term_propagate(
                _nchw(feat_key), _nchw(motion_vector), _nchw(res_diff),
                _nchw(self.preprocess(small_img)))
            return self.detection_maps(feat)

    def forward_train(self, data, data_ref, data_ref_old, eq_flag, eq_flag_old,
                      motion_vector, res_diff):
        """Training forward to the head maps. data, data_ref, data_ref_old:
        raw BGR frames (B, H, W, 3); eq_flag (B,) > 0 where the current
        frame is the key frame, eq_flag_old (B,) > 0 where the old
        reference is the reference; motion_vector (B, fh, fw, 2) (dx, dy);
        res_diff (B, fh, fw, 3).

        Returns NHWC rpn_cls [bg A | fg A] logits and rpn_bbox deltas as
        raw float32 head outputs, the R-FCN maps in the compute dtype, and
        the key and selected features. In training mode the R-net's and the
        fusion's BatchNorms (res_diff_bn, small_net_bn_before_fuse)
        normalize with batch statistics and update their running ones."""
        b = data.shape[0]
        x_cur = _nchw(self.preprocess(data))
        x_ref = _nchw(self.preprocess(data_ref))
        if not self.add_lt_aggregation:
            key_feat = self.conv_feat(x_ref)
        else:
            x_old = _nchw(self.preprocess(data_ref_old))
            feats = self.conv_feat(torch.cat([x_ref, x_old], dim=0))
            feat_ref, feat_old = feats[:b], feats[b:]
            prop = self.long_term_aggregate(feat_ref, feat_old, x_ref, x_old)
            # ChooseFeat: the fresh feature when cur == key or old == ref
            use_fresh = ((eq_flag > 0) | (eq_flag_old > 0)).reshape(b, 1, 1, 1)
            key_feat = torch.where(use_fresh, feat_ref, prop)
        small = self.small_fuse.downscale(x_cur) if self.add_small_net else None
        cur_feat = self.short_term_propagate(key_feat, _nchw(motion_vector),
                                             _nchw(res_diff), small)
        # key frames train the key path directly
        sel = torch.where((eq_flag > 0).reshape(b, 1, 1, 1), key_feat, cur_feat)
        return {**self.head_maps(sel), "key_feat": _nhwc(key_feat), "sel_feat": _nhwc(sel)}

    def forward_batch_gop(self, data_key, data_other):
        """Batched-GOP inference, DFF-style: data_key (1, H, W, 3) and
        data_other (N-1, H, W, 3), raw resized BGR. The key frame's fresh
        feature is FlowNet-warped to each other frame (flow of (other,
        key)) and scaled by the scale map; returns the inference output
        dict of the N frames, the key frame first."""
        x_key = _nchw(self.preprocess(data_key))
        x_other = _nchw(self.preprocess(data_other))
        feat_key = self.conv_feat(x_key)
        n = x_other.shape[0]
        flow, scale_map = self.flownet(x_other, x_key.expand(n, -1, -1, -1))
        feat_other = _warp(feat_key.expand(n, -1, -1, -1), flow) * scale_map
        return self.detection_maps(torch.cat([feat_key, feat_other], dim=0))


def resolve_device(device=None) -> torch.device:
    """`device`, or the card when it is None. Without a card None raises:
    the CPU is used only when the caller asks for it."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is available: pass device='cpu' to build on the CPU")
    return torch.device("cuda")


def lsfa_from_config(cfg, device=None) -> LSFA:
    """Build an LSFA module from a config tree on `device` (the card when
    None; see `resolve_device`). Weights are uninitialized: call
    `init_params` or load a converted state dict."""
    device = resolve_device(device)
    n = cfg.network
    return LSFA(
        num_classes=cfg.dataset.NUM_CLASSES,
        num_reg_classes=2 if cfg.CLASS_AGNOSTIC else cfg.dataset.NUM_CLASSES,
        feat_dim=n.DFF_FEAT_DIM,
        num_layer=n.num_layer,
        nettype=str(n.nettype),
        num_anchors=n.NUM_ANCHORS,
        add_dcn=n.add_dcn,
        rnet_num_conv=n.rnet_num_conv,
        fnet_type=str(n.fnet_type),
        fuse_type=n.fuse_type,
        res_diff_bn=n.res_diff_bn,
        add_small_net=n.add_small_net,
        small_net_stride=n.small_net_stride,
        small_net_fuse_type=n.small_net_fuse_type,
        small_net_bn_before_fuse=n.small_net_bn_before_fuse,
        small_net_scale_before_fuse=n.small_net_scale_before_fuse,
        add_Nq_net=n.add_Nq_net,
        add_Fgfa_net=n.add_Fgfa_net,
        add_rnet=bool(n.add_rnet),
        add_lt_aggregation=bool(n.add_lt_aggregation),
        anchor_means=tuple(n.ANCHOR_MEANS),
        anchor_stds=tuple(n.ANCHOR_STDS),
        normalize_rpn=n.NORMALIZE_RPN,
        pixel_means=tuple(float(m) for m in n.PIXEL_MEANS),
        pixel_scale=float(n.PIXEL_SCALE),
        dtype=compute_dtype(cfg),
        device=device,
    )


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Draw weights as the flax initializers do: lecun-normal convs
    (truncated normal, fan-in; a grouped conv's fan-in is its group's),
    he-normal DCN kernels, MSRA (untruncated) FGFA embeddings, N(0, 0.01) heads,
    zero offset convs, scale map 0/1, zero biases, and BN scale 1, bias 0,
    mean 0, var 1. Draws on the generator's device."""

    def fan_in_normal(w, scale, fan_in):
        # flax variance_scaling(truncated_normal): std corrected for the
        # truncation at two standard deviations
        std = math.sqrt(scale / fan_in) / 0.87962566103423978
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)

    for m in model.modules():
        if isinstance(m, (Conv, Deconv2x)):
            w = m.weight
            fan_in = (w.shape[0] if isinstance(m, Deconv2x) else w.shape[1]) * w[0, 0].numel()
            if m.init == "lecun":
                fan_in_normal(w, 1.0, fan_in)
            elif m.init == "he":
                fan_in_normal(w, 2.0, fan_in)
            elif m.init == "msra":
                nn.init.normal_(w, 0.0, math.sqrt(2.0 / fan_in), generator=generator)
            elif m.init == "normal01":
                nn.init.normal_(w, 0.0, 0.01, generator=generator)
            elif m.init in ("zeros", "scale_map"):
                w.zero_()
            else:
                raise ValueError(f"unknown init {m.init!r}")
            if m.bias is not None:
                m.bias.fill_(1.0 if m.init == "scale_map" else 0.0)
        elif isinstance(m, DeformConv2d):
            fan_in_normal(m.weight, 2.0, m.weight[0].numel())
        elif isinstance(m, FrozenBN):            # the train-mode BatchNorm too
            if m.weight is not None:
                m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
