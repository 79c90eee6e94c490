"""FGFA, flow-guided feature aggregation (Zhu et al., ICCV 2017,
arXiv:1703.10025; msracver/Flow-Guided-Feature-Aggregation,
``fgfa_rfcn``), on the R-FCN of ``models.rfcn.RFCNBase``.

Each frame i is detected on the aggregate of the features of its window
of 2K + 1 frames, j = i - K .. i + K:

    f_j         = N_feat(I_j)                   (trunk + dilated 3x3, once a frame)
    f_{j->i}    = W(f_j, F(I_i, I_j)), j != i   (FlowNet-S pair, bilinear warp)
    f_{i->i}    = f_i
    w_{j->i}(p) = softmax over j of cos(e(f_{j->i})(p), e(f_i)(p))
    f_bar_i     = sum_j w_{j->i} f_{j->i}       -> the R-FCN heads

F is FlowNet-S without DFF's scale map; e is the embedding tower of
``models.aggregation.FgfaEmbed``. Which frames fill a window (and how a
video's ends pad it) is the caller's: ``eval.fgfa_tester.FGFADetector``.

`forward_feat` runs the trunk once per new frame; `forward_aggregate`
runs everything after it for a batch of centres, each with its 2K
neighbour slots, laid out slot-major ((2K, B, ...), slot s of centre b
is row s*B + b once flattened), so that FlowNet, the warp and the tower
each run over every pair or feature of the batch in one call. Features
are float32 (as LSFA's carry); convolutions run in the compute dtype.
Public methods take and return NHWC tensors.
"""

from __future__ import annotations

from typing import Sequence

import torch

from lsfa_tpu_torch.config import compute_dtype
from lsfa_tpu_torch.models.aggregation import FgfaEmbed
from lsfa_tpu_torch.models.flownet import FlowNetS
from lsfa_tpu_torch.models.lsfa import resolve_device
from lsfa_tpu_torch.models.rfcn import RFCNBase, nchw, nhwc
from lsfa_tpu_torch.ops.warp import flow_warp
from lsfa_tpu_torch.utils.profiler import count, span


class FGFA(RFCNBase):
    """The ResNet trunk (no DCN) with its 1024-channel feature conv,
    FlowNet-S without the scale map (`flownet`), the embedding tower
    (`fgfa_net`) and the R-FCN heads; `window_k` is K, the window's
    half-width."""

    def __init__(self, num_classes: int = 31, num_reg_classes: int = 2,
                 feat_dim: int = 1024, num_layer: int = 101, num_anchors: int = 9,
                 add_dcn: bool = False, window_k: int = 10,
                 anchor_means: Sequence[float] = (0.0, 0.0, 0.0, 0.0),
                 anchor_stds: Sequence[float] = (0.1, 0.1, 0.4, 0.4),
                 normalize_rpn: bool = True,
                 pixel_means: Sequence[float] = (0.0, 0.0, 0.0),   # BGR order
                 pixel_scale: float = 1.0, dtype=torch.float32, device=None):
        super().__init__(num_classes, num_reg_classes, feat_dim, num_layer, num_anchors,
                         add_dcn, anchor_means, anchor_stds, normalize_rpn, pixel_means,
                         pixel_scale, dtype, device)
        self.window_k = window_k
        kw = dict(dtype=dtype, device=device)
        self.flownet = FlowNetS(feat_dim, scale_map=False, **kw)
        self.fgfa_net = FgfaEmbed(feat_dim, **kw)
        self._build_heads()

    def forward_feat(self, frames):
        """Raw BGR frames (N, H, W, 3), u8 or float -> (the preprocessed
        frames (N, H, W, 3) float32, their features (N, fh, fw, C)
        float32)."""
        count("fgfa.trunk_frames", frames.shape[0])
        with span("model.fgfa.feat"):
            prep = self.preprocess(frames)
            return prep, nhwc(self.conv_feat(nchw(prep)).float())

    def forward_aggregate(self, prep_centre, feat_centre, prep_nbrs, feat_nbrs):
        """B centres: prep_centre (B, H, W, 3) and feat_centre (B, fh, fw,
        C) from `forward_feat`; their S = 2K neighbour slots prep_nbrs (S,
        B, H, W, 3) and feat_nbrs (S, B, fh, fw, C). Returns the detection
        maps of the B aggregated features (``RFCNBase.detection_maps``)."""
        s, b = prep_nbrs.shape[:2]
        count("model.frames.fgfa", b)
        count("fgfa.pairs", s * b)
        d = self.dtype
        with span("model.fgfa.flow"):
            cur = nchw(prep_centre.to(d).repeat(s, 1, 1, 1))
            flow, _ = self.flownet(cur, nchw(prep_nbrs.flatten(0, 1)))
        with span("model.fgfa.warp"):
            warped = flow_warp(feat_nbrs.flatten(0, 1), nhwc(flow))
            feats = nchw(torch.cat([feat_centre, warped], dim=0))
        with span("model.fgfa.embed"):
            emb = self.fgfa_net.embed(feats)
        with span("model.fgfa.weigh"):
            agg = self.fgfa_net.weigh(emb, feats, s + 1)
        return self.detection_maps(agg)


def fgfa_from_config(cfg, device=None) -> FGFA:
    """Build the FGFA of a config tree on `device` (the card when None;
    raises without one unless device="cpu"). K is TEST.KEY_FRAME_INTERVAL,
    as the source's tester reads it (a window of 2K + 1 frames). Weights
    are uninitialized: call ``models.lsfa.init_params`` or load a state
    dict."""
    n = cfg.network
    return FGFA(
        num_classes=cfg.dataset.NUM_CLASSES,
        num_reg_classes=2 if cfg.CLASS_AGNOSTIC else cfg.dataset.NUM_CLASSES,
        feat_dim=n.DFF_FEAT_DIM,
        num_layer=n.num_layer,
        num_anchors=n.NUM_ANCHORS,
        add_dcn=n.add_dcn,
        window_k=cfg.TEST.KEY_FRAME_INTERVAL,
        anchor_means=tuple(n.ANCHOR_MEANS),
        anchor_stds=tuple(n.ANCHOR_STDS),
        normalize_rpn=n.NORMALIZE_RPN,
        pixel_means=tuple(float(m) for m in n.PIXEL_MEANS),
        pixel_scale=float(n.PIXEL_SCALE),
        dtype=compute_dtype(cfg),
        device=resolve_device(device),
    )
