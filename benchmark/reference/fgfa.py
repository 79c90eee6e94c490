"""Plain float32 reference of FGFA, flow-guided feature aggregation (Zhu et
al., ICCV 2017, arXiv:1703.10025; msracver/Flow-Guided-Feature-Aggregation,
``experiments/fgfa_rfcn``), built from ``reference/model.py``'s blocks
with no import of the program.

One frame i is worked out from the frames of its window j = i - K .. i +
K, as the caller clamps them to the video:

    f_j         = relu(feat_conv_3x3(ResNet(I_j)))      (no DCN, stride 16)
    f_{j->i}    = flow_warp(f_j, FlowNetS(I_i, I_j)), j != i;  f_{i->i} = f_i
    e_{j->i}    = em_conv3(relu(em_conv2(relu(em_conv1(f_{j->i})))))
    w_{j->i}(p) = softmax over j of cos(e_{j->i}(p), e_{i->i}(p))
    f_bar_i     = sum_j w_{j->i}(p) f_{j->i}(p)         -> the R-FCN heads

This is the paper's equation: the tower embeds each of the 2K + 1
warped features of every centre. The source's test symbols
(``get_feat_symbol``, ``get_aggregation_symbol``) are written
otherwise: each frame is embedded once, [feature, embedding] (3072
channels) is cached and warped as one, and FlowNet runs on all 2K + 1
pairs, the centre with itself. At K = 10 and 608x1024 this form counts
1248.1 GFLOP a frame (trunk 27.1%, 20 FlowNet pairs 40.3%, 21
embeddings 32.2%, heads 0.4%); the source's would count about 890.8
(trunk 37.9%, 21 pairs 59.4%, one embedding 2.1%, heads 0.5%), and its
warp would move 3072 channels where this one moves 1024.

Other departures from the paper and the source, each the program's as
well: FlowNet-S without DFF's scale map (the source's FGFA warps
unscaled, so the module has no ``scale_map`` conv); a window slot outside
the video takes its end frame and is still warped by FlowNet against it
(the source's tester pads so); the cosine is over l2 norms with 1e-10
inside the square root, as the source's L2Normalization; the heads are
the class-agnostic R-FCN's of ``rfcn_r101``.

Submodule and parameter names equal the program's (``models/fgfa.py``),
so one state dict from ``benchmark.weights`` loads into both.
"""

from __future__ import annotations

import torch
from torch import nn

from benchmark.reference import model as ref


class _NoScaleMap(nn.Module):
    """FGFA's FlowNet has no scale map: FlowNetS's call of it gives None."""

    def forward(self, x):
        return None


class Embed(nn.Module):
    """FGFA's embedding tower: 1x1/512, ReLU, 3x3/512, ReLU, 1x1/2048."""

    def __init__(self, feat_dim, prec, device=None):
        super().__init__()
        kw = dict(prec=prec, device=device)
        self.em_conv1 = ref.Conv(feat_dim, 512, 1, **kw)
        self.em_conv2 = ref.Conv(512, 512, 3, **kw)
        self.em_conv3 = ref.Conv(512, 2048, 1, **kw)

    def forward(self, x):
        return self.em_conv3(torch.relu(self.em_conv2(torch.relu(self.em_conv1(x)))))


class FGFA(ref.RFCNBase):
    """The ResNet trunk without DCN, FlowNet-S without the scale map
    (`flownet`), the embedding tower (`fgfa_net`) and the R-FCN heads."""

    def __init__(self, num_classes=31, feat_dim=1024, num_layer=101, num_anchors=9,
                 add_dcn=False, anchor_stds=(0.1, 0.1, 0.4, 0.4), prec=None, device=None):
        prec = prec or ref.Precision()
        super().__init__(num_classes, feat_dim, num_layer, num_anchors, add_dcn, anchor_stds,
                         prec, device)
        self.flownet = ref.FlowNetS(feat_dim, prec, device)
        del self.flownet.scale_map
        self.flownet.scale_map = _NoScaleMap()
        self.fgfa_net = Embed(feat_dim, prec, device)
        self._build_heads()

    def forward_feat(self, frames):
        """Raw BGR frames (N, H, W, 3) -> (preprocessed NCHW, features NCHW).
        The frames are made contiguous NCHW: on an H100 cuDNN runs this
        trunk's float32 convolutions 13x slower on channels-last views."""
        x = ref.nchw(self.preprocess(frames)).contiguous()
        return x, self.conv_feat(x)

    def aggregate(self, x_centre, f_centre, x_nbrs, f_nbrs):
        """One centre's preprocessed frame and feature (1, ...) and its S
        neighbours' (S, ...), NCHW -> its aggregated feature (1, C, h, w)."""
        s = x_nbrs.shape[0]
        flow, _ = self.flownet(x_centre.expand(s, -1, -1, -1), x_nbrs)
        feats = torch.cat([f_centre, ref.flow_warp(f_nbrs, flow)])
        e = self.fgfa_net(feats)
        e = e / torch.sqrt((e * e).sum(dim=1, keepdim=True) + 1e-10)
        w = torch.softmax((e * e[:1]).sum(dim=1, keepdim=True), dim=0)
        return (w * feats).sum(dim=0, keepdim=True)

    def forward(self, frames, slots):
        """frames (U, H, W, 3): the distinct raw frames of one window;
        slots: the window's 2K + 1 indices into them, the centre in the
        middle. Returns the centre's detection maps."""
        x, f = self.forward_feat(frames)
        k = len(slots) // 2
        nbrs = torch.tensor(slots[:k] + slots[k + 1:], device=x.device)
        c = slots[k]
        return self.detection_maps(self.aggregate(x[c:c + 1], f[c:c + 1], x[nbrs], f[nbrs]))
