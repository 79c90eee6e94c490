"""LSFA aggregation modules (NCHW), the counterparts of
``lsfa_tpu.models.aggregation``: the R-net residual adapter, the F-net
after the short-term fuse ('conv#N' or the 'res' bottleneck; any other
type the identity), the long-term aggregators (the Nq-net's
quality weights and the FGFA cosine-similarity embedding), and the
short-term small-net fusion in its five modes. The optional BatchNorms
(the R-net's `bn`, the fusion's `cur_feat_bn` and `warp_conv_feat_bn`)
train with batch statistics in training mode and use their running
statistics in eval mode, as in the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn

from lsfa_tpu_torch.models.layers import BatchNorm, Conv, avg_pool, global_avg_pool


class RNet(nn.Module):
    """Residual-adaptation net: optional BN, N x (3x3/256 relu), 1x1 to
    feat_dim."""

    def __init__(self, num_conv: int = 0, feat_dim: int = 1024, use_bn: bool = False,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.num_conv = num_conv
        kw = dict(dtype=dtype, init="normal01", device=device)
        self.bn = BatchNorm(3, dtype=dtype, device=device) if use_bn else None
        cin = 3
        for i in range(num_conv):
            self.add_module(f"conv{i}", Conv(cin, 256, 3, **kw))
            cin = 256
        self.add_module(f"conv{num_conv}", Conv(cin, feat_dim, 1, **kw))

    def forward(self, res_diff):
        x = res_diff.to(self.dtype)
        if self.bn is not None:
            x = self.bn(x)
        for i in range(self.num_conv):
            x = torch.relu(getattr(self, f"conv{i}")(x))
        return getattr(self, f"conv{self.num_conv}")(x)


class FNet(nn.Module):
    """Fused-feature adaptation: 'conv#N' is N x (3x3 feat_dim, relu);
    'res' a 1x1/256, 3x3/256, 1x1/feat_dim bottleneck (relu after each)
    added to its input; any other type the identity."""

    def __init__(self, fnet_type: str = "None", feat_dim: int = 1024, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.fnet_type = fnet_type
        kw = dict(dtype=dtype, init="normal01", device=device)
        if "conv" in fnet_type:
            self.num_conv = int(fnet_type.split("#")[1])
            for i in range(self.num_conv):
                self.add_module(f"conv{i}", Conv(feat_dim, feat_dim, 3, **kw))
        elif "res" in fnet_type:
            self.conv0 = Conv(feat_dim, 256, 1, **kw)
            self.conv1 = Conv(256, 256, 3, **kw)
            self.conv2 = Conv(256, feat_dim, 1, **kw)

    def forward(self, x):
        if "conv" in self.fnet_type:
            for i in range(self.num_conv):
                x = torch.relu(getattr(self, f"conv{i}")(x))
            return x
        if "res" in self.fnet_type:
            h = torch.relu(self.conv0(x))
            h = torch.relu(self.conv1(h))
            return torch.relu(self.conv2(h)) + x
        return x


class NqNet(nn.Module):
    """Per-pixel 2-way softmax weights over (warped, fresh) from a shared
    conv tower; the softmax is float32."""

    def __init__(self, feat_dim: int = 1024, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype, init="normal01", device=device)
        self.conv1 = Conv(feat_dim, 256, 3, **kw)
        self.conv2 = Conv(256, 16, 1, **kw)
        self.conv3 = Conv(16, 1, 1, **kw)

    def forward(self, warp_feat, conv_feat):
        b = warp_feat.shape[0]
        both = torch.cat([warp_feat.to(self.dtype), conv_feat.to(self.dtype)], dim=0)
        h = torch.relu(self.conv1(both))
        h = torch.relu(self.conv2(h))
        logits = self.conv3(h).float()                    # (2B, 1, H, W)
        wgt = torch.softmax(torch.stack([logits[:b], logits[b:]], dim=0), dim=0)
        return wgt[0] * warp_feat + wgt[1] * conv_feat


class FgfaEmbed(nn.Module):
    """FGFA aggregation: a shared embedding tower (1x1/512, 3x3/512,
    1x1/2048, MSRA init) over N features of each frame, the first the
    frame's own; per pixel the cosine similarity of each embedding to the
    own one (l2 norms with 1e-10 inside the sqrt), a float32 softmax over
    the N, and the weighted sum of the N features. `forward` is the
    two-way case (warped, fresh) of LSFA's key step; `aggregate` takes any
    N, laid out slot-major (slot j of frame b is row j*B + b, as
    ``torch.cat`` of the slots gives), and `embed` and `weigh` are its two
    halves."""

    def __init__(self, feat_dim: int = 1024, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype, init="msra", device=device)
        self.em_conv1 = Conv(feat_dim, 512, 1, **kw)
        self.em_conv2 = Conv(512, 512, 3, **kw)
        self.em_conv3 = Conv(512, 2048, 1, **kw)

    def embed(self, feats):
        """(M, C, H, W) features -> their (M, 2048, H, W) embeddings in the
        compute dtype."""
        e = torch.relu(self.em_conv1(feats.to(self.dtype)))
        e = torch.relu(self.em_conv2(e))
        return self.em_conv3(e)

    @staticmethod
    def weigh(emb, feats, n: int):
        """Slot-major embeddings (N*B, E, H, W) and features (N*B, C, H, W),
        slot 0 each frame's own -> the (B, C, H, W) float32 weighted sum."""
        def l2n(v):
            return v / torch.sqrt((v * v).sum(dim=1, keepdim=True) + 1e-10)

        e = l2n(emb.float()).unflatten(0, (n, -1))
        cos = (e * e[0]).sum(dim=2, keepdim=True)          # (N, B, 1, H, W)
        wgt = torch.softmax(cos, dim=0)
        f = feats.unflatten(0, (n, -1))
        out = wgt[0] * f[0]
        for j in range(1, n):
            out = out + wgt[j] * f[j]
        return out

    def aggregate(self, feats, n: int):
        """N features of each of B frames, slot-major (N*B, C, H, W) with
        slot 0 the frame's own -> their (B, C, H, W) float32 aggregate."""
        return self.weigh(self.embed(feats), feats, n)

    def forward(self, warp_feat, conv_feat):
        return self.aggregate(torch.cat([conv_feat, warp_feat], dim=0), 2)


FUSE_TYPES = ("add", "addv2", "concat", "concatv1", "concatv2")


class SmallNetFuse(nn.Module):
    """Short-term fusion of the small net's feature (in_channels, after
    the optional 1x1 cur_scale) into the propagated feature:

      add      — 3x3 to feat_dim, added (BNs on both before, optionally);
      addv2    — 3x3 to in_channels + relu, 1x1 to feat_dim, added
                 (optional BNs as add);
      concat   — 3x3/512 of each, concatenated [warped, cur], 3x3 to
                 feat_dim;
      concatv1 — concat with a relu, then scaled by a squeeze-excite gate
                 of its global mean: cat * s + cat;
      concatv2 — 3x3 of cur to feat_dim, a gate from the global mean of
                 [warped, cur]: cur * s + warped.

    The small backbone itself belongs to the caller."""

    def __init__(self, in_channels: int, stride: int = 4, bn_before_fuse: bool = False,
                 scale_before_fuse: bool = False, feat_dim: int = 1024,
                 dtype=torch.float32, device=None, fuse_type: str = "add"):
        super().__init__()
        if fuse_type not in FUSE_TYPES:
            raise ValueError(f"unknown small_net_fuse_type: {fuse_type}")
        self.dtype = dtype
        self.stride = stride
        self.fuse_type = fuse_type
        nf = in_channels
        kw = dict(dtype=dtype, init="normal01", device=device)
        self.cur_scale = Conv(nf, nf, 1, **kw) if scale_before_fuse else None
        if fuse_type == "add":
            self.fuse_reduce_add = Conv(nf, feat_dim, 3, **kw)
        elif fuse_type == "addv2":
            self.fuse_reduce_add_conv1 = Conv(nf, nf, 3, **kw)
            self.fuse_reduce_add_conv2 = Conv(nf, feat_dim, 1, **kw)
        elif fuse_type == "concatv2":
            self.fuse_reduce_c1 = Conv(nf, feat_dim, 3, **kw)
        else:
            self.fuse_reduce_c1 = Conv(nf, 512, 3, **kw)
            self.fuse_reduce_c2 = Conv(feat_dim, 512, 3, **kw)
            self.fuse_reduce = Conv(1024, feat_dim, 3, **kw)
        if fuse_type in ("concatv1", "concatv2"):
            gate_in = 2 * feat_dim if fuse_type == "concatv2" else feat_dim
            self.s_feat_conv1 = Conv(gate_in, feat_dim, 1, **kw)
            self.s_feat_conv2 = Conv(feat_dim, feat_dim, 1, **kw)
        if bn_before_fuse and fuse_type in ("add", "addv2"):
            self.cur_feat_bn = BatchNorm(feat_dim, dtype=dtype, device=device)
            self.warp_conv_feat_bn = BatchNorm(feat_dim, dtype=dtype, device=device)
        else:
            self.cur_feat_bn = self.warp_conv_feat_bn = None

    def downscale(self, cur_img):
        return avg_pool(cur_img, 4 if self.stride == 4 else 2)

    def _gate(self, x):
        s = torch.relu(self.s_feat_conv1(global_avg_pool(x)))
        return torch.sigmoid(self.s_feat_conv2(s))

    def forward(self, warp_feat, small_feat):
        cur = small_feat.to(self.dtype)
        if self.cur_scale is not None:
            cur = self.cur_scale(cur)
        ft = self.fuse_type
        if ft in ("add", "addv2"):
            if ft == "add":
                cur = self.fuse_reduce_add(cur)
            else:
                cur = self.fuse_reduce_add_conv2(torch.relu(self.fuse_reduce_add_conv1(cur)))
            if self.cur_feat_bn is not None:
                cur = self.cur_feat_bn(cur)
                warp_feat = self.warp_conv_feat_bn(warp_feat)
            return cur + warp_feat
        if ft == "concatv2":
            cur = self.fuse_reduce_c1(cur)
            return cur * self._gate(torch.cat([warp_feat, cur], dim=1)) + warp_feat
        cat = torch.cat([self.fuse_reduce_c2(warp_feat), self.fuse_reduce_c1(cur)], dim=1)
        cat = self.fuse_reduce(cat)
        if ft == "concat":
            return cat
        cat = torch.relu(cat)
        return cat * self._gate(cat) + cat
