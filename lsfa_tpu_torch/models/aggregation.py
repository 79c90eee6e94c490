"""LSFA aggregation modules (NCHW), the counterparts of
``lsfa_tpu.models.aggregation``: the R-net residual adapter, the Nq-net
long-term quality weights, and the short-term small-net fusion by add.
The F-net exists here only as the 'None' identity, so it has no module.
The optional BatchNorms (the R-net's `bn`, the fusion's `cur_feat_bn` and
`warp_conv_feat_bn`) train with batch statistics in training mode and use
their running statistics in eval mode, as in the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn

from lsfa_tpu_torch.models.layers import BatchNorm, Conv, avg_pool


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


class SmallNetFuse(nn.Module):
    """Short-term fusion by add: a 3x3 conv maps the small net's feature to
    feat_dim and is added to the propagated feature. The small backbone
    itself belongs to the caller."""

    def __init__(self, in_channels: int, stride: int = 4, bn_before_fuse: bool = False,
                 scale_before_fuse: bool = False, feat_dim: int = 1024,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.stride = stride
        kw = dict(dtype=dtype, init="normal01", device=device)
        self.cur_scale = Conv(in_channels, in_channels, 1, **kw) if scale_before_fuse else None
        self.fuse_reduce_add = Conv(in_channels, feat_dim, 3, **kw)
        if bn_before_fuse:
            self.cur_feat_bn = BatchNorm(feat_dim, dtype=dtype, device=device)
            self.warp_conv_feat_bn = BatchNorm(feat_dim, dtype=dtype, device=device)
        else:
            self.cur_feat_bn = self.warp_conv_feat_bn = None

    def downscale(self, cur_img):
        return avg_pool(cur_img, 4 if self.stride == 4 else 2)

    def forward(self, warp_feat, small_feat):
        cur = small_feat.to(self.dtype)
        if self.cur_scale is not None:
            cur = self.cur_scale(cur)
        cur = self.fuse_reduce_add(cur)
        if self.cur_feat_bn is not None:
            cur = self.cur_feat_bn(cur)
            warp_feat = self.warp_conv_feat_bn(warp_feat)
        return cur + warp_feat
