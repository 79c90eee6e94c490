"""The MobileNetV2 trunks (NCHW), the counterparts of
``lsfa_tpu.models.mobilenet``: the standard inverted-residual trunk at
stride 16 (the stride-2 stages past 16 dilated instead, ReLU6, the 1280-ch
head) and the Hobot variant (plain ReLU, the t=1 expansion kept, res5
undilated at stride 1, no head: 320 channels out).

Every conv pads as flax's ``padding="SAME"`` (`SameConv`), never
symmetrically, and every BatchNorm is frozen. Like the JAX trunks they
return only the final feature, as a one-element list, and have no small
net.
"""

from __future__ import annotations

import torch
from torch import nn

from lsfa_tpu_torch.models.layers import FrozenBN, SameConv, relu6

# (expansion t, channels c, repeats n, stride s) — MobileNetV2 paper table 2
_MBV2_CFG = [
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),   # dilated instead of strided for stride-16 output
    (6, 320, 1, 1),
]


class InvertedResidual(nn.Module):
    """1x1 expansion (skipped at t=1 unless always_expand), depthwise 3x3,
    1x1 projection, each with a frozen BN; the skip only at stride 1 with
    cin == features."""

    def __init__(self, cin: int, features: int, stride: int = 1, expand: int = 6,
                 dilate: int = 1, relu6: bool = True, always_expand: bool = False,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.relu6 = relu6
        self.skip = stride == 1 and cin == features
        kw = dict(bias=False, dtype=dtype, device=device)
        bn = dict(dtype=dtype, device=device)
        mid = cin
        if expand != 1 or always_expand:
            mid = cin * expand
            self.expand = SameConv(cin, mid, 1, **kw)
            self.expand_bn = FrozenBN(mid, **bn)
        else:
            self.expand = None
        self.dw = SameConv(mid, mid, 3, stride, dilate, groups=mid, **kw)
        self.dw_bn = FrozenBN(mid, **bn)
        self.project = SameConv(mid, features, 1, **kw)
        self.project_bn = FrozenBN(features, **bn)

    def forward(self, x):
        act = relu6 if self.relu6 else torch.relu
        h = x
        if self.expand is not None:
            h = act(self.expand_bn(self.expand(h)))
        h = act(self.dw_bn(self.dw(h)))
        h = self.project_bn(self.project(h))
        return h + x if self.skip else h


class MobileNetV2Backbone(nn.Module):
    """Standard MobileNetV2 at width `width`: once the stride reaches
    inv_resolution, a stride-2 block runs at stride 1 and doubles the
    dilation, which then holds for every later block."""

    def __init__(self, width: float = 1.0, relu6: bool = True, inv_resolution: int = 16,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.relu6 = relu6
        kw = dict(dtype=dtype, device=device)
        c = int(32 * width)
        self.stem = SameConv(3, c, 3, 2, bias=False, **kw)
        self.stem_bn = FrozenBN(c, **kw)
        self.blocks = []
        stride_total, dilate = 2, 1
        for si, (t, ch, n, s) in enumerate(_MBV2_CFG):
            feats = int(ch * width)
            for i in range(n):
                stride = s if i == 0 else 1
                if stride == 2 and stride_total >= inv_resolution:
                    stride, dilate = 1, dilate * 2
                elif stride == 2:
                    stride_total *= 2
                name = f"block{si}_{i}"
                self.add_module(name, InvertedResidual(c, feats, stride, t, dilate, relu6, **kw))
                self.blocks.append(name)
                c = feats
        head = int(1280 * max(width, 1.0))
        self.head = SameConv(c, head, 1, bias=False, **kw)
        self.head_bn = FrozenBN(head, **kw)
        self.out_channels = [head]

    def forward(self, x):
        act = relu6 if self.relu6 else torch.relu
        x = act(self.stem_bn(self.stem(x.to(self.dtype))))
        for name in self.blocks:
            x = getattr(self, name)(x)
        return [act(self.head_bn(self.head(x)))]


class MobileNetV2HobotBackbone(nn.Module):
    """The Hobot MobileNetV2: plain ReLU, every block (bottleneck1..17)
    with its 1x1 expansion, res5 at stride 1 undilated when
    inv_resolution is 16, and the last block's 320 channels out."""

    def __init__(self, width: float = 1.0, inv_resolution: int = 16, dtype=torch.float32,
                 device=None):
        super().__init__()
        if inv_resolution not in (16, 32):
            raise ValueError(f"inv_resolution {inv_resolution}: 16 or 32")
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        c = int(32 * width)
        self.conv1 = SameConv(3, c, 3, 2, bias=False, **kw)
        self.conv1_bn = FrozenBN(c, **kw)
        cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2), (6, 96, 3, 1),
               (6, 160, 3, 2 if inv_resolution == 32 else 1), (6, 320, 1, 1)]
        self.blocks = []
        for t, ch, n, s in cfg:
            for i in range(n):
                name = f"bottleneck{len(self.blocks) + 1}"
                feats = int(ch * width)
                self.add_module(name, InvertedResidual(
                    c, feats, s if i == 0 else 1, t, relu6=False, always_expand=True, **kw))
                self.blocks.append(name)
                c = feats
        self.out_channels = [c]

    def forward(self, x):
        x = torch.relu(self.conv1_bn(self.conv1(x.to(self.dtype))))
        for name in self.blocks:
            x = getattr(self, name)(x)
        return [x]
