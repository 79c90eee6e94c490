"""Pre-activation ResNet backbone (NCHW), the counterpart of
``lsfa_tpu.models.resnet``: input BN without scale, 7x7/2 stem and 3x3/2
max pool, full pre-activation units (shortcut from the first
post-activation when dims change), stride 16 by dilating the last stage,
and deformable 3x3 convs in the tail units of stages 2-4.
"""

from __future__ import annotations

import torch
from torch import nn

from lsfa_tpu_torch.models.layers import Conv, FrozenBN, max_pool_3x3_s2
from lsfa_tpu_torch.ops.deform_conv import deform_conv

RESNET_UNITS = {
    18: [2, 2, 2, 2], 26: [3, 3, 3, 3], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
    101: [3, 4, 23, 3], 152: [3, 8, 36, 3], 200: [3, 24, 36, 3], 269: [3, 30, 48, 8],
}


class DeformConv2d(nn.Module):
    """Zero-init offset conv, run in float32 on float32 input, then a
    deformable 3x3 conv (stride 1) whose contraction is in `dtype`."""

    def __init__(self, cin: int, cout: int, dilate: int = 1, groups: int = 4,
                 dtype=torch.float32, device=None):
        super().__init__()
        k = 3
        self.dilate = dilate
        self.groups = groups
        self.dtype = dtype
        self.offset = Conv(cin, groups * k * k * 2, k, dilate=dilate,
                           dtype=torch.float32, init="zeros", device=device)
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k, device=device))
        self.init = "he"

    def forward(self, x):
        off = self.offset(x.float())
        out = deform_conv(x.permute(0, 2, 3, 1), off.permute(0, 2, 3, 1), self.weight,
                          kernel=3, dilate=self.dilate, groups=self.groups,
                          compute_dtype=self.dtype)
        return out.permute(0, 3, 1, 2)


class PreactUnit(nn.Module):
    """bn-relu-conv x3 bottleneck (or x2 basic) with a projection shortcut
    from the first post-activation when dims change."""

    def __init__(self, cin: int, features: int, stride: int = 1, dilate: int = 1,
                 dim_match: bool = True, bottleneck: bool = True,
                 deformable_groups: int = 0, dtype=torch.float32, device=None):
        super().__init__()
        mid = features // 4 if bottleneck else features
        self.bottleneck = bottleneck
        kw = dict(bias=False, dtype=dtype, device=device)

        def conv3x3(ci, co, s):
            if deformable_groups > 0:
                if s != 1:
                    raise ValueError("deformable conv supports stride 1 only")
                return DeformConv2d(ci, co, dilate=dilate, groups=deformable_groups,
                                    dtype=dtype, device=device)
            return Conv(ci, co, 3, s, dilate, **kw)

        self.bn1 = FrozenBN(cin, dtype=dtype, device=device)
        if bottleneck:
            self.conv1 = Conv(cin, mid, 1, **kw)
            self.bn2 = FrozenBN(mid, dtype=dtype, device=device)
            self.conv2 = conv3x3(mid, mid, stride)
            self.bn3 = FrozenBN(mid, dtype=dtype, device=device)
            self.conv3 = Conv(mid, features, 1, **kw)
        else:
            self.conv1 = conv3x3(cin, features, stride)
            self.bn2 = FrozenBN(features, dtype=dtype, device=device)
            self.conv2 = Conv(features, features, 3, 1, 1, **kw)
        self.sc = None if dim_match else Conv(cin, features, 1, stride, **kw)

    def forward(self, x):
        a1 = torch.relu(self.bn1(x))
        if self.bottleneck:
            h = self.conv1(a1)
            h = self.conv2(torch.relu(self.bn2(h)))
            h = self.conv3(torch.relu(self.bn3(h)))
        else:
            h = self.conv1(a1)
            h = self.conv2(torch.relu(self.bn2(h)))
        sc = x if self.sc is None else self.sc(a1)
        return h + sc


class ResNetBackbone(nn.Module):
    """Returns per-stage features [c2, c3, c4, c5, post] (post = the final
    bn+relu, only when all 4 stages are built)."""

    def __init__(self, num_layer: int = 101, inv_resolution: int = 16,
                 deformable_units=(0, 0, 0, 0), num_deformable_group=(0, 0, 0, 0),
                 num_stages: int = 4, dtype=torch.float32, device=None):
        super().__init__()
        units = RESNET_UNITS[num_layer]
        bottleneck = num_layer >= 50
        filters = [256, 512, 1024, 2048] if bottleneck else [64, 128, 256, 512]
        inc_dilate = {32: [False] * 4, 16: [False, False, False, True],
                      8: [False, False, True, True]}[inv_resolution]
        self.dtype = dtype
        self.num_stages = num_stages
        self.out_channels = filters[:num_stages]
        self.bn_data = FrozenBN(3, use_scale=False, dtype=dtype, device=device)
        self.conv0 = Conv(3, 64, 7, 2, bias=False, dtype=dtype, device=device)
        self.bn0 = FrozenBN(64, dtype=dtype, device=device)
        self.stages = []
        cin, dilate = 64, 1
        for s in range(num_stages):
            stride = 1 if s == 0 else 2
            if inc_dilate[s]:
                dilate, stride = dilate * stride, 1
            n_units = units[s]
            names = []
            for u in range(n_units):
                is_deform = (u + 1) >= n_units - deformable_units[s] + 1
                unit = PreactUnit(
                    cin, filters[s], stride=stride if u == 0 else 1, dilate=dilate,
                    dim_match=(u != 0), bottleneck=bottleneck,
                    deformable_groups=(num_deformable_group[s]
                                       if is_deform and deformable_units[s] > 0 else 0),
                    dtype=dtype, device=device)
                name = f"stage{s + 1}_unit{u + 1}"
                self.add_module(name, unit)
                names.append(name)
                cin = filters[s]
            self.stages.append(names)
        if num_stages == 4:
            self.bn1 = FrozenBN(cin, dtype=dtype, device=device)

    def forward(self, x):
        x = self.bn_data(x.to(self.dtype))
        x = torch.relu(self.bn0(self.conv0(x)))
        x = max_pool_3x3_s2(x)
        parts = []
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            parts.append(x)
        if self.num_stages == 4:
            parts.append(torch.relu(self.bn1(x)))
        return parts
