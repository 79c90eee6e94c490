"""Plain float32 reference of the benchmarked networks, and the blocks a
new one is built from (``Conv``, ``Deconv2x``, ``FrozenBN``,
``DeformConv2d``, ``ResNet``, ``FlowNetS``, ``flow_warp``, ``Precision``).

A frozen, trimmed copy of the equations of LSFA (ResNet-101 with DCN,
FlowNet-S, Nq-net, R-net, small net at stride 4, add fusion) and of the
single-frame R-FCN, written from the published description and the port's
plain modules with every import of the port cut. Only the paths the
benchmark's configurations take are kept. NCHW inside, NHWC at the public
methods, as the program's are.

Submodule and parameter names equal the program's, so one state dict made
by ``benchmark.weights`` loads into both.

Every convolution and matrix product takes its operands through
``Precision.q``: the identity for the reference itself (float32, TF32 off),
a rounding to a lower type for the control (``float8``: per-tensor scaled
e4m3, the step below the configuration's bfloat16).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 2e-5
RESNET_UNITS = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3], 101: [3, 4, 23, 3]}


class Precision:
    """Operand rounding of every contraction: "float32" (none) or "float8"
    (e4m3 with one scale per tensor, amax to 448)."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "float8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def q(self, x):
        x = x.float()
        if self.name == "float32":
            return x
        amax = x.abs().amax().clamp(min=1e-30)
        scale = amax / 448.0
        return (x / scale).to(torch.float8_e4m3fn).float() * scale


def nchw(x):
    return x.permute(0, 3, 1, 2)


def nhwc(x):
    return x.permute(0, 2, 3, 1)


class Conv(nn.Module):
    """Conv2d with MXNet's symmetric pad ((k-1)*d+1)//2."""

    def __init__(self, cin, cout, k=1, stride=1, dilate=1, bias=True, prec=None, device=None):
        super().__init__()
        self.stride, self.dilate, self.pad = stride, dilate, ((k - 1) * dilate + 1) // 2
        self.prec = prec
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k, device=device))
        self.bias = nn.Parameter(torch.empty(cout, device=device)) if bias else None

    def forward(self, x):
        q = self.prec.q
        b = None if self.bias is None else self.bias.float()
        return F.conv2d(q(x), q(self.weight), b, self.stride, self.pad, self.dilate)


class Deconv2x(nn.Module):
    """4x4 stride-2 transposed conv, one border row/col cropped each side."""

    def __init__(self, cin, cout, prec=None, device=None):
        super().__init__()
        self.prec = prec
        self.weight = nn.Parameter(torch.empty(cin, cout, 4, 4, device=device))
        self.bias = nn.Parameter(torch.empty(cout, device=device))

    def forward(self, x):
        q = self.prec.q
        return F.conv_transpose2d(q(x), q(self.weight), self.bias.float(), stride=2)[..., 1:-1, 1:-1]


class FrozenBN(nn.Module):
    def __init__(self, c, use_scale=True, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c, device=device)) if use_scale else None
        self.bias = nn.Parameter(torch.empty(c, device=device))
        self.register_buffer("running_mean", torch.empty(c, device=device))
        self.register_buffer("running_var", torch.empty(c, device=device))

    def forward(self, x):
        return F.batch_norm(x.float(), self.running_mean, self.running_var, self.weight,
                            self.bias, training=False, eps=BN_EPS)


def flow_warp(feat, flow):
    """Bilinear warp of NCHW `feat` by NCHW `flow` (dx, dy); corners
    outside the map add zero."""
    b, _, h, w = feat.shape
    fl = flow.float()
    gy = torch.arange(h, device=feat.device, dtype=torch.float32).view(1, h, 1)
    gx = torch.arange(w, device=feat.device, dtype=torch.float32).view(1, 1, w)
    sx = gx + fl[:, 0]
    sy = gy + fl[:, 1]
    grid = torch.stack([sx * (2.0 / max(w - 1, 1)) - 1.0, sy * (2.0 / max(h - 1, 1)) - 1.0], -1)
    return F.grid_sample(feat.float(), grid, mode="bilinear", padding_mode="zeros",
                         align_corners=True)


def deform_conv(x, off, weight, prec, dilate=1, groups=4, k=3):
    """Deformable conv v1, stride 1: NCHW x, NCHW offsets laid out (G, K*K,
    (dy, dx)); bilinear taps gathered in float32, one contraction."""
    b, cin, h, w = x.shape
    g, kk = groups, k * k
    cpg = cin // g
    dev = x.device
    xf = x.float().permute(0, 2, 3, 1).reshape(b, h * w * g, cpg)
    o = off.float().permute(0, 2, 3, 1).reshape(b, h, w, g, kk, 2)
    gy = torch.arange(h, device=dev, dtype=torch.float32).view(h, 1, 1, 1)
    gx = torch.arange(w, device=dev, dtype=torch.float32).view(1, w, 1, 1)
    tap = torch.arange(kk, device=dev)
    half = (k - 1) // 2
    sy = gy + ((tap // k - half) * dilate).float() + o[..., 0]
    sx = gx + ((tap % k - half) * dilate).float() + o[..., 1]
    gid = torch.arange(g, device=dev).view(g, 1)

    def corner(yc, xc, wgt):
        inside = (xc >= 0) & (xc <= w - 1) & (yc >= 0) & (yc <= h - 1)
        yi, xi = yc.clamp(0, h - 1).long(), xc.clamp(0, w - 1).long()
        idx = ((yi * w + xi) * g + gid).reshape(b, -1, 1).expand(-1, -1, cpg)
        vals = torch.gather(xf, 1, idx).view(b, h, w, g, kk, cpg)
        return vals * torch.where(inside, wgt, 0.0)[..., None]

    y0, x0 = torch.floor(sy), torch.floor(sx)
    wy, wx = sy - y0, sx - x0
    s = (corner(y0, x0, (1 - wy) * (1 - wx)) + corner(y0, x0 + 1, (1 - wy) * wx)
         + corner(y0 + 1, x0, wy * (1 - wx)) + corner(y0 + 1, x0 + 1, wy * wx))
    cout = weight.shape[0]
    wmat = (weight.permute(2, 3, 1, 0).reshape(kk, g, cpg, cout).permute(1, 0, 2, 3)
            .reshape(g * kk * cpg, cout))
    out = prec.q(s.reshape(b * h * w, g * kk * cpg)) @ prec.q(wmat)
    return out.reshape(b, h, w, cout).permute(0, 3, 1, 2)


class DeformConv2d(nn.Module):
    def __init__(self, cin, cout, dilate, groups, prec, device=None):
        super().__init__()
        self.dilate, self.groups, self.prec = dilate, groups, prec
        # the offset conv runs in float32 in any configuration
        self.offset = Conv(cin, groups * 18, 3, dilate=dilate, prec=Precision(), device=device)
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3, device=device))

    def forward(self, x):
        return deform_conv(x, self.offset(x), self.weight, self.prec, self.dilate, self.groups)


class PreactUnit(nn.Module):
    def __init__(self, cin, features, stride, dilate, dim_match, dcn_groups, prec, device):
        super().__init__()
        mid = features // 4
        kw = dict(bias=False, prec=prec, device=device)
        self.bn1 = FrozenBN(cin, device=device)
        self.conv1 = Conv(cin, mid, 1, **kw)
        self.bn2 = FrozenBN(mid, device=device)
        self.conv2 = (DeformConv2d(mid, mid, dilate, dcn_groups, prec, device) if dcn_groups
                      else Conv(mid, mid, 3, stride, dilate, **kw))
        self.bn3 = FrozenBN(mid, device=device)
        self.conv3 = Conv(mid, features, 1, **kw)
        self.sc = None if dim_match else Conv(cin, features, 1, stride, **kw)

    def forward(self, x):
        a1 = torch.relu(self.bn1(x))
        h = self.conv1(a1)
        h = self.conv2(torch.relu(self.bn2(h)))
        h = self.conv3(torch.relu(self.bn3(h)))
        return h + (x if self.sc is None else self.sc(a1))


class ResNet(nn.Module):
    """Pre-activation bottleneck ResNet at stride 16 (stage 4 dilated 2),
    DCN in the last `dcn_units[s]` units of stage s."""

    def __init__(self, num_layer, dcn_units=(0, 0, 0, 0), dcn_groups=(0, 0, 0, 0),
                 num_stages=4, prec=None, device=None):
        super().__init__()
        units = RESNET_UNITS[num_layer]
        filters = [256, 512, 1024, 2048]
        self.num_stages = num_stages
        self.out_channels = filters[:num_stages]
        self.bn_data = FrozenBN(3, use_scale=False, device=device)
        self.conv0 = Conv(3, 64, 7, 2, bias=False, prec=prec, device=device)
        self.bn0 = FrozenBN(64, device=device)
        self.stages = []
        cin, dilate = 64, 1
        for s in range(num_stages):
            stride = 1 if s == 0 else 2
            if s == 3:
                dilate, stride = dilate * stride, 1
            names = []
            for u in range(units[s]):
                deform = dcn_units[s] > 0 and u + 1 >= units[s] - dcn_units[s] + 1
                name = f"stage{s + 1}_unit{u + 1}"
                self.add_module(name, PreactUnit(
                    cin, filters[s], stride if u == 0 else 1, dilate, u != 0,
                    dcn_groups[s] if deform else 0, prec, device))
                names.append(name)
                cin = filters[s]
            self.stages.append(names)
        if num_stages == 4:
            self.bn1 = FrozenBN(cin, device=device)

    def forward(self, x):
        x = torch.relu(self.bn0(self.conv0(self.bn_data(x))))
        x = F.max_pool2d(x, 3, 2, padding=1)
        parts = []
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            parts.append(x)
        if self.num_stages == 4:
            parts.append(torch.relu(self.bn1(x)))
        return parts


_FLOW_TRUNK = [("conv1", 64, 7, 2), ("conv2", 128, 5, 2), ("conv3", 256, 5, 2),
               ("conv3_1", 256, 3, 1), ("conv4", 512, 3, 2), ("conv4_1", 512, 3, 1),
               ("conv5", 512, 3, 2), ("conv5_1", 512, 3, 1), ("conv6", 1024, 3, 2),
               ("conv6_1", 1024, 3, 1)]


class FlowNetS(nn.Module):
    """FlowNet-S on two images /255 at half resolution, refined to 1/16;
    returns (flow * 2.5 as (dx, dy), the DFF scale map)."""

    def __init__(self, feat_dim, prec, device=None):
        super().__init__()
        kw = dict(prec=prec, device=device)
        cin = 6
        for name, cout, k, s in _FLOW_TRUNK:
            self.add_module(name, Conv(cin, cout, k, s, **kw))
            cin = cout
        cat = 1024
        self.flow6 = Conv(cat, 2, 3, **kw)
        for lvl, up, skip in ((5, 512, 512), (4, 256, 512), (3, 128, 256), (2, 64, 128)):
            self.add_module(f"deconv{lvl}", Deconv2x(cat, up, **kw))
            self.add_module(f"upflow{lvl}", Deconv2x(2, 2, **kw))
            cat = skip + up + 2
            if lvl > 2:
                self.add_module(f"flow{lvl}", Conv(cat, 2, 3, **kw))
        self.flow_final = Conv(cat, 2, 3, **kw)
        self.scale_map = Conv(cat, feat_dim, 1, **kw)

    def forward(self, img_cur, img_ref):
        x = F.avg_pool2d(torch.cat([img_cur, img_ref], 1) / 255.0, 2)
        feats = {}
        for name, *_ in _FLOW_TRUNK:
            x = F.leaky_relu(getattr(self, name)(x), 0.1)
            feats[name] = x

        def crop(t, ref):
            return t[..., : ref.shape[-2], : ref.shape[-1]]

        flow = self.flow6(feats["conv6_1"])
        cat = feats["conv6_1"]
        for lvl, skip in ((5, "conv5_1"), (4, "conv4_1"), (3, "conv3_1"), (2, "conv2")):
            s = feats[skip]
            up = F.leaky_relu(crop(getattr(self, f"deconv{lvl}")(cat), s), 0.1)
            cat = torch.cat([s, up, crop(getattr(self, f"upflow{lvl}")(flow), s)], 1)
            if lvl > 2:
                flow = getattr(self, f"flow{lvl}")(cat)
        cat = F.avg_pool2d(cat, 2)
        return self.flow_final(cat) * 2.5, self.scale_map(cat)


class NqNet(nn.Module):
    """Per-pixel softmax weights over (warped, fresh) from a shared tower."""

    def __init__(self, feat_dim, prec, device=None):
        super().__init__()
        kw = dict(prec=prec, device=device)
        self.conv1 = Conv(feat_dim, 256, 3, **kw)
        self.conv2 = Conv(256, 16, 1, **kw)
        self.conv3 = Conv(16, 1, 1, **kw)

    def forward(self, warped, fresh):
        b = warped.shape[0]
        h = torch.relu(self.conv2(torch.relu(self.conv1(torch.cat([warped, fresh], 0)))))
        logits = self.conv3(h)
        wgt = torch.softmax(torch.stack([logits[:b], logits[b:]], 0), 0)
        return wgt[0] * warped + wgt[1] * fresh


class RNet(nn.Module):
    """The R-net with no 3x3 convs: one 1x1 conv of the residual to feat_dim."""

    def __init__(self, feat_dim, prec, device=None):
        super().__init__()
        self.conv0 = Conv(3, feat_dim, 1, prec=prec, device=device)

    def forward(self, res):
        return self.conv0(res)


class SmallNetFuse(nn.Module):
    """Add fusion: a 3x3 of the small net's feature to feat_dim, added."""

    def __init__(self, cin, feat_dim, prec, device=None):
        super().__init__()
        self.fuse_reduce_add = Conv(cin, feat_dim, 3, prec=prec, device=device)

    def forward(self, warped, small_feat):
        return self.fuse_reduce_add(small_feat) + warped


class RFCNBase(nn.Module):
    def __init__(self, num_classes, feat_dim, num_layer, num_anchors, add_dcn, anchor_stds,
                 prec, device):
        super().__init__()
        self.num_classes, self.feat_dim, self.num_anchors = num_classes, feat_dim, num_anchors
        dcn = ((0, 1, 1, 3), (0, 4, 4, 4)) if add_dcn else ((0,) * 4, (0,) * 4)
        self.backbone = ResNet(num_layer, *dcn, prec=prec, device=device)
        self.feat_conv_3x3 = Conv(self.backbone.out_channels[-1], feat_dim, 3, dilate=6,
                                  prec=prec, device=device)
        self.rpn_stds = list(anchor_stds) * num_anchors
        self._prec, self._device = prec, device

    def _build_heads(self):
        half, a, kw = self.feat_dim // 2, self.num_anchors, dict(prec=self._prec,
                                                                 device=self._device)
        self.rpn_cls_score = Conv(half, 2 * a, 1, **kw)
        self.rpn_bbox_pred = Conv(half, 4 * a, 1, **kw)
        self.rfcn_cls = Conv(half, self.num_classes * 49, 1, **kw)
        self.rfcn_bbox = Conv(half, 8 * 49, 1, **kw)

    @staticmethod
    def preprocess(img):
        """Raw BGR (B, H, W, 3) -> RGB float32 (pixel means 0, scale 1)."""
        return torch.flip(img.float(), dims=[-1])

    def conv_feat(self, x):
        return torch.relu(self.feat_conv_3x3(self.backbone(x)[-1]))

    def detection_maps(self, feat):
        """NCHW feature -> NHWC fg probabilities, decoded RPN deltas and the
        position-sensitive maps."""
        half, a = self.feat_dim // 2, self.num_anchors
        rpn, rfcn = feat[:, :half], feat[:, half:]
        logits = nhwc(self.rpn_cls_score(rpn))
        fg = torch.softmax(torch.stack([logits[..., :a], logits[..., a:]], -1), -1)[..., 1]
        stds = torch.tensor(self.rpn_stds, device=feat.device)
        return {"feat": nhwc(feat), "rpn_fg": fg,
                "rpn_deltas": nhwc(self.rpn_bbox_pred(rpn)) * stds,
                "rfcn_cls_map": nhwc(self.rfcn_cls(rfcn)),
                "rfcn_bbox_map": nhwc(self.rfcn_bbox(rfcn))}


class RFCN(RFCNBase):
    def __init__(self, num_classes=31, feat_dim=1024, num_layer=101, num_anchors=9,
                 add_dcn=False, anchor_stds=(0.1, 0.1, 0.4, 0.4), prec=None, device=None):
        super().__init__(num_classes, feat_dim, num_layer, num_anchors, add_dcn, anchor_stds,
                         prec or Precision(), device)
        self._build_heads()

    def forward(self, data):
        return self.detection_maps(self.conv_feat(nchw(self.preprocess(data))))


class LSFA(RFCNBase):
    """forward_key: trunk, FlowNet-S warp of the cached key feature, Nq-net;
    forward_cur: motion-vector warp + R-net residual + small net (stride 4)."""

    def __init__(self, num_classes=31, feat_dim=1024, num_layer=101, num_anchors=9,
                 add_dcn=True, anchor_stds=(0.1, 0.1, 0.4, 0.4), prec=None, device=None):
        prec = prec or Precision()
        super().__init__(num_classes, feat_dim, num_layer, num_anchors, add_dcn, anchor_stds,
                         prec, device)
        self.flownet = FlowNetS(feat_dim, prec, device)
        self.nq_net = NqNet(feat_dim, prec, device)
        self.rnet = RNet(feat_dim, prec, device)
        self.small_net_backbone = ResNet(num_layer, num_stages=1, prec=prec, device=device)
        self.small_fuse = SmallNetFuse(256, feat_dim, prec, device)
        self._build_heads()

    def preprocess(self, img):
        """BGR (B, H, W, 3), or I420 (B, H*3/2, W, 1) by BT.601 limited range
        with nearest chroma upsampling -> RGB float32."""
        if img.shape[-1] != 1:
            return super().preprocess(img)
        p = img[..., 0]
        h, w = p.shape[-2] * 2 // 3, p.shape[-1]
        y = p[:, :h].float()
        u = p[:, h:h + h // 4].reshape(-1, h // 2, w // 2).float() - 128.0
        v = p[:, h + h // 4:].reshape(-1, h // 2, w // 2).float() - 128.0
        u = u.repeat_interleave(2, 1).repeat_interleave(2, 2)
        v = v.repeat_interleave(2, 1).repeat_interleave(2, 2)
        yf = (y - 16.0) * 1.164384
        rgb = torch.stack([yf + 1.596027 * v, yf - 0.391762 * u - 0.812968 * v,
                           yf + 2.017232 * u], -1)
        return rgb.clamp(0.0, 255.0)

    def forward_key(self, data, data_key_old, feat_key_old, is_first):
        """Returns the detection maps, with the new carry: feat (NHWC
        float32) and prep (the preprocessed frame)."""
        data = self.preprocess(data)
        x = nchw(data)
        fresh = self.conv_feat(x)
        first = (is_first > 0).reshape(-1, 1, 1, 1)
        old = torch.where(first, fresh, nchw(feat_key_old))
        flow, scale = self.flownet(x, nchw(data_key_old))
        prop = self.nq_net(flow_warp(old, flow) * scale, fresh)
        out = self.detection_maps(torch.where(first, fresh, prop))
        out["prep"] = data
        return out

    def forward_cur(self, small, feat_key, mv, res):
        fused = flow_warp(nchw(feat_key), nchw(mv)) + self.rnet(nchw(res))
        small_feat = self.small_net_backbone(nchw(self.preprocess(small)))[0]
        return self.detection_maps(self.small_fuse(fused, small_feat))


def net_args(cfg: dict, paths: dict) -> dict:
    """A reference network's constructor arguments from a configuration,
    once it is known to take only paths the reference implements: each
    switch of `paths` (where the `network` section sets it) at its value
    there, a ResNet of 50 layers or more, pixel means 0 and scale 1."""
    n = cfg["network"]
    other = {k: n[k] for k in paths if k in n and n[k] != paths[k]}
    if other or n["num_layer"] < 50 or n["PIXEL_MEANS"] != [0.0, 0.0, 0.0] or n["PIXEL_SCALE"] != 1:
        raise ValueError(f"the reference does not implement {other or n}")
    return dict(num_classes=cfg["dataset"]["NUM_CLASSES"], feat_dim=n.get("DFF_FEAT_DIM", 1024),
                num_layer=n["num_layer"], add_dcn=n["add_dcn"])
