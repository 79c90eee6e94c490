"""FlowNet-S with the DFF scale map (NCHW), the counterpart of
``lsfa_tpu.models.flownet``: the two images /255, channel-concatenated and
2x2 average-pooled, six leaky-ReLU(0.1) conv stages, the FlowNet-S
refinement down to 1/16 of the image, and (flow * 2.5, scale_map) where
the 1x1 scale-map conv starts as weight 0, bias 1. Flow channels are
(dx, dy).
"""

from __future__ import annotations

import torch
from torch import nn

from lsfa_tpu_torch.models.layers import Conv, Deconv2x, avg_pool, leaky_relu

# (name, out channels, kernel, stride); symmetric pad k//2 (= mx_pad)
_TRUNK = [("conv1", 64, 7, 2), ("conv2", 128, 5, 2), ("conv3", 256, 5, 2),
          ("conv3_1", 256, 3, 1), ("conv4", 512, 3, 2), ("conv4_1", 512, 3, 1),
          ("conv5", 512, 3, 2), ("conv5_1", 512, 3, 1), ("conv6", 1024, 3, 2),
          ("conv6_1", 1024, 3, 1)]


class FlowNetS(nn.Module):
    def __init__(self, feat_dim: int = 1024, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        cin = 6
        for name, cout, k, s in _TRUNK:
            self.add_module(name, Conv(cin, cout, k, s, **kw))
            cin = cout
        # refinement levels: (level, deconv features, skip channels)
        cat = 1024
        self.flow6 = Conv(cat, 2, 3, **kw)
        for lvl, up, skip in ((5, 512, 512), (4, 256, 512), (3, 128, 256), (2, 64, 128)):
            self.add_module(f"deconv{lvl}", Deconv2x(cat, up, **kw))
            self.add_module(f"upflow{lvl}", Deconv2x(2, 2, **kw))
            cat = skip + up + 2
            if lvl > 2:
                self.add_module(f"flow{lvl}", Conv(cat, 2, 3, **kw))
        self.flow_final = Conv(cat, 2, 3, **kw)
        self.scale_map = Conv(cat, feat_dim, 1, init="scale_map", **kw)

    def forward(self, img_cur, img_ref):
        d = self.dtype
        x = torch.cat([img_cur.to(d), img_ref.to(d)], dim=1) / 255.0
        x = avg_pool(x, 2)                                   # half resolution
        feats = {}
        for name, *_ in _TRUNK:
            x = leaky_relu(getattr(self, name)(x))
            feats[name] = x

        def crop_to(t, ref):
            return t[..., : ref.shape[-2], : ref.shape[-1]]

        def refine(feat, skip, flow, lvl):
            up = leaky_relu(crop_to(getattr(self, f"deconv{lvl}")(feat), skip))
            uf = crop_to(getattr(self, f"upflow{lvl}")(flow), skip)
            return torch.cat([skip, up, uf], dim=1)

        flow = self.flow6(feats["conv6_1"])
        cat = feats["conv6_1"]
        for lvl, skip in ((5, "conv5_1"), (4, "conv4_1"), (3, "conv3_1"), (2, "conv2")):
            cat = refine(cat, feats[skip], flow, lvl)
            if lvl > 2:
                flow = getattr(self, f"flow{lvl}")(cat)
        cat = avg_pool(cat, 2)                               # 1/16 of the image
        flow = self.flow_final(cat).float() * 2.5
        return flow, self.scale_map(cat)
