"""Deformable convolution v1 (stride 1, SAME padding): per-group bilinear
taps gathered from the input, then one contraction against the weight.

The counterpart of ``lsfa_tpu.ops.deform_conv``. Offsets are laid out
(H, W, G, K*K, 2) flattened to channels, last dim (dy, dx); input channels
split into G groups, each sampled with its own offsets. Zero offsets reduce
to a standard (dilated) convolution.
"""

from __future__ import annotations

import torch


def deform_conv(x, offsets, weight, bias=None, kernel: int = 3,
                dilate: int = 1, groups: int = 1,
                compute_dtype: torch.dtype = torch.float32):
    """x (B, H, W, Cin) NHWC; offsets (B, H, W, G*K*K*2); weight
    (Cout, Cin, K, K) as a torch conv weight; bias (Cout,) or None.

    Sampling runs in float32; the contraction takes `compute_dtype`
    operands (float32 accumulation). Returns (B, H, W, Cout) in x's dtype.
    """
    b, h, w, cin = x.shape
    k, g = kernel, groups
    kk = k * k
    if cin % g:
        raise ValueError(f"{cin} input channels do not split into {g} groups")
    cpg = cin // g
    f32 = torch.float32
    dev = x.device
    xf = x.float().reshape(b, h * w * g, cpg)
    off = offsets.float().reshape(b, h, w, g, kk, 2)

    gy = torch.arange(h, device=dev, dtype=f32).view(h, 1, 1, 1)
    gx = torch.arange(w, device=dev, dtype=f32).view(1, w, 1, 1)
    tap = torch.arange(kk, device=dev)
    half = (k - 1) // 2
    dty = ((tap // k - half) * dilate).to(f32)              # (K*K,)
    dtx = ((tap % k - half) * dilate).to(f32)
    sy = gy + dty + off[..., 0]                              # (B, H, W, G, K*K)
    sx = gx + dtx + off[..., 1]
    gid = torch.arange(g, device=dev).view(g, 1)

    def corner(yc, xc, wgt):
        inside = (xc >= 0) & (xc <= w - 1) & (yc >= 0) & (yc <= h - 1)
        yi = yc.clamp(0, h - 1).long()
        xi = xc.clamp(0, w - 1).long()
        idx = ((yi * w + xi) * g + gid).reshape(b, -1, 1).expand(-1, -1, cpg)
        vals = torch.gather(xf, 1, idx).view(b, h, w, g, kk, cpg)
        return vals * torch.where(inside, wgt, 0.0)[..., None]

    y0 = torch.floor(sy)
    x0 = torch.floor(sx)
    wy1 = sy - y0
    wx1 = sx - x0
    sampled = (corner(y0, x0, (1 - wy1) * (1 - wx1))
               + corner(y0, x0 + 1, (1 - wy1) * wx1)
               + corner(y0 + 1, x0, wy1 * (1 - wx1))
               + corner(y0 + 1, x0 + 1, wy1 * wx1))          # (B, H, W, G, K*K, cpg)

    cout = weight.shape[0]
    # (Cout, Cin, K, K) -> rows ordered (g, tap, c) to match `sampled`
    wmat = (weight.permute(2, 3, 1, 0).reshape(kk, g, cpg, cout)
            .permute(1, 0, 2, 3).reshape(g * kk * cpg, cout))
    out = torch.matmul(sampled.reshape(b * h * w, g * kk * cpg).to(compute_dtype),
                       wmat.to(compute_dtype))
    out = out.float().reshape(b, h, w, cout)
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)
