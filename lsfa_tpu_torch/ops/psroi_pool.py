"""Position-sensitive ROI average pooling (R-FCN), batched over frames.

The counterpart of ``lsfa_tpu.ops.psroi_pool.psroi_pool``: round each roi
to integer pixels (C round, halves away from zero), scale to the feature
grid, split into P x P fractional bins, floor/ceil each bin to whole cells
clipped to the map, and average channel (ctop*G + gh)*G + gw over the bin;
an empty bin gives 0. The bin average is separable, so it is two
contractions with 0/1 row and column indicators.
"""

from __future__ import annotations

import torch


def round_half_away(x):
    """C round(): halves away from zero (torch.round rounds half to even)."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def bin_bounds(rois, h: int, w: int, p: int, spatial_scale: float):
    """Integer bin bounds (..., P) per roi: hstart, hend, wstart, wend."""
    xs = round_half_away(rois[..., 1]) * spatial_scale
    ys = round_half_away(rois[..., 2]) * spatial_scale
    xe = (round_half_away(rois[..., 3]) + 1.0) * spatial_scale
    ye = (round_half_away(rois[..., 4]) + 1.0) * spatial_scale
    # divide by a tensor: CUDA turns division by a Python scalar into a
    # multiply by its reciprocal, which moves bin edges that fall exactly
    # on a feature cell by one cell
    pt = torch.full_like(xs, p)
    bin_w = (xe - xs).clamp(min=0.1) / pt
    bin_h = (ye - ys).clamp(min=0.1) / pt
    ph = torch.arange(p, device=rois.device, dtype=torch.float32)

    def edge(start, size, fn, k, hi):
        return fn(k * size[..., None] + start[..., None]).clamp(0, hi).int()

    return (edge(ys, bin_h, torch.floor, ph, h), edge(ys, bin_h, torch.ceil, ph + 1.0, h),
            edge(xs, bin_w, torch.floor, ph, w), edge(xs, bin_w, torch.ceil, ph + 1.0, w))


def psroi_pool(feat, rois, output_dim: int, group_size: int = 7,
               pooled_size: int = 7, spatial_scale: float = 1.0 / 16):
    """feat (B, H, W, output_dim*G*G) NHWC; rois (B, N, 5) [batch_idx, x1,
    y1, x2, y2] at input-image scale. Returns (B, N, P, P, output_dim)
    float32.

    A bf16 map is contracted as bf16 values with float32 accumulation:
    upcasting to float32 is exact, and so are the products with the 0/1
    indicators."""
    bsz, h, w, ch = feat.shape
    g, p = group_size, pooled_size
    if ch != output_dim * g * g or g != p:
        raise ValueError(f"need C == output_dim*G*G and G == P, got C={ch}, "
                         f"output_dim={output_dim}, G={g}, P={p}")
    f = feat.float().reshape(bsz, h, w, output_dim, g, g)
    hs, he, ws_, we = bin_bounds(rois.float(), h, w, p, spatial_scale)
    ys = torch.arange(h, device=feat.device, dtype=torch.int32)
    xs = torch.arange(w, device=feat.device, dtype=torch.int32)
    row = ((ys >= hs[..., None]) & (ys < he[..., None])).float()    # (B, N, P, H)
    col = ((xs >= ws_[..., None]) & (xs < we[..., None])).float()   # (B, N, P, W)

    # A[b, n, q(pw), y, o, p(ph)] = sum_x col[b,n,q,x] F[b,y,x,o,p,q]
    a = torch.einsum("bnqx,byxopq->bnqyop", col, f)
    # pooled[b, n, p, q, o] = sum_y row[b,n,p,y] A[b,n,q,y,o,p]
    pooled = torch.einsum("bnpy,bnqyop->bnpqo", row, a)

    area = ((he - hs)[..., :, None] * (we - ws_)[..., None, :]).float()
    return torch.where((area <= 0)[..., None], torch.zeros_like(pooled),
                       pooled / area.clamp(min=1.0)[..., None])
