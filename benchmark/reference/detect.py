"""Plain reference of test-time detection: RPN proposals, PSROI scoring
and per-class greedy NMS, in float32.

A frozen copy of the equations of the port's plain detection path with
every import of the port cut: anchors on the feature grid, the "+1" box
convention, the top min(pre_nms, tier) proposals by fg score, greedy NMS
as the fixpoint of alive <- valid & no alive higher-ranked box with
IoU > t (at most min(N, 31) sweeps, as the program's), position-sensitive
average pooling, softmax scores, class-agnostic box regression, and the
global top `max_per_image` across classes.
"""

from __future__ import annotations

import numpy as np
import torch

BEYOND = 256


def anchor_grid(fh: int, fw: int, stride: int = 16, ratios=(0.5, 1, 2), scales=(8, 16, 32)):
    """(fh*fw*A, 4) anchors in (h, w, a) order."""
    ratios, scales = np.asarray(ratios, np.float64), np.asarray(scales, np.float64)
    ctr = (stride - 1) * 0.5
    ws_r = np.round(np.sqrt(stride * stride / ratios))
    hs_r = np.round(ws_r * ratios)
    ws = (ws_r[:, None] * scales[None]).reshape(-1)
    hs = (hs_r[:, None] * scales[None]).reshape(-1)
    base = np.stack([ctr - 0.5 * (ws - 1), ctr - 0.5 * (hs - 1),
                     ctr + 0.5 * (ws - 1), ctr + 0.5 * (hs - 1)], 1)
    sx, sy = np.meshgrid(np.arange(fw) * stride, np.arange(fh) * stride)
    shift = np.stack([sx, sy, sx, sy], -1)
    return (shift[:, :, None, :] + base[None, None]).reshape(-1, 4).astype(np.float32)


def bbox_pred(boxes, deltas):
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    cx, cy = boxes[..., 0] + 0.5 * (w - 1.0), boxes[..., 1] + 0.5 * (h - 1.0)
    d = deltas.reshape(deltas.shape[:-1] + (-1, 4))
    pcx = d[..., 0] * w[..., None] + cx[..., None]
    pcy = d[..., 1] * h[..., None] + cy[..., None]
    pw, ph = torch.exp(d[..., 2]) * w[..., None], torch.exp(d[..., 3]) * h[..., None]
    out = torch.stack([pcx - 0.5 * (pw - 1.0), pcy - 0.5 * (ph - 1.0),
                       pcx + 0.5 * (pw - 1.0), pcy + 0.5 * (ph - 1.0)], -1)
    return out.reshape(deltas.shape)


def clip_boxes(boxes, im_hw):
    """boxes (B, ..., 4K) clamped to [0, W-1] x [0, H-1]; im_hw (B, 2)."""
    b = boxes.reshape(boxes.shape[:-1] + (-1, 4))
    shape = (im_hw.shape[0],) + (1,) * (b.ndim - 2)
    h, w = im_hw[:, 0].reshape(shape), im_hw[:, 1].reshape(shape)
    x1 = b[..., 0].clamp(min=0.0).minimum(w - 1.0)
    y1 = b[..., 1].clamp(min=0.0).minimum(h - 1.0)
    x2 = b[..., 2].clamp(min=0.0).minimum(w - 1.0)
    y2 = b[..., 3].clamp(min=0.0).minimum(h - 1.0)
    return torch.stack([x1, y1, x2, y2], -1).reshape(boxes.shape)


def greedy_alive(boxes, valid, t: float, sweeps: int):
    """The NMS fixpoint on rank-sorted boxes (B, N, 4), valid (B, N)."""
    x1, y1, x2, y2 = boxes.float().unbind(-1)
    area = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
    iw = (torch.minimum(x2[:, :, None], x2[:, None]) - torch.maximum(x1[:, :, None], x1[:, None])
          + 1.0)
    ih = (torch.minimum(y2[:, :, None], y2[:, None]) - torch.maximum(y1[:, :, None], y1[:, None])
          + 1.0)
    inter = iw.clamp(min=0.0) * ih.clamp(min=0.0)
    union = area[:, :, None] + area[:, None] - inter
    n = boxes.shape[1]
    idx = torch.arange(n, device=boxes.device)
    sup = ((idx[:, None] < idx[None]) & (inter / union.clamp(min=1e-10) > t)).float()

    def f(alive):
        return valid & (torch.bmm(alive.float()[:, None], sup)[:, 0] == 0.0)

    prev, alive, i = valid, f(valid), 1
    while i < sweeps and bool((alive != prev).any()):
        prev, alive, i = alive, f(alive), i + 1
    return alive


def nms_fixed(boxes, scores, t: float, max_out: int, valid, presorted: bool = False):
    """Greedy NMS with fixed shapes: keep_idx (B, max_out) into the input
    by descending score (padding repeats the last kept) and keep_valid."""
    bsz, n = scores.shape
    dev = boxes.device
    if presorted:
        order, b, v = torch.arange(n, device=dev).expand(bsz, n), boxes, valid
    else:
        masked = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
        order = torch.argsort(-masked, dim=-1, stable=True)
        b = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
        v = torch.gather(valid, 1, order)
    alive = greedy_alive(b, v, t, min(n, 31))
    slot = torch.cumsum(alive.long(), -1) - 1
    tgt = torch.where(alive & (slot < max_out), slot, torch.full_like(slot, max_out))
    kept = torch.full((bsz, max_out + 1), -1, dtype=torch.long, device=dev)
    kept.scatter_(1, tgt, torch.arange(n, device=dev).expand(bsz, n))
    kept = kept[:, :max_out]
    keep_valid = kept >= 0
    num = keep_valid.sum(-1, keepdim=True)
    last = torch.gather(kept, 1, (num - 1).clamp(min=0))
    last = torch.where(num > 0, last, torch.zeros_like(last))
    return torch.gather(order, 1, torch.where(keep_valid, kept, last)), keep_valid


def proposal_candidates(fg, deltas, anchors, im_info, pre_nms, min_size, stride, tier,
                        extra: int = 0):
    """The RPN's NMS input: the top min(pre_nms, tier) decoded proposals
    (B, K, 4) by fg score, their scores (-inf where masked), in rank order;
    with `extra`, as many more of the next ranks as there are."""
    bsz, h, w, a = fg.shape
    scores = fg.reshape(bsz, -1).float()
    props = clip_boxes(bbox_pred(anchors, deltas.reshape(bsz, -1, 4).float()), im_info[:, :2])
    real_h = (im_info[:, 0:1] / stride).int()
    real_w = (im_info[:, 1:2] / stride).int()
    cell = torch.arange(h * w * a, device=fg.device)
    keep = ((cell // (w * a)) < real_h) & (((cell // a) % w) < real_w)
    ms = min_size * im_info[:, 2:3]
    keep &= ((props[..., 2] - props[..., 0] + 1.0) >= ms) & ((props[..., 3] - props[..., 1] + 1.0)
                                                             >= ms)
    masked = torch.where(keep, scores, torch.full_like(scores, float("-inf")))
    k = min(pre_nms, scores.shape[1])
    if tier and tier < k:
        k = tier
    top_s, top_i = torch.sort(masked, dim=-1, descending=True, stable=True)
    k = min(k + extra, scores.shape[1])
    top_s, top_i = top_s[:, :k], top_i[:, :k]
    return torch.gather(props, 1, top_i[..., None].expand(-1, -1, 4)), top_s


def round_half_away(x):
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def psroi_pool(feat, rois, out_dim, g=7, scale=1.0 / 16):
    """feat (B, H, W, out_dim*g*g) NHWC; rois (B, N, 5) -> (B, N, g, g,
    out_dim): the average over each whole-cell bin, 0 for an empty one."""
    bsz, h, w, _ = feat.shape
    f = feat.float().reshape(bsz, h, w, out_dim, g, g)
    r = rois.float()
    xs, ys = round_half_away(r[..., 1]) * scale, round_half_away(r[..., 2]) * scale
    xe, ye = (round_half_away(r[..., 3]) + 1.0) * scale, (round_half_away(r[..., 4]) + 1.0) * scale
    pt = torch.full_like(xs, g)
    bw, bh = (xe - xs).clamp(min=0.1) / pt, (ye - ys).clamp(min=0.1) / pt
    k = torch.arange(g, device=feat.device, dtype=torch.float32)

    def edge(start, size, fn, kk, hi):
        return fn(kk * size[..., None] + start[..., None]).clamp(0, hi).int()

    hs, he = edge(ys, bh, torch.floor, k, h), edge(ys, bh, torch.ceil, k + 1.0, h)
    ws, we = edge(xs, bw, torch.floor, k, w), edge(xs, bw, torch.ceil, k + 1.0, w)
    yy = torch.arange(h, device=feat.device, dtype=torch.int32)
    xx = torch.arange(w, device=feat.device, dtype=torch.int32)
    row = ((yy >= hs[..., None]) & (yy < he[..., None])).float()
    col = ((xx >= ws[..., None]) & (xx < we[..., None])).float()
    a = torch.einsum("bnqx,byxopq->bnqyop", col, f)
    pooled = torch.einsum("bnpy,bnqyop->bnpqo", row, a)
    area = ((he - hs)[..., :, None] * (we - ws)[..., None, :]).float()
    return torch.where((area <= 0)[..., None], torch.zeros_like(pooled),
                       pooled / area.clamp(min=1.0)[..., None])


def score_rois(maps, rois, im_info, cfg: dict):
    """Class scores (B, R, C) and class-agnostic boxes (B, R, 4) in
    original-image coordinates of rois (B, R, 5): PSROI pooling, softmax,
    regression, clipping and the division by the image scale."""
    n, t = cfg["network"], cfg["TRAIN"]
    c = cfg["dataset"]["NUM_CLASSES"]
    stride = n["RPN_FEAT_STRIDE"]
    bsz, r = rois.shape[:2]
    cls = torch.softmax(psroi_pool(maps["rfcn_cls_map"], rois, c, scale=1.0 / stride)
                        .mean(dim=(2, 3)), -1)
    deltas = psroi_pool(maps["rfcn_bbox_map"], rois, 8, scale=1.0 / stride).mean(dim=(2, 3))
    d = deltas.reshape(bsz, r, 2, 4)[:, :, 1:]
    d = torch.stack([d[..., k] * t["BBOX_STDS"][k] for k in range(4)], -1).reshape(bsz, r, 4)
    boxes = clip_boxes(bbox_pred(rois[..., 1:5], d), im_info[:, :2])
    return cls, boxes / im_info[:, 2].reshape(bsz, 1, 1)


def frames(maps, anchors, im_info, cfg: dict):
    """What the judge reads of each frame of a batch, on the host (float64
    numpy): every detection the network offers before any NMS, that is the
    RPN's NMS input (the top min(pre_nms, tier) finite proposals, in rank
    order) and the next BEYOND ranks, which a rounding can swap into it,
    scored for every class and regressed (`boxes` (K, 4), fg class scores
    `scores` (K, C-1), proposal boxes `props` (K, 4), RPN fg scores `fg`
    (K,)); and the reference's own final detections `dets` (M, 6) [label,
    score, x1, y1, x2, y2] by descending score, with `cand` (M,), the
    candidate each came from, and `fg_cut`, the fg score of the last
    proposal that could reach the class stage: the last the RPN's post-NMS
    cut let through or, when fewer survive its NMS, the last of its input
    (None when neither cut binds). cfg: the benchmark configuration."""
    t, n = cfg["TEST"], cfg["network"]
    fg = maps["rpn_fg"]
    bsz = fg.shape[0]
    im_info = im_info.float().reshape(-1, 3).expand(bsz, 3)
    out = []
    for i in range(bsz):
        info = im_info[i:i + 1]
        tier = cfg["tpu"]["nms_tier"]
        props, s = proposal_candidates(fg[i:i + 1], maps["rpn_deltas"][i:i + 1], anchors, info,
                                       t["RPN_PRE_NMS_TOP_N"], t["RPN_MIN_SIZE"],
                                       n["RPN_FEAT_STRIDE"], tier, BEYOND)
        k = int(torch.isfinite(s[0]).sum())
        k_in = min(k, t["RPN_PRE_NMS_TOP_N"], tier or k)
        props, s = props[:, :k], s[:, :k]
        rois = torch.cat([torch.zeros_like(props[..., :1]), props], -1)
        one = {m: maps[m][i:i + 1] for m in ("rfcn_cls_map", "rfcn_bbox_map")}
        cls, boxes = score_rois(one, rois, info, cfg)
        cls, boxes = cls[0, :, 1:], boxes[0]
        keep, kv = nms_fixed(props[:, :k_in], s[:, :k_in], t["RPN_NMS_THRESH"],
                             t["RPN_POST_NMS_TOP_N"], torch.ones_like(s[:, :k_in], dtype=torch.bool),
                             presorted=True)
        alive = keep[0][kv[0]]
        r = alive.numel()
        fg_cut = (float(s[0, alive[-1]]) if r == t["RPN_POST_NMS_TOP_N"]
                  else float(s[0, k_in - 1]) if k_in < k else None)
        dets = torch.zeros(0, 6, device=s.device)
        cand = torch.zeros(0, dtype=torch.long, device=s.device)
        if r:
            sc = cls[alive].T                                        # (C-1, R)
            c1 = sc.shape[0]
            ck, cv = nms_fixed(boxes[alive].expand(c1, r, 4), sc, t["NMS"], r,
                               sc > t["SCORE_THRESH"])
            kept = torch.where(cv, torch.gather(sc, 1, ck), torch.full_like(sc, -1.0))
            top_s, top_i = torch.sort(kept.reshape(-1), descending=True, stable=True)
            top_s, top_i = top_s[:t["max_per_image"]], top_i[:t["max_per_image"]]
            ok = top_s > 0
            top_s, top_i = top_s[ok], top_i[ok]
            cand = alive[ck.reshape(-1)[top_i]]
            dets = torch.cat([(top_i // r + 1).float()[:, None], top_s[:, None], boxes[cand]], -1)
        host = {"boxes": boxes, "scores": cls, "props": props[0], "fg": s[0], "dets": dets,
                "cand": cand}
        rec = {key: v.double().cpu().numpy() if v.is_floating_point() else v.cpu().numpy()
               for key, v in host.items()}
        rec["fg_cut"] = fg_cut
        out.append(rec)
    return out
