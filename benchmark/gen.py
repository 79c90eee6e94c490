"""The benchmark's traffic generator: the inputs of one cell from its seed.

One general generator reads a traffic mix's data file
(``benchmark/traffic/<mix>.json``) and the configuration's shapes, and
draws the whole pool of inputs on the device with one ``torch.Generator``,
then moves it to pinned host memory, from which the window stages it. The
same seed gives the same pool. The mix's entry (``benchmark/entries/``)
calls the pool it drives; a new entry builds its own from the helpers
here.

Frames are smooth random scenes (bilinear upsampling of coarse noise plus
fine noise) in the content area of the bucket, padded as the data plane
pads: zero BGR, and Y=16, U=V=128 in I420, which converts to zero. Motion
vectors are smooth fields in feature cells, residuals normal.

The pools, by the entry that drives them:
- ``"entry": "process_gops"``: `lanes` lockstep streams, each a video of
  `video_gops` GOPs of KEY_FRAME_INTERVAL frames, served `gops_per_window`
  GOPs at a time; key frames planar I420 (``tpu.frame_payload``), non-key
  frames as 1/4 BGR frames with their motion vectors and residuals
  (`mv_std`, `res_std`).
- ``"entry": "detect"``: a pool of `pool_frames` BGR frames, one per call.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def content_hw(cfg: dict):
    """(h, w) of the resized content inside the bucket and its scale."""
    target, cap = cfg["SCALES"][0]
    src_h, src_w = cfg["source_frame_hw"]
    scale = min(target / min(src_h, src_w), cap / max(src_h, src_w))
    return round(src_h * scale), round(src_w * scale), scale


def _smooth(gen, n, c, h, w, lo, hi, device):
    """(n, c, h, w) float in [lo, hi]: coarse noise upsampled, plus fine."""
    coarse = torch.randn(n, c, max(h // 32, 2), max(w // 32, 2), generator=gen, device=device)
    x = F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)
    x = x + 0.25 * torch.randn(n, c, h, w, generator=gen, device=device)
    return ((x * 0.25 + 0.5) * (hi - lo) + lo).clamp(lo, hi)


def bgr_frames(gen, n, cfg, device, div: int = 1):
    """(n, H/div, W/div, 3) uint8 BGR frames, zero outside the content."""
    bh, bw = cfg["tpu"]["default_bucket"]
    ch, cw, _ = content_hw(cfg)
    h, w, rh, rw = bh // div, bw // div, ch // div, cw // div
    out = torch.zeros(n, 3, h, w, device=device)
    out[:, :, :rh, :rw] = _smooth(gen, n, 3, rh, rw, 0.0, 255.0, device)
    return out.round().to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def i420_frames(gen, n, cfg, device):
    """(n, H*3/2, W, 1) uint8 planar I420, Y=16, U=V=128 outside the
    content."""
    bh, bw = cfg["tpu"]["default_bucket"]
    ch, cw, _ = content_hw(cfg)
    y = torch.full((n, bh, bw), 16.0, device=device)
    uv = torch.full((n, 2, bh // 2, bw // 2), 128.0, device=device)
    y[:, :ch, :cw] = _smooth(gen, n, 1, ch, cw, 16.0, 235.0, device)[:, 0]
    uv[:, :, :ch // 2, :cw // 2] = _smooth(gen, n, 2, ch // 2, cw // 2, 16.0, 240.0, device)
    planes = [y.reshape(n, bh, bw), uv[:, 0].reshape(n, bh // 4, bw),
              uv[:, 1].reshape(n, bh // 4, bw)]
    return torch.cat(planes, 1).round().to(torch.uint8)[..., None]


def im_info(cfg: dict, rows: int):
    ch, cw, scale = content_hw(cfg)
    return torch.tensor([[float(ch), float(cw), scale]] * rows, dtype=torch.float32)


def _to_host(t, pin: bool):
    h = t.cpu()
    return h.pin_memory() if pin else h


def lane_pool(cfg: dict, mix: dict, seed: int, device) -> dict:
    """The pool of a ``process_gops`` mix: key_frames (G, L, ...), smalls
    (G, n, L, H/4, W/4, 3) uint8, mvs (G, n, L, fh, fw, 2) and ress
    (G, n, L, fh, fw, 3) float32, im_info (L, 3); G = video_gops."""
    gen = torch.Generator(device=device).manual_seed(seed)
    lanes, gops = mix["lanes"], mix["video_gops"]
    n = cfg["TEST"]["KEY_FRAME_INTERVAL"] - 1
    bh, bw = cfg["tpu"]["default_bucket"]
    stride = cfg["network"]["RPN_FEAT_STRIDE"]
    fh, fw = bh // stride, bw // stride
    pin = torch.device(device).type == "cuda"
    if cfg["tpu"]["frame_payload"] != "i420":
        raise ValueError("lockstep lanes take I420 key frames")
    keys, smalls, mvs, ress = [], [], [], []
    for _ in range(gops):
        keys.append(i420_frames(gen, lanes, cfg, device))
        smalls.append(bgr_frames(gen, n * lanes, cfg, device, div=4)
                      .reshape((n, lanes) + (bh // 4, bw // 4, 3)))
        mv = _smooth(gen, n * lanes, 2, fh, fw, -1.0, 1.0, device) * 2 * mix["mv_std"]
        mvs.append(mv.permute(0, 2, 3, 1).reshape(n, lanes, fh, fw, 2))
        res = torch.randn(n, lanes, fh, fw, 3, generator=gen, device=device) * mix["res_std"]
        ress.append(res)
    return {"key_frames": _to_host(torch.stack(keys), pin),
            "smalls": _to_host(torch.stack(smalls), pin),
            "mvs": _to_host(torch.stack(mvs), pin),
            "ress": _to_host(torch.stack(ress), pin),
            "im_info": im_info(cfg, lanes)}


def frame_pool(cfg: dict, mix: dict, seed: int, device) -> dict:
    """The pool of a ``detect`` mix: frames (F, 1, H, W, 3) uint8 BGR,
    im_info (1, 3)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    pin = torch.device(device).type == "cuda"
    frames = bgr_frames(gen, mix["pool_frames"], cfg, device)
    return {"frames": _to_host(frames[:, None], pin), "im_info": im_info(cfg, 1)}
