"""Ground-truth motion grids from the synthetic generator's analytic
state — the oracle-warp rung's data plane. A copy of
``lsfa_tpu.data.oracle_flow`` (numpy only), which the port cannot import.

The round-4 ablation left the central question open: every warped rung
sits ~0.15 mAP below the single-frame R-FCN, and nothing distinguishes
"block MVs from a 500 kbps MPEG-4 stream can't express this motion" from
"the rebuilt warp/propagation path leaks accuracy". This module closes
that gap from above: render_video records, per frame, the camera pose
(pan + zoom), every object's screen center/size, and a stride-8 object-id
map (data/synth.py record_state). From those the EXACT backward flow of
any frame to its GOP key frame is computable analytically:

  * object pixels translate with the object and rescale about its center
    (screen_size ratio covers both the size wobble and the camera zoom);
  * background (and occluder) pixels follow the camera homothety
    (pan + zoom about the image center).

The oracle rung trains and evaluates the SAME mv_only graph with these
grids substituted for decoded MVs (cfg.network.oracle_mv), upper-bounding
what ANY motion-vector estimate could achieve on this data. If the
oracle rung recovers the R-FCN's mAP, warping itself is sound and the
gap is the codec's blocky 16x16 MV field; if it does not, the loss is in
warped-feature detection itself (training or propagation).

Conventions (must match the decoded-MV payloads, data/coviar.py
decode_gop_prepared): grids are (fh, fw, 2) float32 at the RCNN feature
stride over the RESIZED image, channel order (dx, dy) in FEATURE-CELL
units, such that flow_warp(key_feat, mv)(p) samples key_feat at p + mv(p)
(ops/warp.py). Cells beyond the valid (ceil(sh/stride), ceil(sw/stride))
region are zero, like the bucket padding of real payloads.
"""

from __future__ import annotations

import numpy as np


def oracle_mv_grid(state, cur_id: int, key_id: int, fh: int, fw: int,
                   im_scale: float, stride: int, orig_hw,
                   flip: bool = False) -> np.ndarray:
    """GT backward flow grid for frame cur_id referencing frame key_id.

    Args:
      state: render_video record_state dict ("cam" (T,3), "obj" (T,O,3),
        "idmap8" (T, ceil(H/8), ceil(W/8)) int8).
      fh, fw: full bucket grid shape (bucket_hw // stride).
      im_scale: resize factor of this sample (im_info[2]).
      stride: RCNN feature stride (16).
      orig_hw: (H, W) of the source video.
      flip: sample was x-mirrored at load time (train-time augmentation);
        the grid is computed on the mirrored geometry (dx negated,
        columns mirrored) to match the flipped frames.

    Returns (fh, fw, 2) float32, warp-ready for ops/warp.flow_warp.
    """
    H, W = int(orig_hw[0]), int(orig_hw[1])
    gh = int(np.ceil(H * im_scale / stride))
    gw = int(np.ceil(W * im_scale / stride))
    gh, gw = min(gh, fh), min(gw, fw)

    # grid-cell centers in ORIGINAL pixel coordinates
    ys = (np.arange(gh, dtype=np.float32) + 0.5) * stride / im_scale
    xs = (np.arange(gw, dtype=np.float32) + 0.5) * stride / im_scale
    px = np.broadcast_to(xs[None, :], (gh, gw))
    py = np.broadcast_to(ys[:, None], (gh, gw))
    if flip:
        # the loader mirrors the decoded frames; the analytic state is
        # unmirrored, so sample it at the mirrored x and negate dx below
        px = W - px

    cam = state["cam"]
    obj = state["obj"]
    idm = state["idmap8"]
    cx_t, cy_t, z_t = cam[cur_id]
    cx_k, cy_k, z_k = cam[key_id]
    c0x, c0y = W / 2.0, H / 2.0

    # background/occluder flow: screen -> world at cur, world -> screen
    # at key (the render's exact camera model, data/synth.py:241-243)
    wx = (px - c0x) / z_t + cx_t
    wy = (py - c0y) / z_t + cy_t
    bx = (wx - cx_k) * z_k + c0x
    by = (wy - cy_k) * z_k + c0y

    # object id per cell from the stride-8 id map
    iy = np.clip((py / 8.0).astype(np.int32), 0, idm.shape[1] - 1)
    ix = np.clip((px / 8.0).astype(np.int32), 0, idm.shape[2] - 1)
    oid = idm[cur_id][iy, ix].astype(np.int32)
    has_obj = oid >= 0
    oid_c = np.clip(oid, 0, obj.shape[1] - 1)

    # object flow: translate with the center, rescale about it
    o_t = obj[cur_id][oid_c]                  # (gh, gw, 3) [sx, sy, ss]
    o_k = obj[key_id][oid_c]
    ratio = o_k[..., 2] / np.maximum(o_t[..., 2], 1e-6)
    ox = o_k[..., 0] + (px - o_t[..., 0]) * ratio
    oy = o_k[..., 1] + (py - o_t[..., 1]) * ratio

    tx = np.where(has_obj, ox, bx)
    ty = np.where(has_obj, oy, by)
    dx = tx - px
    dy = ty - py
    if flip:
        dx = -dx

    out = np.zeros((fh, fw, 2), np.float32)
    s = im_scale / stride                      # orig pixels -> feature cells
    out[:gh, :gw, 0] = dx * s
    out[:gh, :gw, 1] = dy * s
    return out


def substitute_gop_mv(mv, state, gop_start: int, im_scale: float,
                      stride: int, orig_hw) -> np.ndarray:
    """Replace a prepared-decode GOP's MV grids (N, fh, fw, 2) with the
    oracle grids referencing the GOP's key frame (position 0 stays zero —
    the key frame never warps)."""
    n, fh, fw, _ = mv.shape
    out = np.zeros_like(mv, dtype=np.float32)
    T = state["cam"].shape[0]
    for pos in range(1, n):
        if gop_start + pos >= T:
            break
        out[pos] = oracle_mv_grid(state, gop_start + pos, gop_start,
                                  fh, fw, im_scale, stride, orig_hw)
    return out
