"""Procedural VID-style synthetic dataset (no external data needed), a
copy of ``lsfa_tpu.data.synth`` over the port's ``data.coviar``: the same
seed gives the same clips, records and annotations. Encoding needs the
native library, so it raises on a machine without FFmpeg.

The environment has no ILSVRC2015; this generator produces the richest
stand-in the accuracy case can be built on (VERDICT round-2 item 1b,
round-3 item 2 "harden the synthetic benchmark"):
  * several visually distinct object classes (shape x color x texture),
  * independent bouncing motion + size oscillation over a textured,
    camera-panning background,
  * landscape AND portrait clips,
  * encoded to real MPEG-4 streams (fixed GOP) through the native
    encoder, so training/eval exercise the actual compressed-domain
    path: decoded frames, accumulated motion vectors and residuals.

Hard-mode knobs (all off by default; profile="hard" turns them on) give
the benchmark the failure modes real VID has, so per-module ablations
have headroom to separate:
  * n_distractors  — unannotated confuser objects: class shapes in
                     non-class colors AND class colors on a non-class
                     "blob" shape (hard negatives for the shape+color
                     classifier).
  * occluders      — textured moving bars painted OVER the objects;
                     boxes whose visible fraction drops below
                     `min_visibility` are dropped from the annotations
                     for that frame (the object genuinely can't be seen).
  * zoom           — sinusoidal camera zoom (block MVs can't express
                     scale change, so pure MV warping degrades and the
                     short-term small net has evidence to add back).
  * pan_speed      — faster camera pan + sinusoidal jitter.
  * size_range     — wider object scale variation.
  * motion_blur    — fast objects are painted as 3 sub-frame samples
                     (the classic degraded-appearance case long-term
                     aggregation exists to fix).
  * flicker        — global luminance oscillation (busier residuals;
                     appearance change between key frames).
  * bit_rate       — encoder bitrate; low rates give blocky, noisy
                     MV/residual streams.

Outputs use the same roidb/annotation shapes as data.dataset.ImageNetVID
so TrainLoader / eval_videos / vid_eval consume them unchanged.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from lsfa_tpu_torch.data import coviar

# class id (1-based; 0 = background) -> (shape, base BGR color)
# 8 classes, each separable by shape AND color
CLASS_STYLES = [
    ("disk", (60, 60, 220)),       # 1: red disk
    ("square", (70, 200, 70)),     # 2: green square
    ("triangle", (220, 80, 60)),   # 3: blue triangle
    ("ring", (50, 200, 230)),      # 4: yellow ring
    ("cross", (200, 60, 200)),     # 5: magenta cross
    ("diamond", (210, 210, 90)),   # 6: cyan diamond
    ("hstripe", (40, 140, 230)),   # 7: orange h-striped square
    ("vstripe", (160, 90, 40)),    # 8: navy v-striped square
]
NUM_SYNTH_CLASSES = len(CLASS_STYLES)

# distractor colors that belong to NO class (grays/browns)
DISTRACTOR_COLORS = [(128, 128, 128), (200, 200, 200), (60, 60, 60),
                     (90, 120, 150), (150, 150, 100)]

# the hardened-benchmark profile (documented knob set; see module docstring)
HARD_PROFILE = dict(
    min_objects=2, max_objects=5, n_distractors=3, occluders=2,
    zoom=0.15, pan_speed=3.0, size_range=(0.035, 0.20),
    motion_blur=True, flicker=0.08, speed=9.0, min_visibility=0.25,
    bit_rate=500_000,
)


def _background(w, h, rng, world_pad):
    """Textured background canvas covering the world plus `world_pad` on
    each side (the camera crops/zooms inside it)."""
    bw, bh = w + 2 * world_pad, h + 2 * world_pad
    # smooth low-frequency noise: coarse grid upsampled bilinearly
    coarse = rng.uniform(0, 60, (3, bh // 32 + 2, bw // 32 + 2))
    yy = np.linspace(0, coarse.shape[1] - 1.001, bh)
    xx = np.linspace(0, coarse.shape[2] - 1.001, bw)
    y0, x0 = yy.astype(int), xx.astype(int)
    fy, fx = (yy - y0)[:, None], (xx - x0)[None, :]
    tex = np.stack([
        (c[y0][:, x0] * (1 - fy) * (1 - fx) + c[y0 + 1][:, x0] * fy * (1 - fx)
         + c[y0][:, x0 + 1] * (1 - fy) * fx + c[y0 + 1][:, x0 + 1] * fy * fx)
        for c in coarse], axis=-1)
    base = rng.uniform(60, 120, 3)
    gx = np.linspace(0, rng.uniform(-30, 30), bw)[None, :, None]
    gy = np.linspace(0, rng.uniform(-30, 30), bh)[:, None, None]
    bg = np.clip(base + tex + gx + gy, 0, 235)
    return bg.astype(np.float32)


def _sample_background(bg, w, h, pad, cam_x, cam_y, z):
    """Bilinear crop of the canvas around world camera center (cam_x,
    cam_y) at zoom z (z > 1 magnifies). Screen pixel q maps to world
    point cam + (q - screen_center)/z."""
    xs = cam_x + (np.arange(w) - w / 2.0) / z + pad
    ys = cam_y + (np.arange(h) - h / 2.0) / z + pad
    xs = np.clip(xs, 0, bg.shape[1] - 1.001)
    ys = np.clip(ys, 0, bg.shape[0] - 1.001)
    x0, y0 = xs.astype(int), ys.astype(int)
    fx, fy = (xs - x0)[None, :, None], (ys - y0)[:, None, None]
    r0 = bg[y0][:, x0] * (1 - fx) + bg[y0][:, x0 + 1] * fx
    r1 = bg[y0 + 1][:, x0] * (1 - fx) + bg[y0 + 1][:, x0 + 1] * fx
    return r0 * (1 - fy) + r1 * fy


def _shape_mask(shape, xs, ys, s, blob_seed=0):
    """Boolean mask of `shape` with half-size s, on the (ys, xs) offset
    grids (pixel offsets from the object center)."""
    if shape == "disk":
        return xs ** 2 + ys ** 2 <= s ** 2
    if shape == "square":
        return (np.abs(xs) <= s) & (np.abs(ys) <= s)
    if shape == "triangle":
        return (ys >= -s) & (ys <= s) & (np.abs(xs) <= (s - ys) / 2 + 1)
    if shape == "ring":
        r2 = xs ** 2 + ys ** 2
        return (r2 <= s ** 2) & (r2 >= (0.55 * s) ** 2)
    if shape == "cross":
        third = max(s / 3.0, 2.0)
        return (((np.abs(xs) <= third) & (np.abs(ys) <= s))
                | ((np.abs(ys) <= third) & (np.abs(xs) <= s)))
    if shape == "diamond":
        return np.abs(xs) + np.abs(ys) <= s
    if shape == "hstripe":
        return ((np.abs(xs) <= s) & (np.abs(ys) <= s)
                & (((ys + s) // max(s / 2.5, 2)).astype(int) % 2 == 0))
    if shape == "vstripe":
        return ((np.abs(xs) <= s) & (np.abs(ys) <= s)
                & (((xs + s) // max(s / 2.5, 2)).astype(int) % 2 == 0))
    if shape == "blob":
        # lumpy radial blob: radius modulated by 3 harmonics (distractor
        # shape that matches NO class silhouette)
        ang = np.arctan2(ys, xs)
        k = blob_seed
        r = s * (0.75 + 0.18 * np.sin(3 * ang + k) + 0.12 * np.sin(5 * ang
                 + 2.1 * k) + 0.08 * np.sin(7 * ang + 3.7 * k))
        return xs ** 2 + ys ** 2 <= r ** 2
    raise ValueError(shape)


def _paint(frame, idmap, oid, shape, color, cx, cy, s, phase, alpha=1.0,
           blob_seed=0):
    """Paint one object at screen coords; blends with `alpha`, marks
    `idmap` with oid where it becomes the topmost owner. Returns the
    tight painted box [x1, y1, x2, y2] or None."""
    h, w = frame.shape[:2]
    x1 = max(int(np.floor(cx - s)), 0)
    y1 = max(int(np.floor(cy - s)), 0)
    x2 = min(int(np.ceil(cx + s)), w - 1)
    y2 = min(int(np.ceil(cy + s)), h - 1)
    if x2 <= x1 + 2 or y2 <= y1 + 2:
        return None
    ys = np.arange(y1, y2 + 1)[:, None] - cy
    xs = np.arange(x1, x2 + 1)[None, :] - cx
    mask = _shape_mask(shape, xs, ys, s, blob_seed)
    if not mask.any():
        return None
    # per-pixel shading so the residual/MV chain sees texture, not flats
    shade = 0.75 + 0.25 * np.sin((xs + ys) / 6.0 + phase)
    patch = frame[y1:y2 + 1, x1:x2 + 1]
    col = np.asarray(color, np.float32)[None, None, :] * shade[..., None]
    col = np.clip(col, 0, 255)
    if alpha >= 1.0:
        patch[mask] = col[mask]
    else:
        patch[mask] = (1 - alpha) * patch[mask] + alpha * col[mask]
    idmap[y1:y2 + 1, x1:x2 + 1][mask] = oid
    mys, mxs = np.nonzero(mask)
    return [float(x1 + mxs.min()), float(y1 + mys.min()),
            float(x1 + mxs.max()), float(y1 + mys.max())]


def render_video(w, h, n_frames, rng, min_objects=1, max_objects=3,
                 n_distractors=0, occluders=0, zoom=0.0, pan_speed=1.5,
                 size_range=(0.06, 0.16), motion_blur=False, flicker=0.0,
                 speed=5.0, min_visibility=1e-9, record_state=None):
    """Render one clip. Returns (frames (N,H,W,3) uint8 BGR,
    per-frame list of (box[4], class_id)). See module docstring for the
    hard-mode knobs; defaults reproduce the round-3 "easy" benchmark.

    record_state: optional dict to fill with the analytic per-frame
    motion state (the oracle-warp rung's ground truth — see
    data/oracle_flow.py): "cam" (T,3) [cam_x, cam_y, zoom],
    "obj" (T, n_obj, 3) [screen_cx, screen_cy, screen_size] and
    "idmap8" (T, ceil(h/8), ceil(w/8)) int8 object-id map (-2 bg,
    -1 occluder), all snapshotted AFTER occluder painting. Recording
    consumes no RNG draws, so a replay with the same rng reproduces the
    exact clip (the sidecar-state path for already-encoded datasets)."""
    # camera: linear pan + sinusoidal jitter, sinusoidal zoom
    pan = rng.uniform(-pan_speed, pan_speed, size=2)
    jit_amp = rng.uniform(0, pan_speed) if pan_speed > 1.6 else 0.0
    jit_T = rng.uniform(20, 50)
    zoom_T = rng.uniform(40, 80)
    zoom_phi = rng.uniform(0, 2 * np.pi)
    z_min = 1.0 / (1.0 + zoom)
    pan_max = (abs(pan) * n_frames).max() + jit_amp + 1
    pad = int(np.ceil((max(w, h) / 2.0) * (1.0 / z_min - 1.0) + pan_max)) + 4
    bg = _background(w, h, rng, pad)

    def make_obj(cls=None, shape=None, color=None):
        s0 = float(rng.uniform(*size_range) * min(w, h))
        return {
            "cls": cls, "shape": shape, "color": color, "s0": s0,
            "p": rng.uniform([s0 + 2, s0 + 2], [w - s0 - 2, h - s0 - 2]),
            "v": rng.uniform(-speed, speed, 2),
            "wob": float(rng.uniform(0, 2 * np.pi)),
            "phase": float(rng.uniform(0, 2 * np.pi)),
            "blob_seed": float(rng.uniform(0, 6.28)),
        }

    objs = []
    for _ in range(int(rng.integers(min_objects, max_objects + 1))):
        cls = int(rng.integers(1, NUM_SYNTH_CLASSES + 1))
        objs.append(make_obj(cls, CLASS_STYLES[cls - 1][0],
                             CLASS_STYLES[cls - 1][1]))
    # distractors: half class-shape/wrong-color, half blob/class-color
    for di in range(int(n_distractors)):
        if di % 2 == 0:
            shape = CLASS_STYLES[int(rng.integers(NUM_SYNTH_CLASSES))][0]
            color = DISTRACTOR_COLORS[int(rng.integers(len(DISTRACTOR_COLORS)))]
        else:
            shape = "blob"
            color = CLASS_STYLES[int(rng.integers(NUM_SYNTH_CLASSES))][1]
        objs.append(make_obj(None, shape, color))
    # occluders: textured moving bars, painted last (topmost)
    occs = []
    for _ in range(int(occluders)):
        horiz = bool(rng.integers(2))
        thick = float(rng.uniform(0.05, 0.12) * min(w, h))
        occs.append({
            "horiz": horiz, "thick": thick,
            "pos": float(rng.uniform(0.15, 0.85) * (h if horiz else w)),
            "v": float(rng.uniform(1.0, 4.0) * (1 if rng.integers(2) else -1)),
            "c0": np.asarray(DISTRACTOR_COLORS[int(rng.integers(
                len(DISTRACTOR_COLORS)))], np.float32),
        })

    frames = np.empty((n_frames, h, w, 3), np.uint8)
    annos = []
    idmap = np.empty((h, w), np.int32)
    if record_state is not None:
        record_state["cam"] = np.empty((n_frames, 3), np.float32)
        record_state["obj"] = np.empty((n_frames, len(objs), 3), np.float32)
        record_state["idmap8"] = np.empty(
            (n_frames, -(-h // 8), -(-w // 8)), np.int8)
    for t in range(n_frames):
        z = 1.0 + zoom * np.sin(2 * np.pi * t / zoom_T + zoom_phi)
        cam_x = w / 2.0 + pan[0] * t + jit_amp * np.sin(2 * np.pi * t / jit_T)
        cam_y = h / 2.0 + pan[1] * t + jit_amp * np.cos(2 * np.pi * t / jit_T)
        frame = _sample_background(bg, w, h, pad, cam_x, cam_y, z).copy()
        idmap.fill(-2)
        boxes = []          # (box, cls, oid)
        ideal = {}          # oid -> painted pixel count before occluders
        for oid, o in enumerate(objs):
            s = o["s0"] * (1.0 + 0.15 * np.sin(2 * np.pi * t / 36 + o["wob"]))
            # world -> screen
            sx = (o["p"][0] - cam_x) * z + w / 2.0
            sy = (o["p"][1] - cam_y) * z + h / 2.0
            ss = s * z
            fast = motion_blur and float(np.hypot(*o["v"])) * z > 6.0
            if fast:
                # 3 sub-frame samples along the motion; union box
                box = None
                for k, a in ((-0.33, 0.45), (0.33, 0.45), (0.0, 1.0)):
                    b = _paint(frame, idmap, oid, o["shape"], o["color"],
                               sx + o["v"][0] * z * k, sy + o["v"][1] * z * k,
                               ss, o["phase"], alpha=a,
                               blob_seed=o["blob_seed"])
                    if b is not None:
                        box = b if box is None else [
                            min(box[0], b[0]), min(box[1], b[1]),
                            max(box[2], b[2]), max(box[3], b[3])]
            else:
                box = _paint(frame, idmap, oid, o["shape"], o["color"],
                             sx, sy, ss, o["phase"],
                             blob_seed=o["blob_seed"])
            if record_state is not None:
                record_state["obj"][t, oid] = (sx, sy, ss)
            if box is not None and o["cls"] is not None:
                boxes.append((box, o["cls"], oid))
                ideal[oid] = int((idmap == oid).sum())
            # bounce physics (world coords)
            o["p"] += o["v"]
            for d, lim in ((0, w), (1, h)):
                if o["p"][d] < s + 1:
                    o["p"][d], o["v"][d] = s + 1, abs(o["v"][d])
                if o["p"][d] > lim - s - 1:
                    o["p"][d], o["v"][d] = lim - s - 1, -abs(o["v"][d])
        # occluders on top (screen-space bars; world-attached via camera)
        for oc in occs:
            axis_len = h if oc["horiz"] else w
            pos = ((oc["pos"] - (cam_y if oc["horiz"] else cam_x)
                    + (h if oc["horiz"] else w) / 2.0) * z) % (axis_len * 1.3)
            half = oc["thick"] * z / 2.0
            lo, hi = int(pos - half), int(pos + half)
            lo, hi = max(lo, 0), min(hi, axis_len)
            if hi > lo:
                stripes = ((np.arange(w if oc["horiz"] else h) // 8) % 2
                           ).astype(np.float32)
                fill = oc["c0"][None, :] * (0.8 + 0.4 * stripes[:, None])
                if oc["horiz"]:
                    frame[lo:hi, :] = np.clip(fill, 0, 255)[None, :, :]
                    idmap[lo:hi, :] = -1
                else:
                    frame[:, lo:hi] = np.clip(fill, 0, 255)[:, None, :]
                    idmap[:, lo:hi] = -1
            oc["pos"] += oc["v"]
        if record_state is not None:
            record_state["cam"][t] = (cam_x, cam_y, z)
            record_state["idmap8"][t] = idmap[::8, ::8].astype(np.int8)
        if flicker:
            frame *= 1.0 + flicker * np.sin(2 * np.pi * t / 17.0)
        frames[t] = np.clip(frame, 0, 255).astype(np.uint8)
        # annotations: drop boxes occluded below the visibility floor
        kept = []
        for box, cls, oid in boxes:
            vis = int((idmap == oid).sum())
            if ideal.get(oid, 0) > 0 and vis / ideal[oid] >= min_visibility:
                kept.append((box, cls))
        annos.append(kept)
    return frames, annos


def _gen_params(n_videos, n_frames, seed, sizes, gop_size, min_objects,
                max_objects, profile, split, knobs):
    """Resolve generator parameters + the cache tag. The tag must cover
    EVERY generator parameter: a partial key would silently serve cached
    clips of the wrong resolution/GOP/object count."""
    params = dict(HARD_PROFILE) if profile == "hard" else {}
    if profile == "hard":
        min_objects = params.pop("min_objects")
        max_objects = params.pop("max_objects")
    params.update(knobs)
    bit_rate = params.pop("bit_rate", None)
    size_tag = "x".join(f"{w}x{h}" for w, h in sizes)
    tag = (f"{split}_v{n_videos}_f{n_frames}_s{seed}_g{gop_size}"
           f"_o{min_objects}-{max_objects}_{size_tag}")
    if profile != "easy" or knobs:
        import hashlib
        kv = sorted({**params, "bit_rate": bit_rate}.items())
        tag += f"_{profile}_{hashlib.sha1(repr(kv).encode()).hexdigest()[:8]}"
    return params, bit_rate, min_objects, max_objects, tag


def make_synth_vid_dataset(out_dir, n_videos=8, n_frames=60, seed=0,
                           sizes=((960, 576), (576, 960)), gop_size=12,
                           min_objects=1, max_objects=3, split="train",
                           profile="easy", oracle=False, **knobs):
    """Generate videos + annotations. Returns (frame_roidb, video_roidb,
    annotations) where
      frame_roidb: one record per frame in TrainLoader's format,
      video_roidb: one record per video in eval_videos' format,
      annotations: {global_frame_idx -> {labels, boxes}} for vid_eval.
    profile="hard" applies HARD_PROFILE (distractors, occluders, camera
    zoom, motion blur, flicker, low-bitrate encode); explicit **knobs
    override either profile. Cached: videos + a .pkl of the annotations
    keyed by the generator parameters; re-calling with the same arguments
    reuses them.

    oracle=True additionally attaches the analytic per-frame motion state
    (render_video record_state) to every record as rec["oracle"] — the
    ground truth the oracle-warp rung substitutes for decoded MVs
    (data/oracle_flow.py). States live in a <tag>_state.pkl sidecar; for
    a dataset that was cached WITHOUT states, the generator loop is
    REPLAYED with the same seed (recording consumes no RNG draws, so the
    replayed state matches the encoded clips exactly — verified by
    tests/test_oracle_flow.py)."""
    os.makedirs(out_dir, exist_ok=True)
    params, bit_rate, min_objects, max_objects, tag = _gen_params(
        n_videos, n_frames, seed, sizes, gop_size, min_objects,
        max_objects, profile, split, knobs)
    cache = os.path.join(out_dir, f"{tag}.pkl")
    state_cache = os.path.join(out_dir, f"{tag}_state.pkl")
    states = None
    if os.path.exists(cache):
        with open(cache, "rb") as f:
            meta = pickle.load(f)
        if oracle:
            if os.path.exists(state_cache):
                with open(state_cache, "rb") as f:
                    states = pickle.load(f)
            else:
                # replay the exact generation loop, recording state but
                # skipping the encode (the only RNG consumer is
                # render_video, so draws line up with the cached clips)
                rng = np.random.default_rng(seed)
                states = []
                for vi in range(n_videos):
                    w, h = sizes[vi % len(sizes)]
                    st: dict = {}
                    render_video(w, h, n_frames, rng, min_objects,
                                 max_objects, record_state=st, **params)
                    states.append(st)
                with open(state_cache, "wb") as f:
                    pickle.dump(states, f,
                                protocol=pickle.HIGHEST_PROTOCOL)
    else:
        rng = np.random.default_rng(seed)
        meta = []
        states = []
        for vi in range(n_videos):
            w, h = sizes[vi % len(sizes)]
            st: dict = {}
            frames, annos = render_video(w, h, n_frames, rng,
                                         min_objects, max_objects,
                                         record_state=st, **params)
            vp = os.path.join(out_dir, f"{tag}_{vi:03d}.mp4")
            coviar.encode_frames(vp, frames, gop_size=gop_size,
                                 bit_rate=bit_rate)
            meta.append({"video_path": vp, "w": w, "h": h,
                         "annos": annos})
            states.append(st)
        with open(cache, "wb") as f:
            pickle.dump(meta, f, protocol=pickle.HIGHEST_PROTOCOL)
        # states are cheap to produce during generation — always write
        # the sidecar so a later oracle=True call needs no replay
        with open(state_cache, "wb") as f:
            pickle.dump(states, f, protocol=pickle.HIGHEST_PROTOCOL)
        if not oracle:
            states = None

    return synth_records(meta, states, out_dir, tag, n_frames)


def synth_records(meta, states, out_dir, tag, n_frames):
    """(frame_roidb, video_roidb, annotations) of the clips `meta` (one
    {video_path, w, h, annos} per video) and their oracle `states` (None:
    no "oracle" entries), as `make_synth_vid_dataset` returns them."""
    frame_roidb, video_roidb, annotations = [], [], {}
    gidx = 0
    for vi, m in enumerate(meta):
        video_roidb.append({
            "vid_path": f"synth/{tag}_{vi:03d}",
            "frame_seg_len": n_frames,
            "pattern": os.path.join(out_dir, "missing_%06d.JPEG"),
            "video_path": m["video_path"],
            "height": m["h"], "width": m["w"],
        })
        if states is not None:
            video_roidb[-1]["oracle"] = states[vi]
        for fid in range(n_frames):
            boxes = np.asarray([b for b, _ in m["annos"][fid]],
                               np.float32).reshape(-1, 4)
            classes = np.asarray([c for _, c in m["annos"][fid]], np.int32)
            frame_roidb.append({
                "image": m["video_path"],      # error-message placeholder
                "pattern": os.path.join(out_dir, "missing_%06d.JPEG"),
                "video_path": m["video_path"],
                "frame_seg_id": fid, "frame_seg_len": n_frames,
                "height": m["h"], "width": m["w"],
                "boxes": boxes, "gt_classes": classes,
                "flipped": False,
            })
            if states is not None:
                frame_roidb[-1]["oracle"] = states[vi]
            annotations[gidx] = {"labels": classes.astype(int),
                                 "boxes": boxes}
            gidx += 1
    return frame_roidb, video_roidb, annotations
