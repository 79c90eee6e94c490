"""Content dependence of the prepared decode (host only, no card).

The counterpart of the repo-level ``tools/bench_decode.py``: the port's
``PreparedVideo.gop`` (the native decoder of ``data/coviar.py`` with the
flagship config) over clips that span the difficulty range, since MPEG-4
decode cost depends on content:

  easy   the bench clip (smooth gradient and 2 moving squares, seed 3)
  synth  the training generator's scenes (``data/synth.py``: textured
         background, 3 moving objects)
  hard   textured patches moving over a textured background with sensor
         noise: dense motion vectors and residual energy, the worst case

Prints one JSON line: per clip the ms per frame (median of --passes
sweeps over the clip), kbit per frame and the per-stage breakdown of
``VideoReader.prof_read``. The clips are written to a temporary
directory. Where the native library does not load (it needs FFmpeg's
libraries), it raises, naming the library. Run on an idle host.

    python -m lsfa_tpu_torch.tools.bench_decode [--width W --height H]
        [--gops N] [--passes N] [clip.mp4 ...]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

from lsfa_tpu_torch.config import get_default_config
from lsfa_tpu_torch.data import coviar
from lsfa_tpu_torch.data.loader import GOP_SIZE, PreparedVideo
from lsfa_tpu_torch.utils.profiler import device_info


def make_hard_clip(path, w, h, n):
    """6 textured 96x96 patches on looping diagonal tracks over a textured
    background, with per-frame noise of +-8."""
    rng = np.random.default_rng(11)
    p = min(96, h // 2, w // 2)
    base = rng.integers(0, 255, (h, w, 3)).astype(np.uint8)
    patches = [rng.integers(0, 255, (p, p, 3)).astype(np.uint8) for _ in range(6)]
    starts = rng.integers(0, max(1, min(h, w) - p), (6, 2))
    vels = rng.integers(-7, 8, (6, 2))
    frames = np.empty((n, h, w, 3), np.uint8)
    for t in range(n):
        f = base.copy()
        for patch, (sy, sx), (vy, vx) in zip(patches, starts, vels):
            y = int(sy + vy * t) % (h - p)
            x = int(sx + vx * t) % (w - p)
            f[y:y + p, x:x + p] = patch
        noise = rng.integers(-8, 9, (h, w, 3))
        frames[t] = np.clip(f.astype(np.int16) + noise, 0, 255)
    coviar.encode_frames(path, frames, gop_size=GOP_SIZE)


def make_synth_clip(path, w, h, n):
    from lsfa_tpu_torch.data.synth import render_video

    frames, _ = render_video(w, h, n, np.random.default_rng(5), min_objects=3, max_objects=3)
    coviar.encode_frames(path, np.asarray(frames, np.uint8), gop_size=GOP_SIZE)


def measure(path, passes: int) -> dict:
    """ms per frame (median of `passes` sweeps), kbit per frame and the
    decoder's per-stage ms per frame over one clip."""
    cfg = get_default_config()
    pv = PreparedVideo(path, cfg, tuple(cfg.tpu.default_bucket))
    n_gops = pv.num_frames // GOP_SIZE
    pv.gop(0)                                 # one-time FFmpeg warm-up
    pv.reader.prof_read()
    times = []
    for _ in range(passes):
        pv._gop = -1
        t0 = time.perf_counter()
        for g in range(n_gops):
            pv.gop(g)
            pv._gop = -1
        times.append((time.perf_counter() - t0) / (n_gops * GOP_SIZE) * 1e3)
    nf = n_gops * GOP_SIZE * passes
    # zero-valued stages stay: "frame_to_bgr 0.0" is what the direct-YUV
    # paths exist to show
    stages = {k: v / nf * 1e3 for k, v in pv.reader.prof_read().items()}
    return {"ms_per_frame": float(np.median(times)),
            "kbit_per_frame": os.path.getsize(path) * 8 / (n_gops * GOP_SIZE) / 1000,
            "stages_ms_per_frame": stages}


def main(argv=None) -> dict:
    """Encode and time the three clips (and any given); print and return
    the JSON result."""
    ap = argparse.ArgumentParser(description="prepared-decode cost by clip content")
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=576)
    ap.add_argument("--gops", type=int, default=12)
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("clips", nargs="*", help="more MPEG-4 clips to time")
    args = ap.parse_args(sys.argv[1:] if argv is None else list(argv))
    if not coviar.available():
        raise RuntimeError(coviar.MISSING)
    w, h, n = args.width, args.height, args.gops * GOP_SIZE
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        easy = os.path.join(tmp, "easy.mp4")
        coviar.encode_test_video(easy, n_frames=n, w=w, h=h, gop_size=GOP_SIZE, seed=3)
        synth = os.path.join(tmp, "synth.mp4")
        make_synth_clip(synth, w, h, n)
        hard = os.path.join(tmp, "hard.mp4")
        make_hard_clip(hard, w, h, n)
        clips = {"easy (bench clip)": easy, "synth (3-object scenes)": synth,
                 "hard (texture+noise)": hard}
        clips.update({os.path.basename(c): c for c in args.clips})
        for name, path in clips.items():
            results[name] = measure(path, args.passes)
            print(f"{name:28s}: {results[name]['ms_per_frame']:6.2f} ms/f "
                  f"({results[name]['kbit_per_frame']:7.0f} kbit/frame)", file=sys.stderr,
                  flush=True)
    result = {"metric": "prepared_decode_ms_per_frame",
              "unit": (f"host ms per frame of PreparedVideo.gop at the flagship bucket, "
                       f"{w}x{h} clips of {n} frames, median of {args.passes} sweeps"),
              "clips": results, "device": device_info("cpu")}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
