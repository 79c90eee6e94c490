"""Self-supervised photometric pretraining of FlowNet-S on synthetic VID;
the counterpart of ``tools/pretrain_flow.py``.

The reference never trains FlowNet from scratch: it merges a
FlyingChairs-pretrained FlowNet into the detector before end-to-end
training (dff_rfcn/train_end2end.py:111-115). No such file is in this
environment, so this tool makes the stand-in: ``models.flownet.FlowNetS``
alone, trained under Adam on frame pairs of synthetic videos with

    L = mean|flow_warp(pool16(old), flow) - pool16(cur)| + lam_tv * TV(flow)

where pool16 is the 16x16 block mean of the RGB frame (the stride-16 grid
the flow is applied on) and TV the mean absolute difference of the flow
along each axis. Pairs are drawn at GOP-scale offsets (1..12 frames), in
the JAX tool's order from ``np.random.default_rng(0)``; one group per
frame orientation, taken in turn. The scale-map head gets no gradient and
keeps its constant-1 init: torch's Adam skips a parameter without a
gradient, where optax steps it by zero.

Output: ``<out>/<steps>.pt``, a checkpoint of this package whose model
entries are ``flownet.*`` (read by ``init_model`` through
network.pretrained_flow), and ``<out>/flow_pretrain.json`` (steps,
photo_first, photo_final, wall_s, out).

Usage:
  python -m lsfa_tpu_torch.tools.pretrain_flow [--steps 1500] [--out DIR]
      [--data DIR] [--cpu-smoke] [--device cpu]

It runs on the card unless given --cpu-smoke (tiny shapes: 128x96 frames,
2 videos of 24 frames, batch 2, feat_dim 32) or --device cpu. The videos
are written by ``data.synth.make_synth_vid_dataset`` and read with the
native decoder; `main` takes `open_video`, a callable that opens a reader
(``get_num_frames``, ``load``) of a path, in place of both: the paths are
then the ones the dataset would write, and nothing is encoded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
from torch import nn

from lsfa_tpu_torch.data.loader import GOP_SIZE

SIZES = ((960, 576), (576, 960))          # (width, height) of the videos, in turn
SMOKE_SIZES = ((128, 96),)


def pool16(x):
    """16x16 block mean of NHWC x."""
    b, h, w, c = x.shape
    return x.reshape(b, h // 16, 16, w // 16, 16, c).mean(dim=(2, 4))


def photometric_loss(model, cur, old, lam_tv: float):
    """(loss, photo) of FlowNet-S `model` on RGB float32 NHWC frame
    batches cur and old."""
    from lsfa_tpu_torch.ops.warp import flow_warp

    flow, _ = model(cur.permute(0, 3, 1, 2), old.permute(0, 3, 1, 2))
    flow = flow.permute(0, 2, 3, 1)
    photo = (flow_warp(pool16(old), flow) - pool16(cur)).abs().mean()
    tv = ((flow[:, 1:] - flow[:, :-1]).abs().mean()
          + (flow[:, :, 1:] - flow[:, :, :-1]).abs().mean())
    return photo + lam_tv * tv, photo


def make_step(model, lr: float, lam_tv: float):
    """step(cur, old) -> (loss, photo) device scalars: one
    Adam step (torch's defaults, optax's: b1 0.9, b2 0.999, eps 1e-8 after
    the square root) on `photometric_loss`."""
    optimizer = torch.optim.Adam(model.parameters(), lr=lr)

    def step(cur, old):
        optimizer.zero_grad(set_to_none=True)
        loss, photo = photometric_loss(model, cur, old, lam_tv)
        loss.backward()
        optimizer.step()
        return loss.detach(), photo.detach()

    return step


def draw_batch(readers, rng: np.random.Generator, batch: int, hw):
    """(cur, old) (batch, h, w, 3) float32 RGB: for each row a reader of
    the group, a current frame in [1, n) and an offset in [1, 13) drawn
    from rng in that order; the old frame is the current one less the
    offset, at least frame 0."""
    h, w = hw
    cur = np.empty((batch, h, w, 3), np.float32)
    old = np.empty((batch, h, w, 3), np.float32)
    for i in range(batch):
        reader = readers[rng.integers(len(readers))]
        n = reader.get_num_frames()
        cur_id = int(rng.integers(1, n))
        off = int(rng.integers(1, 13))
        for out, fid in ((cur, cur_id), (old, max(cur_id - off, 0))):
            # BGR -> RGB; the ResNet pixel statistics (means 0, scale 1)
            out[i] = reader.load(fid // GOP_SIZE, fid % GOP_SIZE, 0)[..., ::-1]
    return cur, old


def video_paths(data: str, n_videos: int, n_frames: int, sizes, profile: str):
    """The paths ``make_synth_vid_dataset`` writes its videos to for these
    arguments (seed 0, train split)."""
    from lsfa_tpu_torch.data.synth import _gen_params

    tag = _gen_params(n_videos, n_frames, 0, sizes, GOP_SIZE, 1, 3, profile, "train", {})[-1]
    return [os.path.join(data, f"{tag}_{vi:03d}.mp4") for vi in range(n_videos)]


def main(argv=None, open_video=None, report: dict | None = None) -> int:
    """Train and save; returns 0. report: filled with the logged steps'
    (step, loss, photo), the seconds of the steps, the checkpoint's
    directory and the model."""
    ap = argparse.ArgumentParser(description="photometric pretraining of FlowNet-S")
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--lam-tv", type=float, default=0.01)
    ap.add_argument("--out", default="lsfa_flow_ckpt")
    ap.add_argument("--data", default="lsfa_synth_data")
    ap.add_argument("--videos", type=int, default=30)
    ap.add_argument("--frames", type=int, default=72)
    ap.add_argument("--profile", default="hard", choices=["easy", "hard"])
    ap.add_argument("--feat-dim", type=int, default=1024)
    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--cpu-smoke", action="store_true",
                    help="tiny shapes on the CPU (a smoke of this tool)")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from lsfa_tpu_torch.data.loader import open_native_video
    from lsfa_tpu_torch.models.flownet import FlowNetS
    from lsfa_tpu_torch.models.lsfa import init_params, resolve_device
    from lsfa_tpu_torch.train.checkpoint import save_checkpoint

    sizes = SIZES
    if args.cpu_smoke:
        sizes = SMOKE_SIZES
        args.videos, args.frames, args.batch, args.feat_dim = 2, 24, 2, 32
        args.device = "cpu"
    device = resolve_device(args.device)
    if open_video is None:
        from lsfa_tpu_torch.data.synth import make_synth_vid_dataset

        roidb, _, _ = make_synth_vid_dataset(
            args.data, n_videos=args.videos, n_frames=args.frames, seed=0, sizes=sizes,
            split="train", profile=args.profile)
        paths = sorted({r["video_path"] for r in roidb})
        open_video = open_native_video
    else:
        paths = sorted(video_paths(args.data, args.videos, args.frames, sizes, args.profile))
    # one group per frame orientation, in the order the videos first show it
    groups: dict = {}
    for p in paths:
        reader = open_video(p)
        groups.setdefault(reader.load(0, 0, 0).shape[:2], []).append(reader)

    model = FlowNetS(feat_dim=args.feat_dim, device=device)
    init_params(model, torch.Generator(device=device).manual_seed(0))
    step = make_step(model, args.lr, args.lam_tv)
    rng = np.random.default_rng(0)
    shapes = list(groups)
    logged = []
    t0 = time.perf_counter()
    for i in range(args.steps):
        hw = shapes[i % len(shapes)]
        cur, old = draw_batch(groups[hw], rng, args.batch, hw)
        loss, photo = step(torch.from_numpy(cur).to(device), torch.from_numpy(old).to(device))
        if i % args.log_every == 0 or i == args.steps - 1:
            logged.append((i, float(loss), float(photo)))
            print(f"step {i}: loss {logged[-1][1]:.4f} photo {logged[-1][2]:.4f} "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
    wall = time.perf_counter() - t0

    # the weights only, as the JAX tool saves them
    save_checkpoint(args.out, args.steps, nn.ModuleDict({"flownet": model}), None, None,
                    step=args.steps, rng_state=None)
    out = {"steps": args.steps, "photo_first": round(logged[0][2], 4),
           "photo_final": round(logged[-1][2], 4), "wall_s": round(wall, 1), "out": args.out}
    print(json.dumps(out))
    with open(os.path.join(args.out, "flow_pretrain.json"), "w") as f:
        json.dump(out, f, indent=1)
    if report is not None:
        report.update(logged=logged, seconds=wall, out=args.out, model=model)
    return 0


if __name__ == "__main__":
    sys.exit(main())
