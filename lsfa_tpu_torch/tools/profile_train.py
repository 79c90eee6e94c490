"""Attribute the port's train step time on one card.

The counterpart of the repo-level ``tools/profile_train.py``: the
flagship train step at its bucket, from seeded weights, split into
phases on the device (CUDA events, median of --reps calls after a
warm-up):

  fwd            forward_train alone, no gradient
  fwd_loss       + detection_losses (anchor assignment, proposals, roi
                 targets, PSROI, OHEM), no gradient
  grad           the loss's backward, no optimizer step

and by the host clock after ``synchronize``:

  full_step      the production step (make_train_step: backward, SGD,
                 scheduler), each step waited for
  chained_step   --steps steps back to back, waited for once: the per-step
                 time a training loop pays

``--trace DIR`` profiles 3 chained steps with ``torch.profiler``, writes a
Chrome trace into DIR and prints the top kernels by device time and the
device's busy share. Prints one JSON line. It runs on the card;
``--device cpu`` times with the host clock, and then every metric name
starts with ``cpu_smoke_``.

    python -m lsfa_tpu_torch.tools.profile_train [--batch 1] [--steps 8]
        [--reps N] [--trace DIR] [--height 608 --width 1024] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from lsfa_tpu_torch.bench import bench_config
from lsfa_tpu_torch.data.loader import batch_to_device
from lsfa_tpu_torch.models.layers import full_float32
from lsfa_tpu_torch.train.driver import build_model
from lsfa_tpu_torch.train.schedule import make_optimizer
from lsfa_tpu_torch.tools.bench_train import TRAIN_KEYS
from lsfa_tpu_torch.train.train_step import (DeviceConstants, TrainSettings, detection_losses,
                                             draw_uniforms, make_train_step)
from lsfa_tpu_torch.utils.profiler import labelled, profile_window, sync, timed_ms, tool_device


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="the train step's time by phase")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--trace", default=None, help="write a torch.profiler trace of 3 steps here")
    ap.add_argument("--height", type=int, default=None, help="default: the config's bucket")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--cfg", default=None, help="JSON config (default: the flagship)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(sys.argv[1:] if argv is None else list(argv))


def profile_batch(b, h, w, num_classes: int = 31) -> dict:
    """JAX's profiling batch (seed 0): raw BGR u8 frames, float32 MV and
    residual, 100 gt slots of which 5 are valid."""
    fh, fw = h // 16, w // 16
    rnd = np.random.default_rng(0)
    return {
        "data": rnd.integers(0, 255, (b, h, w, 3)).astype(np.uint8),
        "data_ref": rnd.integers(0, 255, (b, h, w, 3)).astype(np.uint8),
        "data_ref_old": rnd.integers(0, 255, (b, h, w, 3)).astype(np.uint8),
        "eq_flag": np.zeros((b,), np.float32),
        "eq_flag_old": np.zeros((b,), np.float32),
        "motion_vector": rnd.normal(0, 1.5, (b, fh, fw, 2)).astype(np.float32),
        "res_diff": rnd.normal(0, 8, (b, fh, fw, 3)).astype(np.float32),
        "im_info": np.tile(np.asarray([[600.0, 1000.0, 1.04]], np.float32), (b, 1)),
        "gt_boxes": np.concatenate([
            rnd.uniform(10, 300, (b, 100, 2)), rnd.uniform(320, 560, (b, 100, 2)),
            rnd.integers(1, num_classes - 1, (b, 100, 1)).astype(np.float64)],
            axis=2).astype(np.float32),
        "gt_valid": np.tile((np.arange(100) < 5)[None], (b, 1)),
    }


def main(argv=None) -> dict:
    """Time every phase; print and return the JSON result."""
    args = parse_args(argv)
    device = tool_device(args.device)
    cfg = bench_config(args.cfg)
    h = args.height or cfg.tpu.default_bucket[0]
    w = args.width or cfg.tpu.default_bucket[1]
    model = build_model(cfg, rng_seed=0, device=device)
    settings = TrainSettings.from_config(cfg)
    consts = DeviceConstants(settings, device)
    batch = batch_to_device(profile_batch(args.batch, h, w, cfg.dataset.NUM_CLASSES), device)
    draws = draw_uniforms(settings, batch, torch.Generator(device=device).manual_seed(7))
    optimizer, scheduler = make_optimizer(model, base_lr=1e-3, lr_steps=[10000])
    step = make_train_step(model, settings, optimizer, scheduler)
    model.train()

    def fwd():
        out = model.forward_train(*(batch[k] for k in TRAIN_KEYS))
        return sum(v.float().sum() for v in out.values())

    def fwd_loss():
        return detection_losses(model.forward_train(*(batch[k] for k in TRAIN_KEYS)), batch,
                                consts, draws, settings)[0]

    def grad():
        model.zero_grad(set_to_none=True)
        total = fwd_loss()
        with full_float32():
            total.backward()

    times = {}
    with torch.no_grad():
        times["fwd"] = timed_ms(fwd, device, args.reps)
        times["fwd_loss"] = timed_ms(fwd_loss, device, args.reps)
    times["grad"] = timed_ms(grad, device, args.reps)
    model.zero_grad(set_to_none=True)

    def host_ms(n, each):
        sync(device)
        t0 = time.perf_counter()
        for _ in range(n):
            step(batch, draws)
            if each:
                sync(device)
        sync(device)
        return (time.perf_counter() - t0) / n * 1e3

    host_ms(1, True)                                   # the optimizer's state
    times["full_step"] = host_ms(5, True)
    times["chained_step"] = host_ms(args.steps, False)
    for name, ms in times.items():
        print(f"{name:14s}: {ms:8.2f} ms", file=sys.stderr, flush=True)
    traced = None
    if args.trace:
        traced = profile_window(lambda: [step(batch, draws) for _ in range(3)], device,
                                args.trace)
        print(f"trace of 3 chained steps: {traced}", file=sys.stderr, flush=True)
    result = labelled({
        "metric": "lsfa_train_phase_ms",
        "unit": (f"ms per call: fwd, fwd_loss, grad by "
                 f"{'CUDA events' if device.type == 'cuda' else 'the host clock'} (median of "
                 f"{args.reps}); full_step (each waited for) and chained_step (x{args.steps}, "
                 f"waited for once) by the host clock; batch {args.batch}, {h}x{w}, "
                 f"{cfg.tpu.compute_dtype}, seeded weights"),
        "phases": times, "trace": traced,
        "images_per_s": args.batch / (times["chained_step"] / 1e3)},
        device, ("phases", "trace", "images_per_s"))
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
