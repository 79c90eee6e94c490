"""Train-step throughput of the port on one NVIDIA card.

The counterpart of the repo-level ``tools/bench_train.py``: the full train
step (forward, detection losses with anchor assignment, proposals, roi
targets and OHEM, backward, SGD) of the flagship LSFA at its bucket, on
one synthetic batch repeated every step (float32 MV and residual), from
seeded weights. ``--cfg configs/rfcn_resnet101_vid.json`` runs the
single-frame R-FCN step instead, the baseline LSFA is measured against.
``--remat`` recomputes the forward in the backward pass
(``torch.utils.checkpoint``). ``--tiny`` is JAX's CPU-sized config
(ResNet-18, feat 64, no DCN, float32, 64x96).

Prints one JSON line: steps/s, images/s, ms per step (host clock, each
step waited for), peak device memory (``max_memory_allocated`` after the
first step), and the first and last total loss. It runs on the card;
``--device cpu`` runs it on the CPU, and then every metric name starts
with ``cpu_smoke_``.

    python -m lsfa_tpu_torch.tools.bench_train [--batch N] [--steps K]
        [--remat] [--lr LR] [--tiny] [--cfg JSON] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from lsfa_tpu_torch.bench import bench_config, tiny_config
from lsfa_tpu_torch.data.loader import batch_to_device
from lsfa_tpu_torch.train.driver import build_model, is_rfcn
from lsfa_tpu_torch.train.schedule import make_optimizer
from lsfa_tpu_torch.train.train_step import TrainSettings, _make_step, draw_uniforms
from lsfa_tpu_torch.utils.profiler import labelled, sync, tool_device

TRAIN_KEYS = ("data", "data_ref", "data_ref_old", "eq_flag", "eq_flag_old", "motion_vector",
              "res_diff")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="train-step throughput of the port")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--remat", action="store_true",
                    help="recompute the forward in the backward (torch.utils.checkpoint)")
    # the same noise batch every step from random init: the recipe lr
    # (2.5e-4) without train_net's warm-up diverges within ~10 steps
    ap.add_argument("--lr", type=float, default=1e-5)
    ap.add_argument("--tiny", action="store_true",
                    help="resnet18/64ch at 64x96 (CPU-friendly smoke)")
    ap.add_argument("--cfg", default=None, help="JSON config (default: the flagship)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(sys.argv[1:] if argv is None else list(argv))


def train_config(args):
    """The flagship or --cfg, cut to JAX's --tiny sizes when asked."""
    cfg = bench_config(args.cfg)
    return tiny_config(cfg) if args.tiny else cfg


def synthetic_batch(cfg, b: int) -> dict:
    """The host batch of JAX's bench (seed 0, one gt box per image), with
    float32 MV and residual."""
    h, w = cfg.tpu.default_bucket
    fh, fw = h // 16, w // 16
    rnd = np.random.default_rng(0)
    gt = np.zeros((b, 8, 5), np.float32)
    gt[:, 0] = [10.0, 10.0, 120.0, 120.0, 1.0]
    gtv = np.zeros((b, 8), bool)
    gtv[:, 0] = True
    return {
        "data": rnd.integers(0, 255, (b, h, w, 3)).astype(np.float32),
        "data_ref": rnd.integers(0, 255, (b, h, w, 3)).astype(np.float32),
        "data_ref_old": rnd.integers(0, 255, (b, h, w, 3)).astype(np.float32),
        "eq_flag": np.zeros((b,), np.float32),
        "eq_flag_old": np.zeros((b,), np.float32),
        "motion_vector": rnd.normal(0, 1, (b, fh, fw, 2)).astype(np.float32),
        "res_diff": rnd.normal(0, 8, (b, fh, fw, 3)).astype(np.float32),
        "gt_boxes": gt, "gt_valid": gtv,
        "im_info": np.tile(np.asarray([[h, w, 1.0]], np.float32), (b, 1)),
    }


def build(args, cfg=None) -> dict:
    """The bench's parts: cfg (`train_config` of args unless given), model
    (seeded), settings, the step (step(batch, draws) -> metrics), the
    batch on the device and the generator of the draws."""
    device = tool_device(args.device)
    cfg = train_config(args) if cfg is None else cfg
    rfcn = is_rfcn(cfg)
    if args.remat and (cfg.network.res_diff_bn or cfg.network.small_net_bn_before_fuse):
        raise SystemExit("--remat with a train-mode BatchNorm would update its running "
                         "statistics twice (forward and recompute)")
    model = build_model(cfg, rng_seed=0, device=device)
    settings = TrainSettings.from_config(cfg)
    optimizer, scheduler = make_optimizer(model, base_lr=args.lr, lr_steps=[10000])
    if rfcn:
        forward = lambda b: model(b["data"])                                # noqa: E731
    else:
        forward = lambda b: model.forward_train(*(b[k] for k in TRAIN_KEYS))  # noqa: E731
    if args.remat:
        plain = forward
        forward = lambda b: checkpoint(plain, b, use_reentrant=False)       # noqa: E731
    step = _make_step(model, settings, optimizer, scheduler, forward)
    return {"cfg": cfg, "model": model, "settings": settings, "step": step, "rfcn": rfcn,
            "batch": batch_to_device(synthetic_batch(cfg, args.batch), device),
            "generator": torch.Generator(device=device).manual_seed(1), "device": device}


def main(argv=None) -> dict:
    """Run the bench; print and return its JSON result."""
    args = parse_args(argv)
    bench = build(args)
    dev, step, batch, gen = bench["device"], bench["step"], bench["batch"], bench["generator"]
    cfg, settings = bench["cfg"], bench["settings"]

    t0 = time.perf_counter()
    m = step(batch, draw_uniforms(settings, batch, gen))
    first_loss = float(m["total_loss"])
    print(f"first step: {time.perf_counter() - t0:.2f}s loss={first_loss:.3f}",
          file=sys.stderr, flush=True)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for _ in range(args.steps):
        m = step(batch, draw_uniforms(settings, batch, gen))
        sync(dev)
    dt = time.perf_counter() - t0
    sps = args.steps / dt
    h, w = cfg.tpu.default_bucket
    model_name = "R-FCN" if bench["rfcn"] else "LSFA"
    result = labelled({
        "metric": f"{'rfcn' if bench['rfcn'] else 'lsfa'}_train_steps_per_s",
        "value": sps,
        "unit": (f"train steps/sec, {model_name} {cfg.network.nettype}-"
                 f"{cfg.network.num_layer}{' with DCN' if cfg.network.add_dcn else ''}, "
                 f"{cfg.tpu.compute_dtype}, batch {args.batch}, {h}x{w}, remat={args.remat}, "
                 f"{args.steps} steps after one, each waited for (host clock), one synthetic "
                 f"batch"),
        "vs_baseline": None,
        "images_per_s": sps * args.batch,
        "ms_per_step": dt / args.steps * 1e3,
        "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda"
                     else None),
        "first_loss": first_loss,
        "last_loss": float(m["total_loss"]),
    }, dev, ("images_per_s", "ms_per_step", "peak_gib"))
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
