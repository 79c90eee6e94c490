"""Data-parallel dry run: the counterpart of ``tools/dryrun_multihost.py``.

Spawns `--nproc` processes (2 by default) on the CPU, joined by
``parallel.mesh.initialize_distributed`` (gloo, a free port of
127.0.0.1). Each holds one image of the tiny LSFA's global batch (seeded
synthetic batches) and runs 2 steps of ``train.driver.train_net``; then
the tiny LSFA with a train-mode BatchNorm variant takes one step on each
rank, which must raise NotImplementedError. In this process the same
model takes the same 2 steps on the whole batch. Checks: the metrics of
every step and the parameters after the last are identical across the
ranks, and equal to the single-process run's within 1e-5 relative
(parameters: of max(1, |value|); a batch of N and N batches of one sum
in other orders).

Prints one JSON line (the ranks' losses and parameter checksums, the
largest differences) and writes it to --out when given. Exits 0 when every
check holds.

Usage: python -m lsfa_tpu_torch.tools.dryrun_multihost [--nproc N] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import tempfile

STEPS = 2
HW = (64, 112)
TOL = 1e-5


def tiny_config(**network):
    """The tiny float32 LSFA (ResNet-18 trunk, feat 64) with small RPN and
    OHEM budgets, and `network` overrides."""
    from lsfa_tpu_torch.config import load_config

    path = os.path.join(os.path.dirname(__file__), "..", "configs", "lsfa_tiny_smoke.json")
    return load_config(path, overrides={
        "network": network,
        "TRAIN": {"RPN_POST_NMS_TOP_N": 64, "BATCH_ROIS_OHEM": 32, "RPN_BATCH_SIZE": 64},
        "tpu": {"max_gt_boxes": 8}})


def tiny_model(cfg):
    """The tiny LSFA on the CPU from seed 3, its RPN score and R-FCN heads
    redrawn at std 0.05 (at the N(0, 0.01) init their outputs are nearly
    uniform, and rounding between a batch of N and N of one could reorder
    proposals)."""
    import torch

    from lsfa_tpu_torch.train.driver import init_model

    model = init_model(cfg, rng_seed=3, device="cpu")
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for conv in (model.rpn_cls_score, model.rfcn_cls, model.rfcn_bbox):
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=g) * 0.05)
    return model


def train(model, cfg, n_images):
    """STEPS steps of train_net over global batches of n_images. Returns
    the metrics of each step as floats."""
    from lsfa_tpu_torch.data.loader import synthetic_train_batches
    from lsfa_tpu_torch.train.driver import train_net

    batches = synthetic_train_batches(STEPS, HW, seed=5, batch_images=n_images, max_gt=8,
                                      content_hw=(HW[0] - 4, HW[1] - 8))
    steps = []
    train_net(cfg, batches=batches, max_steps=STEPS, model=model, seed=0,
              metrics_hook=lambda step, m: steps.append({k: float(v) for k, v in m.items()}))
    return steps


def worker(rank: int, world: int, port: int, out_dir: str):
    import torch

    from lsfa_tpu_torch.parallel import mesh

    torch.set_num_threads(2)
    mesh.initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    try:
        cfg = tiny_config()
        model = tiny_model(cfg)
        steps = train(model, cfg, world)
        bn_cfg = tiny_config(res_diff_bn=True, small_net_bn_before_fuse=True)
        try:
            train(tiny_model(bn_cfg), bn_cfg, world)
            bn = "trained"
        except NotImplementedError:
            bn = "raised NotImplementedError"
        torch.save({"rank": rank, "world_size": mesh.world_size(), "steps": steps,
                    "backend": torch.distributed.get_backend(),
                    "state": model.state_dict(), "bn_variant": bn},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def checksum(state) -> float:
    return float(sum(v.double().abs().sum() for k, v in state.items()
                     if not k.endswith(("running_mean", "running_var"))))


def run(nproc: int = 2):
    """Spawn the ranks, run the single process, compare. Returns (report
    dict, the ranks' saved results, the single process's (steps, state))."""
    import torch
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as out_dir:
        mp.spawn(worker, args=(nproc, free_port(), out_dir), nprocs=nproc, join=True)
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=True)
                 for r in range(nproc)]
    cfg = tiny_config()
    model = tiny_model(cfg)
    single = (train(model, cfg, nproc), model.state_dict())

    first = ranks[0]
    same = all(r["steps"] == first["steps"] and r["state"].keys() == first["state"].keys()
               and all(torch.equal(r["state"][k], v) for k, v in first["state"].items())
               for r in ranks[1:])
    loss_err = max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-12)
                   for g, w in zip(first["steps"], single[0]) for k in w)
    param_err = max(float(((first["state"][k] - v).abs() / v.abs().clamp(min=1.0)).max())
                    for k, v in single[1].items() if v.is_floating_point())
    report = {
        "ok": bool(same and loss_err <= TOL and param_err <= TOL
                   and len(first["steps"]) == STEPS
                   and all(r["world_size"] == nproc for r in ranks)
                   and all(r["bn_variant"] == "raised NotImplementedError" for r in ranks)),
        "n_processes": nproc, "backend": first["backend"], "steps": STEPS,
        "ranks_identical": same, "max_rel_err_losses": loss_err,
        "max_rel_err_params": param_err,
        "workers": [{"rank": r["rank"], "world_size": r["world_size"],
                     "total_loss": [s["total_loss"] for s in r["steps"]],
                     "param_checksum": checksum(r["state"]), "bn_variant": r["bn_variant"]}
                    for r in ranks],
        "single_process": {"total_loss": [s["total_loss"] for s in single[0]],
                           "param_checksum": checksum(single[1])},
    }
    return report, ranks, single


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="multi-process dry run of data-parallel training")
    ap.add_argument("--nproc", type=int, default=2, help="processes (ranks)")
    ap.add_argument("--out", default=None, help="also write the JSON report here")
    args = ap.parse_args(argv)
    report, _, _ = run(args.nproc)
    line = json.dumps(report)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
