"""Data-parallel dry run: the counterpart of ``tools/dryrun_multihost.py``.

Spawns `--nproc` processes (2 by default) on the CPU, joined by
``parallel.mesh.initialize_distributed`` (gloo, a free port of
127.0.0.1). Each holds one image of the tiny LSFA's global batch (seeded
synthetic batches) and runs 2 steps of ``train.driver.train_net``, then
the same with the train-mode BatchNorm variant (`res_diff_bn` and
`small_net_bn_before_fuse`, whose batch statistics are the global
batch's). In this process the same models take the same steps on the
whole batch. Checks, for each model: the metrics of every step and the
parameters and running statistics after the last are identical across
the ranks, and equal to the single-process run's within 1e-5 relative
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


# the models each run trains: the plain tiny LSFA, and its train-mode
# BatchNorm variant
VARIANTS = {"plain": {}, "bn": {"res_diff_bn": True, "small_net_bn_before_fuse": True}}


def train_variants(world: int, names) -> dict:
    """{variant: (the metrics of each step, the state after the last)} of
    the variants `names`."""
    out = {}
    for name in names:
        cfg = tiny_config(**VARIANTS[name])
        model = tiny_model(cfg)
        out[name] = (train(model, cfg, world), model.state_dict())
    return out


def worker(rank: int, world: int, port: int, out_dir: str, names):
    import torch

    from lsfa_tpu_torch.parallel import mesh

    torch.set_num_threads(2)
    mesh.initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    try:
        runs = train_variants(world, names)
        torch.save({"rank": rank, "world_size": mesh.world_size(),
                    "backend": torch.distributed.get_backend(),
                    "steps": {k: v[0] for k, v in runs.items()},
                    "state": {k: v[1] for k, v in runs.items()}},
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


def compare(ranks, single, name):
    """(ranks identical, largest relative loss error, largest parameter
    error) of variant `name` against the single process's (steps, state)."""
    import torch

    first = ranks[0]
    steps, state = first["steps"][name], first["state"][name]
    same = all(r["steps"][name] == steps and r["state"][name].keys() == state.keys()
               and all(torch.equal(r["state"][name][k], v) for k, v in state.items())
               for r in ranks[1:])
    loss_err = max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-12)
                   for g, w in zip(steps, single[0]) for k in w)
    param_err = max(float(((state[k] - v).abs() / v.abs().clamp(min=1.0)).max())
                    for k, v in single[1].items() if v.is_floating_point())
    return same, loss_err, param_err


def run(nproc: int = 2, names=tuple(VARIANTS)):
    """Spawn the ranks, run the single process, compare, for the variants
    `names`. Returns (report dict, the ranks' saved results, the single
    process's {variant: (steps, state)})."""
    import torch
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as out_dir:
        mp.spawn(worker, args=(nproc, free_port(), out_dir, names), nprocs=nproc, join=True)
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=True)
                 for r in range(nproc)]
    single = train_variants(nproc, names)
    first = ranks[0]
    report = {"n_processes": nproc, "backend": first["backend"], "steps": STEPS}
    ok = all(r["world_size"] == nproc for r in ranks)
    for name in names:
        same, loss_err, param_err = compare(ranks, single[name], name)
        ok = ok and same and loss_err <= TOL and param_err <= TOL and len(
            first["steps"][name]) == STEPS
        suffix = "" if name == "plain" else "_" + name
        report.update({"ranks_identical" + suffix: same, "max_rel_err_losses" + suffix: loss_err,
                       "max_rel_err_params" + suffix: param_err})
    report.update({
        "ok": bool(ok),
        "workers": [{"rank": r["rank"], "world_size": r["world_size"],
                     **{f"total_loss_{n}": [s["total_loss"] for s in r["steps"][n]]
                        for n in names},
                     **{f"param_checksum_{n}": checksum(r["state"][n]) for n in names}}
                    for r in ranks],
        "single_process": {**{f"total_loss_{n}": [s["total_loss"] for s in single[n][0]]
                              for n in names},
                           **{f"param_checksum_{n}": checksum(single[n][1]) for n in names}},
    })
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
