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

The tensor-parallel counterpart (`run_tp`, no command line: the tests and
``chip_smoke.py`` phase 38 call it): ranks in one gloo group shard an
LSFA's head stack (``parallel.tensor_parallel``) over ("data", "model")
meshes and run forward_key, forward_cur over a batch split on "data",
the gradient of a seeded functional of forward_key's maps or
StreamingDetector over GOPs; `tp_reference` runs the unsharded model in
this process, and `tp_report` holds every rank's maps and gradients
against it and its shards against the full weights.

The lanes counterpart (`run_lanes`, no command line: ``entry.
dryrun_multichip``, the tests and ``chip_smoke.py`` phase 39 call it):
ranks in one gloo group split the lockstep lanes of
``eval.driver.eval_videos_lanes(over_ranks=True)``, on the CPU or on
one card that they share.

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


# ----------------------------------------------------------------------
# tensor parallelism of the head stack

TP_HW = (64, 96)
# the tiny LSFA of the JAX package's tensor-parallel test: ResNet-18, feat
# 64, no DCN, 5 classes, float32
TP_OVERRIDES = {"network": {"add_dcn": False}, "dataset": {"NUM_CLASSES": 5}}
TP_REL = 1e-5
# a replicated parameter whose gradient reaches it through the gather
TP_GRAD_REPLICATED = "backbone.conv0.weight"


def tp_model(job, dtype):
    """(config, model) of a `run_tp` job at compute dtype `dtype`, its
    weights loaded, in eval mode on the job's device."""
    from lsfa_tpu_torch.config import load_config
    from lsfa_tpu_torch.models.lsfa import lsfa_from_config

    ov = job["overrides"]
    cfg = load_config(job["cfg_path"], overrides={
        **ov, "tpu": {**ov.get("tpu", {}), "compute_dtype": dtype}})
    model = lsfa_from_config(cfg, device=job["device"])
    model.load_state_dict(job["state"], strict=True)
    return cfg, model.eval()


def tp_probe(shape, seed, device):
    """The seeded weights of one map in the functional `tp_outputs`
    differentiates."""
    import torch

    return torch.randn(shape, generator=torch.Generator().manual_seed(seed)).to(device)


def tp_outputs(model, cfg, job, data_rank=0, n_data=1):
    """What one rank computes with `model` (sharded or not) on the job's
    inputs, on the host in float32: "key", forward_key's maps for each
    input; "cur", forward_cur's on the rank's rows of the global batch
    (`mesh.shard_batch` over n_data); "shards", the parameters of the five
    head-stack modules; with job["grad"], "grads": the gradients of those
    parameters and of TP_GRAD_REPLICATED, of the sum of forward_key's maps
    on the first input weighted by `tp_probe`; with job["stream"],
    "stream": StreamingDetector's detections over its payloads."""
    import torch

    from lsfa_tpu_torch.eval.tester import StreamingDetector
    from lsfa_tpu_torch.parallel.mesh import shard_batch
    from lsfa_tpu_torch.parallel.tensor_parallel import TP_IN_MODULES, TP_OUT_MODULES

    dev = next(model.parameters()).device

    def host(maps):
        return {k: v.detach().float().cpu() for k, v in maps.items()}

    def key(args):
        return model.forward_key(*(a.to(dev) for a in args))

    heads = TP_OUT_MODULES + TP_IN_MODULES
    out = {"shards": {n: p.detach().float().cpu() for n, p in model.named_parameters()
                      if n.split(".")[0] in heads}}
    with torch.no_grad():
        out["key"] = [host(key(args)) for args in job["key"]]
        if job.get("cur") is not None:
            names = ("small", "feat_key", "motion_vector", "res_diff")
            rows = shard_batch(dict(zip(names, job["cur"])), data_rank, n_data)
            out["cur"] = host(model.forward_cur(*(rows[k].to(dev) for k in names)))
    if job.get("grad"):
        model.zero_grad(set_to_none=True)
        maps = key(job["key"][0])
        loss = sum((maps[k].float() * tp_probe(maps[k].shape, i, dev)).sum()
                   for i, k in enumerate(sorted(maps)))
        loss.backward()
        out["grads"] = {n: p.grad.float().cpu() for n, p in model.named_parameters()
                        if n in out["shards"] or n == TP_GRAD_REPLICATED}
        model.zero_grad(set_to_none=True)
    if job.get("stream") is not None:
        det = StreamingDetector(model, cfg, job["stream"]["hw"])
        payloads = [tuple(a.numpy() for a in p) for p in job["stream"]["payloads"]]
        with torch.no_grad():
            out["stream"] = [o.cpu() for o in det.process_prepared_window(payloads, first=True)]
    return out


def tp_key(shape, dtype) -> str:
    return f"{shape[0]}x{shape[1]}/{dtype}"


def tp_worker(rank: int, world: int, port: int, job_path: str, out_dir: str):
    """One rank of `run_tp`: for each mesh of the job and each compute
    dtype, the model sharded over "model" (`shard_params`) and its
    `tp_outputs` on the rank's "data" rows, saved to out_dir."""
    import torch

    from lsfa_tpu_torch.parallel import mesh
    from lsfa_tpu_torch.parallel.tensor_parallel import (make_tp_mesh, shard_params,
                                                         tensor_parallel_specs)

    job = torch.load(job_path, weights_only=True)
    torch.set_num_threads(job["threads"])
    # gloo on either device: NCCL refuses two ranks on one card
    mesh.initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    try:
        out = {}
        for n_data, n_model in job["meshes"]:
            dm = make_tp_mesh(n_model, n_data)
            coord = (dm.get_local_rank("data"), dm.get_local_rank("model"))
            for dtype in job["dtypes"]:
                cfg, model = tp_model(job, dtype)
                shard_params(dm, model, tensor_parallel_specs(model))
                out[tp_key((n_data, n_model), dtype)] = {
                    "coord": coord, **tp_outputs(model, cfg, job, coord[0], n_data)}
                del model
        torch.save(out, os.path.join(out_dir, f"tp_rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def run_tp(job: dict, nproc: int) -> list:
    """Spawn `nproc` ranks of `tp_worker` on `job` and return each rank's
    {tp_key(mesh, dtype): {"coord": (data, model), **tp_outputs}}.

    job: "cfg_path" (None: the defaults) and "overrides", the port's
    config; "state", the float32 state dict; "device"; "dtypes", the
    compute dtypes; "meshes", (n_data, n_model) shapes of nproc ranks;
    "key", forward_key argument tuples; "cur", forward_cur's arguments (a
    global batch) or None; "grad"; "stream", {"payloads", "hw"} or None;
    "threads", torch threads per rank. Every array is a CPU tensor."""
    import torch
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        job_path = os.path.join(tmp, "job.pt")
        torch.save(job, job_path)
        mp.spawn(tp_worker, args=(nproc, free_port(), job_path, tmp), nprocs=nproc, join=True)
        return [torch.load(os.path.join(tmp, f"tp_rank{r}.pt"), weights_only=True)
                for r in range(nproc)]


def tp_reference(job: dict) -> dict:
    """{dtype: tp_outputs} of the unsharded model on the job, in this
    process."""
    out = {}
    for dtype in job["dtypes"]:
        cfg, model = tp_model(job, dtype)
        out[dtype] = tp_outputs(model, cfg, job)
    return out


def rel_err(got, want) -> float:
    """max |got - want| over the largest |want|."""
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def expected_shard(state, name, coord_model, n_model):
    """The slice of the full weight `name` that model rank `coord_model`
    of n_model holds."""
    from lsfa_tpu_torch.parallel.tensor_parallel import TP_OUT_MODULES

    w = state[name]
    if name.split(".")[0] in TP_OUT_MODULES:
        c = w.shape[0] // n_model
        return w[coord_model * c:(coord_model + 1) * c]
    if w.ndim == 4:
        c = w.shape[1] // n_model
        return w[:, coord_model * c:(coord_model + 1) * c]
    return w


def torch_equal(a, b) -> bool:
    import torch

    return a.shape == b.shape and bool(torch.equal(a, b.to(a.dtype)))


def tp_report(ranks, ref, job) -> dict:
    """The ranks of `run_tp` against `tp_reference`: for each mesh and
    dtype, the largest error of the maps (key and cur) and of the
    gradients over each one's largest |value|, and whether every shard
    is the rank's slice of the job's weights. "ok" when every shard is
    and every error is within TP_REL."""
    report, ok = {}, True
    for k in ranks[0]:
        dtype = k.split("/")[1]
        n_data, n_model = (int(x) for x in k.split("/")[0].split("x"))
        want = ref[dtype]
        maps = grads = 0.0
        shards = True
        for r in ranks:
            got = r[k]
            d, m = got["coord"]
            for g, w in zip(got["key"], want["key"]):
                maps = max(maps, *(rel_err(g[n], w[n]) for n in w))
            if "cur" in got:
                b = next(iter(want["cur"].values())).shape[0] // n_data
                maps = max(maps, *(rel_err(got["cur"][n], w[d * b:(d + 1) * b])
                                   for n, w in want["cur"].items()))
            shards = shards and all(
                torch_equal(s, expected_shard(job["state"], n, m, n_model))
                for n, s in got["shards"].items())
            for n, g in got.get("grads", {}).items():
                full = want["grads"][n]
                part = full if n not in got["shards"] else expected_shard(
                    {n: full}, n, m, n_model)
                grads = max(grads, rel_err(g, part))
        report[k] = {"maps_rel_err": maps, "grads_rel_err": grads, "shards_are_slices": shards}
        ok = ok and shards and maps <= TP_REL and grads <= TP_REL
    report["ok"] = bool(ok)
    return report


def tiny_tp_job(meshes, grad=True, stream_gops=0) -> dict:
    """A `run_tp` job on the tiny LSFA (TP_OVERRIDES) on the CPU: weights
    `tiny_model` draws from seed 3, seeded inputs at TP_HW: forward_key
    with is_first 0 and 1, forward_cur over a batch of 2 and, with
    stream_gops, that many SyntheticPreparedVideo GOPs."""
    import numpy as np
    import torch

    from lsfa_tpu_torch.config import load_config
    from lsfa_tpu_torch.data.loader import SyntheticPreparedVideo

    path = os.path.join(os.path.dirname(__file__), "..", "configs", "lsfa_tiny_smoke.json")
    cfg = load_config(path, overrides=TP_OVERRIDES)
    model = tiny_model(cfg)
    h, w = TP_HW
    fh, fw, feat = h // 16, w // 16, cfg.network.DFF_FEAT_DIM
    rng = np.random.default_rng(7)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    data = t(rng.integers(0, 256, (1, h, w, 3), dtype=np.uint8))
    prev = t(rng.normal(0, 60, (1, h, w, 3)).astype(np.float32))
    old = t(rng.normal(0, 1, (1, fh, fw, feat)).astype(np.float32))
    cur = (t(rng.integers(0, 256, (2, h // 4, w // 4, 3), dtype=np.uint8)),
           t(rng.normal(0, 1, (2, fh, fw, feat)).astype(np.float32)),
           t(rng.normal(0, 1.5, (2, fh, fw, 2)).astype(np.float32)),
           t(rng.normal(0, 8, (2, fh, fw, 3)).astype(np.float32)))
    stream = None
    if stream_gops:
        pv = SyntheticPreparedVideo("tp", cfg, TP_HW, num_frames=12 * stream_gops, seed=5,
                                    content_hw=(h - 4, w - 8), im_scale=0.5)
        stream = {"hw": TP_HW, "payloads": [tuple(t(a) for a in pv.gop(g))
                                            for g in range(stream_gops)]}
    return {"cfg_path": path, "overrides": TP_OVERRIDES, "state": model.state_dict(),
            "device": "cpu", "dtypes": ("float32",), "meshes": tuple(meshes),
            "key": [(data, prev, old, torch.zeros(1)), (data, prev, old, torch.ones(1))],
            "cur": cur, "grad": grad, "stream": stream, "threads": 1}


def lanes_worker(rank: int, world: int, port: int, job_path: str, out_dir: str):
    """One rank of `run_lanes`: the job's model on its device through
    ``eval.driver.eval_videos_lanes(over_ranks=True)``, the rank's result
    saved to out_dir."""
    import logging
    import time

    import torch

    from lsfa_tpu_torch.eval.driver import eval_videos_lanes
    from lsfa_tpu_torch.models.lsfa import lsfa_from_config
    from lsfa_tpu_torch.parallel import mesh
    from lsfa_tpu_torch.utils.profiler import sync, tracing

    job = torch.load(job_path, weights_only=False)
    torch.set_num_threads(job["threads"])
    dev = torch.device(job["device"])
    # gloo on either device: NCCL refuses two ranks on one card
    mesh.initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    try:
        cfg = job["cfg"]
        model = lsfa_from_config(cfg, device=dev)
        model.load_state_dict(job["state"])

        def run():
            stats = []
            dets = eval_videos_lanes(model.eval(), cfg, job["records"], job["lanes"],
                                     logger=logging.getLogger(__name__), over_ranks=True,
                                     open_video=job["open_video"], stats=stats)
            return dets, stats

        # on a card, an untimed pass first: cuDNN's first use of the shapes
        passes = 2 if dev.type == "cuda" else 1
        with tracing() as rec:
            for _ in range(passes - 1):
                run()
            sync(dev)
            t0 = time.perf_counter()
            dets, stats = run()
            sync(dev)
        torch.save({"dets": dets, "stats": stats,
                    "launches": rec.counters.get("nms.launches", 0),
                    "passes": passes, "seconds": time.perf_counter() - t0},
                   os.path.join(out_dir, f"lanes_rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def run_lanes(job: dict, nproc: int, timeout: float = 900.0) -> list:
    """Spawn `nproc` ranks of `lanes_worker` on `job` and return, for each
    rank, {"dets": its `eval_videos_lanes` mapping (rank 0's holds every
    rank's frames), "stats": that call's stats, "launches": the NMS
    kernel's launches over its passes, "passes": 1, or 2 on a card (the
    first untimed), "seconds": the last pass on the host's clock after a
    synchronize, start-up excluded}. Raises TimeoutError, the ranks
    stopped, when they run past `timeout` seconds.

    job: "cfg"; "state", the weights (CPU tensors); "device", every
    rank's ("cuda:0" puts the ranks on one card); "records", the video
    roidb; "lanes", the global count (divisible by nproc); "open_video",
    a picklable opener or None; "threads", torch threads per rank."""
    import time

    import torch
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        job_path = os.path.join(tmp, "job.pt")
        torch.save(job, job_path)
        ranks = mp.spawn(lanes_worker, args=(nproc, free_port(), job_path, tmp), nprocs=nproc,
                         join=False)
        deadline = time.monotonic() + timeout
        while not ranks.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                for p in ranks.processes:
                    p.kill()
                    p.join()
                raise TimeoutError(f"run_lanes: the {nproc} ranks ran past {timeout} s")
        return [torch.load(os.path.join(tmp, f"lanes_rank{r}.pt"), weights_only=False)
                for r in range(nproc)]


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
