"""Entry hooks of the port; the counterpart of ``__graft_entry__.py``.

entry(device=None)   -> (fn, example_args): the flagship LSFA key-frame
                        forward (ResNet-101 with DCN, FlowNet-S, Nq-net,
                        small net) at the 608x1024 bucket, on the card
                        unless device="cpu". fn(params, data, data_key_old,
                        feat_key_old, is_first) takes the weights as its
                        first argument, through torch.func.functional_call,
                        so that one callable serves any weights (a CUDA
                        graph captures it).
dryrun_multichip(n)  -> one tiny data-parallel train step over n gloo ranks
                        on the CPU against the single process
                        (``tools.dryrun_multihost``), then the evaluation
                        sharded by rank (``eval.driver.shard_videos``)
                        against the single process's.

``__graft_entry__.py`` keys XLA's persistent compile cache by host first
(``lsfa_tpu.utils.env.setup_cache``); the port has no such cache, and its
one built artifact, the kernel library, is keyed by its source and flags.
The dry run's evaluation over the ranks shards whole videos by rank, where
JAX's shards the lockstep lanes of one detector over its mesh; the port's
lanes split over ranks in ``eval.driver.eval_videos_lanes(over_ranks=True)``
(``experiments/lsfa_test.py --lanes N --mesh M``).

Usage:
  python -c "from lsfa_tpu_torch import entry; fn, args = entry.entry(); fn(*args)"
  python -c "from lsfa_tpu_torch import entry; entry.dryrun_multichip(2)"
"""

from __future__ import annotations

import functools
import json
import logging
import os
import tempfile

import numpy as np
import torch

EVAL_LENGTHS = (30, 24, 18, 13)       # frames of the dry run's val videos
EVAL_HW = (60, 104)                   # their frames, inside the tiny bucket


def _flagship(small: bool = False, device=None):
    """(config, model) of the flagship LSFA with seeded weights on
    `device` (the card when None). small: ResNet-18, feat 64, no DCN,
    float32 compute (the dry run's tiny net)."""
    from lsfa_tpu_torch.config import get_default_config
    from lsfa_tpu_torch.models.lsfa import init_params, lsfa_from_config, resolve_device

    cfg = get_default_config()
    if small:
        cfg.network.num_layer = 18
        cfg.network.DFF_FEAT_DIM = 64
        cfg.network.add_dcn = False
        cfg.tpu.compute_dtype = "float32"
    device = resolve_device(device)
    model = lsfa_from_config(cfg, device=device)
    init_params(model, torch.Generator(device=device).manual_seed(0))
    return cfg, model


def key_step(model):
    """fn(params, data, data_key_old, feat_key_old, is_first) ->
    `model.forward_key`'s outputs (no autograd) under the weights
    `params`, a {name: tensor} of the model's parameters and buffers.
    The model is the step's own: it is set to eval mode, and forward_key
    becomes its forward, which functional_call calls."""
    model.eval()
    model.forward = model.forward_key

    @torch.no_grad()
    def fn(params, data, data_key_old, feat_key_old, is_first):
        return torch.func.functional_call(model, params,
                                          (data, data_key_old, feat_key_old, is_first))

    return fn


def entry(device=None):
    """(fn, example_args) of the flagship key-frame step at the default
    bucket: `key_step` of `_flagship()`, and its weights, a seeded raw
    frame (also given as the cached previous key frame), a zero cached
    key feature and is_first 1."""
    cfg, model = _flagship(device=device)
    dev = next(model.parameters()).device
    h, w = cfg.tpu.default_bucket
    gen = torch.Generator(device=dev).manual_seed(1)
    data = torch.randint(0, 256, (1, h, w, 3), generator=gen, device=dev).float()
    params = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    example_args = (params, data, data,
                    torch.zeros((1, h // 16, w // 16, cfg.network.DFF_FEAT_DIM), device=dev),
                    torch.ones((1,), device=dev))
    return key_step(model), example_args


def eval_records(lengths=EVAL_LENGTHS):
    """Video records of the dry run's evaluation: seeded synthetic streams
    of `lengths` frames at EVAL_HW (a partial-GOP tail in the 30, 18 and
    13-frame ones)."""
    return [{"vid_path": f"dryrun/video{i}", "frame_seg_len": n,
             "pattern": f"dryrun/video{i}/%06d.JPEG", "video_path": f"dryrun/video{i}.mp4",
             "height": EVAL_HW[0], "width": EVAL_HW[1]} for i, n in enumerate(lengths)]


def evaluate(state, records) -> dict:
    """{(vid_path, frame): detections} of the tiny LSFA with weights
    `state` through ``eval_videos`` over `records`, on the CPU at two
    torch threads (the same arithmetic in every process)."""
    from lsfa_tpu_torch.data.loader import SyntheticPreparedVideo
    from lsfa_tpu_torch.eval.driver import eval_videos, frame_bases
    from lsfa_tpu_torch.models.lsfa import lsfa_from_config
    from lsfa_tpu_torch.tools.dryrun_multihost import tiny_config

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        cfg = tiny_config()
        model = lsfa_from_config(cfg, device="cpu")
        model.load_state_dict(state)
        opener = functools.partial(SyntheticPreparedVideo, content_hw=EVAL_HW)
        dets = eval_videos(model, cfg, records, open_video=opener,
                           logger=logging.getLogger("lsfa_tpu_torch.entry"))
    finally:
        torch.set_num_threads(threads)
    base, _ = frame_bases(records)
    return {(rec["vid_path"], f): dets[base[id(rec)] + f]
            for rec in records for f in range(rec["frame_seg_len"])}


def _eval_worker(rank: int, world: int, port: int, out_dir: str):
    from lsfa_tpu_torch.eval.driver import shard_videos
    from lsfa_tpu_torch.parallel import mesh

    mesh.initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    try:
        state = torch.load(os.path.join(out_dir, "state.pt"), weights_only=True)
        shard = shard_videos(eval_records(), mesh.world_size())[mesh.rank()]
        torch.save(evaluate(state, shard), os.path.join(out_dir, f"dets{rank}.pt"))
        mesh.barrier()
    finally:
        torch.distributed.destroy_process_group()


def _check(cond, msg):
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {msg}")


def _finite(dets) -> bool:
    return all(np.isfinite(d["scores"]).all() and np.isfinite(d["boxes"]).all()
               for d in dets.values())


def dryrun_multichip(n_devices: int) -> dict:
    """One data-parallel train step of the tiny LSFA over n_devices gloo
    ranks on the CPU (``tools.dryrun_multihost.run``: the ranks identical
    and equal to the single process within its tolerance), then
    `eval_records` sharded by rank with the trained weights: each rank's
    key and non-key detections finite, and the ranks' together equal to
    the single process's over all the videos. Returns the dry run's
    report with the evaluation's; raises RuntimeError where a check
    fails."""
    import torch.multiprocessing as mp

    from lsfa_tpu_torch.tools import dryrun_multihost

    report, ranks, _ = dryrun_multihost.run(n_devices, names=("plain",))
    _check(report["ok"], f"the train step: {json.dumps(report)}")
    total = report["workers"][0]["total_loss_plain"][0]
    print(f"dryrun_multichip({n_devices}): total_loss={total:.4f} over {n_devices} gloo ranks, "
          f"equal to the single process within {report['max_rel_err_params']:.1e}")

    state = ranks[0]["state"]["plain"]
    records = eval_records()
    with tempfile.TemporaryDirectory() as out_dir:
        torch.save(state, os.path.join(out_dir, "state.pt"))
        mp.spawn(_eval_worker, args=(n_devices, dryrun_multihost.free_port(), out_dir),
                 nprocs=n_devices, join=True)
        shards = [torch.load(os.path.join(out_dir, f"dets{r}.pt"), weights_only=False)
                  for r in range(n_devices)]
    whole = evaluate(state, records)
    key_interval = dryrun_multihost.tiny_config().TEST.KEY_FRAME_INTERVAL
    merged = {}
    for rank, dets in enumerate(shards):
        key = {k: d for k, d in dets.items() if k[1] % key_interval == 0}
        _check(key and len(key) < len(dets), f"rank {rank} has no key or no non-key frame")
        _check(_finite(dets), f"rank {rank}'s detections are not finite")
        _check(not merged.keys() & dets.keys(), f"rank {rank} repeats another rank's frames")
        merged.update(dets)
    _check(merged.keys() == whole.keys(), "the ranks' frames differ from the single process's")
    for k, want in whole.items():
        got = merged[k]
        _check(all(np.array_equal(got[f], want[f]) for f in ("labels", "scores", "boxes")),
               f"frame {k}: the sharded detections differ from the single process's")
    n_det = sum(len(d["labels"]) for d in whole.values())
    report.update(eval_frames=len(whole), eval_detections=n_det,
                  eval_frames_by_rank=[len(d) for d in shards], eval_equal=True)
    print(f"dryrun_multichip({n_devices}): eval sharded by rank over {len(records)} videos "
          f"({[len(d) for d in shards]} frames by rank): key and non-key detections finite, "
          f"equal to the single process's ({len(whole)} frames, {n_det} detections)")
    return report
