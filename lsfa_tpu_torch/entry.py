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
                        (``tools.dryrun_multihost``), then, with the
                        trained weights, the evaluation sharded over the
                        ranks twice: whole videos by rank
                        (``eval.driver.shard_videos``), and the lockstep
                        lanes of one lane-batched detector split over the
                        ranks (``eval.driver.eval_videos_lanes(over_ranks=
                        True)``, 2 lanes per rank), each rank carrying
                        only its own lanes: JAX's lane axis sharded over
                        its mesh, one detector per rank.

``__graft_entry__.py`` keys XLA's persistent compile cache by host first
(``lsfa_tpu.utils.env.setup_cache``); the port has no such cache, and its
one built artifact, the kernel library, is keyed by its source and flags.
Like JAX's hook, the dry run runs on the CPU; ``chip_smoke.py`` phase 39
runs the lanes over two ranks sharing the card.

Usage:
  python -c "from lsfa_tpu_torch import entry; fn, args = entry.entry(); fn(*args)"
  python -c "from lsfa_tpu_torch import entry; entry.dryrun_multichip(2)"
"""

from __future__ import annotations

import contextlib
import functools
import json
import logging
import os
import tempfile

import numpy as np
import torch

EVAL_LENGTHS = (30, 24, 18, 13)       # frames of the dry run's val videos
EVAL_HW = (60, 104)                   # their frames, inside the tiny bucket
LOG = logging.getLogger("lsfa_tpu_torch.entry")


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


@contextlib.contextmanager
def _two_threads():
    """Two torch threads, then the caller's count: the same arithmetic in
    every process of the dry run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _tiny(state):
    """(config, model) of the dry run's tiny LSFA on the CPU with weights
    `state`, and the opener of its synthetic streams."""
    from lsfa_tpu_torch.data.loader import SyntheticPreparedVideo
    from lsfa_tpu_torch.models.lsfa import lsfa_from_config
    from lsfa_tpu_torch.tools.dryrun_multihost import tiny_config

    cfg = tiny_config()
    model = lsfa_from_config(cfg, device="cpu")
    model.load_state_dict(state)
    return cfg, model, functools.partial(SyntheticPreparedVideo, content_hw=EVAL_HW)


def evaluate(state, records) -> dict:
    """{(vid_path, frame): detections} of the tiny LSFA with weights
    `state` through ``eval_videos`` over `records`, on the CPU at two
    torch threads (the same arithmetic in every process)."""
    from lsfa_tpu_torch.eval.driver import eval_videos, frame_bases

    with _two_threads():
        cfg, model, opener = _tiny(state)
        dets = eval_videos(model, cfg, records, open_video=opener, logger=LOG)
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


def _same(a, b) -> bool:
    """Two frames' detections equal bit for bit."""
    return all(np.array_equal(a[f], b[f]) for f in ("labels", "scores", "boxes"))


def _lanes_diff(got, want):
    """(labels and valid rows equal on every frame, max score difference,
    max box difference over the frame's largest coordinate) of two
    mappings of the same frames; the differences over the frames whose
    labels agree."""
    equal, score, box = True, 0.0, 0.0
    for k, w in want.items():
        g = got[k]
        if not np.array_equal(g["labels"], w["labels"]):
            equal = False
        elif len(w["labels"]):
            score = max(score, float(np.abs(g["scores"] - w["scores"]).max()))
            box = max(box, float(np.abs(g["boxes"] - w["boxes"]).max()
                                 / max(float(np.abs(w["boxes"]).max()), 1e-30)))
    return equal, score, box


def _lanes_in_process(state, records, lanes: int, world: int):
    """The lane-sharded evaluation's references in this process at two
    torch threads: each rank's block (``eval_videos_multistream(rank=r,
    world=world)``, at the rank's batch), keyed by global frame, and the
    single-process ``eval_videos_lanes(lanes)``."""
    from lsfa_tpu_torch.eval.driver import eval_videos_lanes, frame_bases, group_videos_by_bucket
    from lsfa_tpu_torch.eval.multistream import eval_videos_multistream

    base, _ = frame_bases(records)
    with _two_threads():
        cfg, model, opener = _tiny(state)
        (bucket, _), = group_videos_by_bucket(records, cfg).items()
        blocks = []
        for r in range(world):
            dets = eval_videos_multistream(model, cfg, records, lanes=lanes, logger=LOG,
                                           bucket_hw=bucket, open_video=opener, rank=r,
                                           world=world)
            blocks.append({base[id(records[vi])] + fid: d for (vi, fid), d in dets.items()})
        single = eval_videos_lanes(model, cfg, records, lanes, logger=LOG, open_video=opener)
    return blocks, single


def _lanes_over_ranks(state, records, n: int) -> dict:
    """`records` through ``eval_videos_lanes(lanes=2n, over_ranks=True)``
    over n gloo ranks (``tools.dryrun_multihost.run_lanes``), held to
    checks (a)-(e) of `dryrun_multichip`. Returns the report's fields."""
    from lsfa_tpu_torch.eval.driver import frame_bases
    from lsfa_tpu_torch.eval.multistream import build_lane_playlists
    from lsfa_tpu_torch.tools import dryrun_multihost

    lanes, per = 2 * n, 2
    cfg, _, opener = _tiny(state)
    interval = cfg.TEST.KEY_FRAME_INTERVAL
    ranks = dryrun_multihost.run_lanes(
        {"cfg": cfg, "state": state, "device": "cpu", "records": records, "lanes": lanes,
         "open_video": opener, "threads": 2}, n)
    blocks, single = _lanes_in_process(state, records, lanes, n)
    base, total = frame_bases(records)
    frame_id = {base[id(rec)] + f: f for rec in records for f in range(rec["frame_seg_len"])}
    playlists = build_lane_playlists(records, lanes, interval)
    merged = ranks[0]["dets"]
    for rank, out in enumerate(ranks):
        (group,) = out["stats"]
        own = {k: merged[k] for k in group["frames"]} if rank == 0 else out["dets"]
        block = sorted(base[id(records[vi])] + fid
                       for pl in playlists[rank * per:(rank + 1) * per] for vi, fid, real in pl
                       if real)
        _check(group["lanes"] == per, f"rank {rank} carried {group['lanes']} lanes, not {per}")
        _check(group["frames"] == sorted(own) == block,
               f"rank {rank}'s frames are not its block of the lane playlists")
        key = [k for k in own if frame_id[k] % interval == 0]
        _check(key and len(key) < len(own), f"rank {rank}'s lanes have no key or no non-key frame")
        _check(_finite(own), f"rank {rank}'s lane detections are not finite")
        _check(own.keys() == blocks[rank].keys()
               and all(_same(own[k], blocks[rank][k]) for k in own),
               f"rank {rank}'s lane detections differ from its block run in one process")
    by_rank = [len(out["stats"][0]["frames"]) for out in ranks]
    _check(sorted(merged) == list(range(total)) and sum(by_rank) == total,
           "the ranks' lanes did not file every frame once")
    equal, score, box = _lanes_diff(merged, single)
    _check(equal and score <= 1e-5 and box <= 1e-5,
           f"the merged lanes against the single process's {lanes} lanes: labels equal "
           f"{equal}, scores within {score}, boxes within {box} (limits 1e-5)")
    return {"eval_lanes": lanes, "eval_lanes_by_rank": [out["stats"][0]["lanes"] for out in ranks],
            "eval_lane_frames_by_rank": by_rank, "eval_lanes_equal": True,
            "eval_lanes_max_score_diff": score, "eval_lanes_max_box_diff": box}


def dryrun_multichip(n_devices: int) -> dict:
    """One data-parallel train step of the tiny LSFA over n_devices gloo
    ranks on the CPU (``tools.dryrun_multihost.run``: the ranks identical
    and equal to the single process within its tolerance), then two
    evaluations of `eval_records` over the ranks with the trained weights.

    By video: whole videos sharded by rank, each rank's key and non-key
    detections finite, the ranks' together equal to the single process's.

    By lane, the counterpart of JAX's lane-sharded StreamingDetector:
    ``eval_videos_lanes(lanes=2 n, over_ranks=True)``, each rank at two
    torch threads. (a) Every rank's detections are finite, with key and
    non-key frames; (b) every rank carried 2 lanes (its detector's
    key-feature carry); (c) its frames are the real frames of its block
    of ``build_lane_playlists``, and the ranks file every frame once; (d)
    its detections equal bit for bit its block run in this process
    (``eval_videos_multistream(rank=r, world=n)``, the same batch); (e)
    rank 0's merged mapping equals the single process's 2n-lane run at
    the lanes' tolerance (labels and valid rows equal, scores within
    1e-5, boxes within 1e-5 of the frame's largest coordinate: another
    batch size rounds CPU convolutions otherwise).

    Returns the dry run's report with both evaluations' fields; raises
    RuntimeError where a check fails."""
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
        _check(_same(merged[k], want),
               f"frame {k}: the sharded detections differ from the single process's")
    n_det = sum(len(d["labels"]) for d in whole.values())
    report.update(eval_frames=len(whole), eval_detections=n_det,
                  eval_frames_by_rank=[len(d) for d in shards], eval_equal=True)
    print(f"dryrun_multichip({n_devices}): eval sharded by rank over {len(records)} videos "
          f"({[len(d) for d in shards]} frames by rank): key and non-key detections finite, "
          f"equal to the single process's ({len(whole)} frames, {n_det} detections)")

    lanes = _lanes_over_ranks(state, records, n_devices)
    report.update(lanes)
    print(f"dryrun_multichip({n_devices}): lane-sharded eval ok (key + non-key over {n_devices} "
          f"ranks): {lanes['eval_lanes']} lanes, {lanes['eval_lanes_by_rank']} carried by rank, "
          f"{lanes['eval_lane_frames_by_rank']} frames by rank, each rank's its block of the "
          f"playlists and bit-equal to that block run in one process; merged, within "
          f"{lanes['eval_lanes_max_score_diff']:.1e} (scores) and "
          f"{lanes['eval_lanes_max_box_diff']:.1e} (boxes, of the frame's largest coordinate) "
          f"of the single process's {lanes['eval_lanes']}-lane run")
    return report
