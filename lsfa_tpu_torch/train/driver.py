"""The training driver; the counterpart of ``lsfa_tpu.train.driver``.

`load_train_roidb` builds the DET+VID roidb the config names.
`init_model` builds the config's model (LSFA, or the single-frame R-FCN
for an ``rfcn*`` symbol) with random weights from a seed, applies the
warm starts the config names (the reference's MXNet ``.params`` files,
the port's own checkpoints) and seeds the small-net trunk from the
backbone, and stores the floating parameters in ``tpu.param_dtype``.
`train_net` runs the recipe (SGD with the warm-up multi-factor
schedule, per-epoch checkpoints, resume) over a `TrainLoader` of the
roidb, or over given collated host batches (``synthetic_train_batches``),
on one device or data parallel over the ranks of a process group.
"""

from __future__ import annotations

import logging
import os
import time

import torch

from lsfa_tpu_torch.data.dataset import ImageNetVID, append_flipped, filter_roidb, merge_roidb
from lsfa_tpu_torch.data.loader import TrainLoader, batch_to_device
from lsfa_tpu_torch.eval.rfcn_tester import rfcn_from_config
from lsfa_tpu_torch.models.lsfa import init_params, lsfa_from_config, resolve_device
from lsfa_tpu_torch.parallel import mesh
from lsfa_tpu_torch.train.checkpoint import (
    combine_checkpoints, load_checkpoint, save_checkpoint, seed_small_net)
from lsfa_tpu_torch.train.import_mxnet import import_mxnet_lsfa
from lsfa_tpu_torch.train.schedule import make_optimizer
from lsfa_tpu_torch.train.train_step import (
    TrainSettings, draw_uniforms, make_rfcn_train_step, make_train_step)
from lsfa_tpu_torch.utils.profiler import Speedometer


def is_rfcn(cfg) -> bool:
    """Single-frame baseline configs (the reference's rfcn/ package) are
    selected by the symbol name."""
    return str(cfg.symbol).startswith("rfcn")


# the detection stack a trained detector shares with LSFA and R-FCN
SHARED_STACK = ("backbone", "feat_conv_3x3", "rpn_cls_score", "rpn_bbox_pred",
                "rfcn_cls", "rfcn_bbox")


def build_model(cfg, rng_seed: int = 0, device=None):
    """The model of `cfg` (`RFCN` when `is_rfcn`, else `LSFA`) on `device`
    (the card when None; raises without one unless device="cpu"), weights
    drawn from a generator seeded with rng_seed on that device. No warm
    start, no small-net seeding."""
    device = resolve_device(device)
    model = (rfcn_from_config if is_rfcn(cfg) else lsfa_from_config)(cfg, device=device)
    init_params(model, torch.Generator(device=device).manual_seed(rng_seed))
    return model


def param_dtype(cfg) -> torch.dtype:
    """The torch dtype of ``tpu.param_dtype`` (a name such as "float32" or
    "bfloat16"; ValueError for a name torch has no floating dtype for)."""
    name = str(getattr(cfg.tpu, "param_dtype", "float32"))
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise ValueError(f"tpu.param_dtype {name!r} names no floating torch dtype")
    return dt


def cast_parameters(model, dtype: torch.dtype):
    """Store every floating parameter of `model` in `dtype`, in place.
    Buffers (BatchNorm running statistics) stay float32, as the JAX
    package's batch_stats do; every layer upcasts to its compute dtype
    when it runs."""
    with torch.no_grad():
        for p in model.parameters():
            if p.is_floating_point() and p.dtype != dtype:
                p.data = p.data.to(dtype)
    return model


def _sub_state(state: dict, top: str) -> dict:
    """The entries of `state` under module `top`, keyed below it."""
    return {k[len(top) + 1:]: v for k, v in state.items() if k.startswith(top + ".")}


def init_model(cfg, rng_seed: int = 0, device=None, logger=None):
    """`build_model`, then the pretrained init in the JAX package's order
    (the reference's load_param + combine_model, train_end2end.py:107-115):

    1. network.pretrained and network.pretrained_flow: each a .params path
       or a prefix read as ``<prefix>-<pretrained_epoch:04d>.params``,
       imported by name (a missing file is logged and skipped);
       pretrained_flow may instead name a checkpoint directory of this
       package (``<dir>/<epoch>.pt``, the latest epoch), whose ``flownet``
       entries are merged;
    2. network.pretrained_detector: a checkpoint directory of this package
       (e.g. the single-frame R-FCN's), whose shared detection stack
       (`SHARED_STACK`, BatchNorm statistics included) is merged by name
       and shape; ValueError when it shares no parameter;
    3. the small-net trunk seeded from the (warm) backbone;
    4. the floating parameters stored in ``tpu.param_dtype`` (bfloat16
       halves the weights' memory and checkpoints; the layers compute in
       the compute dtype, as JAX upcasts). `train_net`'s SGD then updates
       the parameters in that dtype in place, momentum included, as optax
       does on a bfloat16 tree.

    The JAX package reads orbax directories where this one reads its own
    checkpoints."""
    logger = logger or logging.getLogger("lsfa_tpu_torch.train")
    model = build_model(cfg, rng_seed, device)
    state = model.state_dict()
    net = cfg.network
    for key in ("pretrained", "pretrained_flow"):
        name = str(net.get(key, "") or "")
        if not name:
            continue
        if key == "pretrained_flow" and os.path.isdir(name):
            restored, epoch = load_checkpoint(name)
            flownet = _sub_state(restored["model"], "flownet")
            if not flownet:
                raise ValueError(f"pretrained_flow dir {name} has no 'flownet' entries")
            state, n = combine_checkpoints(state, {"flownet": flownet})
            logger.info(f"warm-started {n} flownet tensors from {name} (epoch {epoch})")
            continue
        path = name if name.endswith(".params") else (
            "%s-%04d.params" % (name, int(net.pretrained_epoch)))
        if not os.path.exists(path):
            logger.warning(f"pretrained file not found, skipping: {path}")
            continue
        state, report = import_mxnet_lsfa(state, path, bbox_means=tuple(cfg.TRAIN.BBOX_MEANS),
                                          bbox_stds=tuple(cfg.TRAIN.BBOX_STDS))
        logger.info(f"imported {len(report['imported'])} tensors from {path} "
                    f"({len(report['unused'])} unused)")

    det = str(net.get("pretrained_detector", "") or "")
    if det:
        restored, epoch = load_checkpoint(det)
        src = {top: _sub_state(restored["model"], top) for top in SHARED_STACK}
        merged, n = combine_checkpoints(state, src)
        n_stats = sum(k.endswith(("running_mean", "running_var"))
                      for k in merged if merged[k] is not state[k])
        if n == n_stats:
            raise ValueError(f"pretrained_detector {det} (epoch {epoch}) shares no parameter "
                             f"with this model — wrong checkpoint?")
        state = merged
        logger.info(f"warm-started {n - n_stats} param + {n_stats} batch-stat tensors from "
                    f"detector checkpoint {det} (epoch {epoch})")

    model.load_state_dict(seed_small_net(state))
    return cast_parameters(model, param_dtype(cfg))


def load_train_roidb(cfg):
    """The DET+VID roidb of dataset.image_set ("+"-joined sets), each
    video frame's record given its stream (video_path), flipped copies
    when TRAIN.FLIP, records without gt boxes dropped
    (train_end2end.py:76-81)."""
    roidbs = []
    vid_root = os.path.join(cfg.dataset.dataset_path, "Data", "VID")
    for image_set in cfg.dataset.image_set.split("+"):
        ds = ImageNetVID(image_set, cfg.dataset.root_path, cfg.dataset.dataset_path)
        r = ds.gt_roidb()
        for rec in r:
            if "pattern" in rec:
                rec["video_path"] = ds.video_path(
                    {"path": os.path.relpath(os.path.dirname(rec["image"]), vid_root)})
        if cfg.TRAIN.FLIP:
            r = append_flipped(r)
        roidbs.append(r)
    return filter_roidb(merge_roidb(roidbs))


def train_net(cfg, roidb=None, ckpt_dir: str | None = None, logger=None,
              max_steps: int | None = None, metrics_hook=None, device=None,
              seed: int = 0, model=None, batches=None, open_video=None, read_image=None):
    """Run the training recipe from cfg.TRAIN.begin_epoch to end_epoch and
    return the model: SGD with the warm-up multi-factor schedule (lr_step
    in epochs of global steps), data parallel over the process group when
    there is one (``parallel/mesh.py``), one step at a time.

    The feed: `batches`, a sized iterable of collated host batches (one
    epoch of global batches; each rank trains on its rows), when given;
    else a `TrainLoader` over `roidb` (None: `load_train_roidb(cfg)`) at
    TRAIN.BATCH_IMAGES images per rank, seeded with `seed`, that loads
    each rank's slice of the global batch with open_video and read_image
    (see ``data.loader.load_pair_sample``).

    The model is `model` when given, else `init_model(cfg, seed, device)`,
    which builds on the card when `device` is None; rank 0's parameters
    are broadcast to every rank. The step's uniform draws come from a
    generator on the device seeded with `seed`; its state, the step count,
    optimizer and scheduler are checkpointed to <ckpt_dir>/<epoch>.pt
    after each epoch and at max_steps (by rank 0, between barriers), and
    restored when cfg.TRAIN.RESUME is set. Rank 0 logs the `Speedometer`
    line every cfg.default.frequent steps and the feed summary (the
    loader's wait against the wall). metrics_hook(step, metrics): called
    every step with the metric dict of device scalars (reading one
    synchronizes with the device)."""
    logger = logger or logging.getLogger("lsfa_tpu_torch.train")
    rank, world = mesh.rank(), mesh.world_size()
    if model is None:
        model = init_model(cfg, seed, device, logger)
    mesh.broadcast_parameters(model)
    device = next(model.parameters()).device
    t = cfg.TRAIN
    if batches is None:
        batches = TrainLoader(roidb if roidb is not None else load_train_roidb(cfg), cfg,
                              t.BATCH_IMAGES * world, seed=seed, open_video=open_video,
                              read_image=read_image, rank=rank, world_size=world)
        own_rows = None                      # the loader loads this rank's rows only
    else:
        own_rows = rank, world
    steps_per_epoch = len(batches)
    lr_steps = [int(float(e) * steps_per_epoch) for e in str(t.lr_step).split(",")]
    optimizer, scheduler = make_optimizer(
        model, base_lr=t.lr, lr_steps=lr_steps, lr_factor=t.lr_factor,
        momentum=t.momentum, wd=t.wd, warmup=t.warmup, warmup_lr=t.warmup_lr,
        warmup_step=t.warmup_step)
    gen = torch.Generator(device=device).manual_seed(seed)

    begin_epoch, step_count = t.begin_epoch, 0
    if t.RESUME and ckpt_dir:
        state, begin_epoch = load_checkpoint(ckpt_dir)
        model.load_state_dict(state["model"])
        optimizer.load_state_dict(state["optimizer"])
        scheduler.load_state_dict(state["scheduler"])
        gen.set_state(state["rng_state"])
        step_count = state["step"]
        logger.info(f"resumed from epoch {begin_epoch}, step {step_count}")

    settings = TrainSettings.from_config(cfg)
    make_step = make_rfcn_train_step if is_rfcn(cfg) else make_train_step
    train_step = make_step(model, settings, optimizer, scheduler)
    speedo = (Speedometer(t.BATCH_IMAGES * world, cfg.default.frequent, logger)
              if rank == 0 else None)

    steps_run, data_wait = 0, 0.0
    t_start = time.perf_counter()
    for epoch in range(begin_epoch, t.end_epoch):
        it = iter(batches)
        while max_steps is None or steps_run < max_steps:
            t0 = time.perf_counter()
            host_batch = next(it, None)
            data_wait += time.perf_counter() - t0
            if host_batch is None:
                break
            if own_rows is not None:
                host_batch = mesh.shard_batch(host_batch, *own_rows)
            batch = batch_to_device(host_batch, device)
            metrics = train_step(batch, draw_uniforms(settings, batch, gen, rank, world))
            if speedo is not None:
                speedo(step_count, metrics)
            if metrics_hook is not None:
                metrics_hook(step_count, metrics)
            step_count += 1
            steps_run += 1
        if hasattr(it, "close"):
            it.close()                       # ends the loader's threads
        if ckpt_dir:
            mesh.barrier()
            if rank == 0:
                save_checkpoint(ckpt_dir, epoch + 1, model, optimizer, scheduler,
                                step=step_count, rng_state=gen.get_state())
                logger.info(f"checkpointed epoch {epoch + 1}")
            mesh.barrier()
        if max_steps is not None and steps_run >= max_steps:
            logger.info("max_steps reached, stopping early")
            break
    wall = time.perf_counter() - t_start
    if steps_run and rank == 0:
        logger.info(f"feed summary: {steps_run} steps in {wall:.1f}s "
                    f"({steps_run / wall:.2f} steps/s), loader-wait {data_wait:.1f}s "
                    f"({100 * data_wait / wall:.1f}% of wall)")
    return model
