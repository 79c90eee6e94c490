"""The training driver on one device; the counterpart of
``lsfa_tpu.train.driver``.

`init_model` builds the config's model (LSFA, or the single-frame R-FCN
for an ``rfcn*`` symbol) with random weights from a seed and seeds the
small-net trunk from the backbone. `train_net`
runs the recipe (SGD with the warm-up multi-factor schedule, per-epoch
checkpoints, resume) over an iterable of collated host batches
(``data.loader.collate_train_batch`` or ``synthetic_train_batches``).
"""

from __future__ import annotations

import logging
import time

import torch

from lsfa_tpu_torch.data.loader import batch_to_device
from lsfa_tpu_torch.eval.rfcn_tester import rfcn_from_config
from lsfa_tpu_torch.models.lsfa import init_params, lsfa_from_config, resolve_device
from lsfa_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint, seed_small_net
from lsfa_tpu_torch.train.schedule import make_optimizer
from lsfa_tpu_torch.train.train_step import (
    TrainSettings, draw_uniforms, make_rfcn_train_step, make_train_step)


def is_rfcn(cfg) -> bool:
    """Single-frame baseline configs (the reference's rfcn/ package) are
    selected by the symbol name."""
    return str(cfg.symbol).startswith("rfcn")


def init_model(cfg, rng_seed: int = 0, device=None, logger=None):
    """The model of `cfg` (`RFCN` when `is_rfcn`, else `LSFA`) on
    `device` (the card when None; raises without one unless
    device="cpu"), weights drawn from a generator seeded with rng_seed on
    that device, small-net trunk seeded from the backbone. Pretrained
    files (network.pretrained, pretrained_flow, pretrained_detector) are
    not read: warm starts from MXNet .params and flax checkpoints are not
    ported."""
    if str(cfg.tpu.param_dtype) != "float32":
        raise NotImplementedError("parameters are float32 in the port")
    for key in ("pretrained", "pretrained_flow", "pretrained_detector"):
        name = str(cfg.network.get(key, "") or "")
        if name and logger is not None:
            logger.warning(f"network.{key}={name!r} is not loaded: warm starts are not ported")
    device = resolve_device(device)
    model = (rfcn_from_config if is_rfcn(cfg) else lsfa_from_config)(cfg, device=device)
    init_params(model, torch.Generator(device=device).manual_seed(rng_seed))
    model.load_state_dict(seed_small_net(model.state_dict()))
    return model


def train_net(cfg, batches, ckpt_dir: str | None = None, logger=None,
              max_steps: int | None = None, metrics_hook=None, device=None,
              seed: int = 0, model=None):
    """Train on `batches` (a sized iterable of collated host batches, one
    epoch) from cfg.TRAIN.begin_epoch to end_epoch. Returns the model.

    The model is `model` when given, else `init_model(cfg, seed, device)`,
    which builds on the card when `device` is None.
    The step's uniform draws come from a generator on the device seeded
    with `seed`; its state, the step count, optimizer and scheduler are
    checkpointed to <ckpt_dir>/<epoch>.pt after each epoch and at
    max_steps, and restored when cfg.TRAIN.RESUME is set.
    metrics_hook(step, metrics): called every step with the metric dict of
    device scalars (reading one synchronizes with the device)."""
    logger = logger or logging.getLogger("lsfa_tpu_torch.train")
    if model is None:
        model = init_model(cfg, seed, device, logger)
    device = next(model.parameters()).device
    steps_per_epoch = len(batches)
    lr_steps = [int(float(e) * steps_per_epoch) for e in str(cfg.TRAIN.lr_step).split(",")]
    t = cfg.TRAIN
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
            batch = batch_to_device(host_batch, device)
            metrics = train_step(batch, draw_uniforms(settings, batch, gen))
            if metrics_hook is not None:
                metrics_hook(step_count, metrics)
            step_count += 1
            steps_run += 1
        if ckpt_dir:
            save_checkpoint(ckpt_dir, epoch + 1, model, optimizer, scheduler,
                            step=step_count, rng_state=gen.get_state())
        if max_steps is not None and steps_run >= max_steps:
            logger.info("max_steps reached, stopping early")
            break
    wall = time.perf_counter() - t_start
    if steps_run:
        logger.info(f"feed summary: {steps_run} steps in {wall:.1f}s, "
                    f"loader-wait {data_wait:.1f}s ({100 * data_wait / wall:.1f}% of wall)")
    return model
