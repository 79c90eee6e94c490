"""The reference's learning-rate schedule, parameter freeze and SGD recipe;
the counterparts of ``lsfa_tpu.train.schedule``.

The schedule is a linear warm-up to the base rate, then a step decay by
lr_factor at each boundary. FIXED_PARAMS freezes the main backbone's input
BN, stem and stage 1, and the scale and bias of every BatchNorm; a frozen
parameter gets requires_grad False. The optimizer is SGD with momentum 0.9
and weight decay 5e-4 on tensors of more than one dimension, in two
parameter groups: torch's SGD, like optax's sgd, scales by the learning
rate after the momentum.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from lsfa_tpu_torch.models.layers import FrozenBN


def warmup_multifactor(base_lr: float, steps: Sequence[int], factor: float = 0.1,
                       warmup: bool = False, warmup_lr: float = 0.0, warmup_step: int = 0):
    """Returns sched(count) -> learning rate (a Python float)."""
    steps = list(steps)

    def sched(count: int) -> float:
        lr = base_lr * factor ** sum(count >= s for s in steps)
        if warmup and warmup_step > 0 and count < warmup_step:
            return warmup_lr + (base_lr - warmup_lr) * (count / warmup_step)
        return lr

    return sched


def frozen_names(model: nn.Module) -> set:
    """Names of the parameters FIXED_PARAMS freezes: every BatchNorm's
    scale and bias (bn_data included), and the main backbone's stem
    (conv0, bn0) and stage 1."""
    names = set()
    for mod_name, mod in model.named_modules():
        if isinstance(mod, FrozenBN):
            names.update(f"{mod_name}.{p}" for p, _ in mod.named_parameters())
    for name, _ in model.named_parameters():
        if name.startswith(("backbone.conv0.", "backbone.bn0.", "backbone.stage1_")):
            names.add(name)
    return names


def make_optimizer(model: nn.Module, base_lr: float, lr_steps: Sequence[int],
                   lr_factor: float = 0.1, momentum: float = 0.9, wd: float = 5e-4,
                   warmup: bool = False, warmup_lr: float = 0.0, warmup_step: int = 0):
    """Freeze FIXED_PARAMS and build (SGD optimizer, LambdaLR scheduler).
    Call `scheduler.step()` after each `optimizer.step()`; the first step
    runs at sched(0)."""
    frozen = frozen_names(model)
    decay, no_decay = [], []
    for name, p in model.named_parameters():
        if name in frozen:
            p.requires_grad_(False)
        else:
            (decay if p.ndim > 1 else no_decay).append(p)
    opt = torch.optim.SGD([{"params": decay, "weight_decay": wd},
                           {"params": no_decay, "weight_decay": 0.0}],
                          lr=base_lr, momentum=momentum)
    sched = warmup_multifactor(base_lr, lr_steps, lr_factor, warmup, warmup_lr, warmup_step)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda count: sched(count) / base_lr if base_lr else 0.0)
    return opt, scheduler
