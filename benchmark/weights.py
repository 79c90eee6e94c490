"""Seeded weights of a benchmark configuration, made on the device.

The parameter set is that of the configuration's reference network (its
kind's ``reference``, ``benchmark/kinds/``), whose names equal the
program's: one state dict loads into both. The rules below are keyed on
``reference/model.py``'s block types, so a network built from them needs
no rule of its own. Every convolution is drawn from a normal of standard
deviation gain / sqrt(fan_in), the gain taken from the configuration's
``weights.gains`` (the first pattern that matches the name) or its
``weights.default_gain``; all normals come from one draw of one
``torch.Generator`` on the device. Biases are 0, the scale map's 1;
BatchNorms are scale 1, bias 0, mean 0, variance 1, except the input
BatchNorms (``bn_data``), which hold the pixel statistics of
``weights.pixel_mean`` and ``weights.pixel_std``.
"""

from __future__ import annotations

import math
import re

import torch

from benchmark import kinds
from benchmark.reference import model as ref


def _specs(net: torch.nn.Module, recipe: dict):
    """(name, shape, std or None, fill) for every entry of the state dict."""
    gains = [(re.compile(p), float(g)) for p, g in recipe["gains"]]
    default = float(recipe["default_gain"])
    specs = {}
    for mname, mod in net.named_modules():
        pre = f"{mname}." if mname else ""
        if isinstance(mod, (ref.Conv, ref.Deconv2x)) or isinstance(mod, ref.DeformConv2d):
            w = mod.weight
            if isinstance(mod, ref.Deconv2x):
                fan_in = w.shape[0] * w.shape[2] * w.shape[3]
            else:
                fan_in = w.shape[1] * w.shape[2] * w.shape[3]
            name = pre + "weight"
            gain = next((g for p, g in gains if p.search(name)), default)
            specs[name] = (tuple(w.shape), gain / math.sqrt(fan_in), 0.0)
            if getattr(mod, "bias", None) is not None:
                fill = 1.0 if mname.endswith("scale_map") else 0.0
                specs[pre + "bias"] = (tuple(mod.bias.shape), None, fill)
        elif isinstance(mod, ref.FrozenBN):
            c = mod.bias.shape[0]
            data = mname.endswith("bn_data")
            if mod.weight is not None:
                specs[pre + "weight"] = ((c,), None, 1.0)
            specs[pre + "bias"] = ((c,), None, 0.0)
            specs[pre + "running_mean"] = ((c,), None, recipe["pixel_mean"] if data else 0.0)
            specs[pre + "running_var"] = ((c,), None, recipe["pixel_std"] ** 2 if data else 1.0)
    missing = set(net.state_dict()) - set(specs)
    if missing:
        raise ValueError(f"no weight rule for {sorted(missing)[:5]}")
    return specs


def make_state_dict(cfg: dict, seed: int, device) -> dict:
    """The state dict of configuration `cfg` from `seed`, float32 on
    `device`."""
    net = kinds.find(cfg["model"]).reference(cfg, ref.Precision(), "meta")
    specs = _specs(net, cfg["weights"])
    normals = [(n, s) for n, s in specs.items() if s[1] is not None]
    total = sum(math.prod(s[0]) for _, s in normals)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, (shape, std, _) in normals:
        k = math.prod(shape)
        out[name] = flat[at:at + k].view(shape).mul_(std)
        at += k
    for name, (shape, std, fill) in specs.items():
        if std is None:
            out[name] = torch.full(shape, float(fill), device=device)
    return {name: out[name] for name in net.state_dict()}
