"""Parameter inspection, the graph-construction sanity check; the
counterpart of ``lsfa_tpu.utils.inspect`` (the reference's
lib/utils/symbol.py:44-55 check_parameter_shapes).

Each function takes a model or a state dict. Deviation from the JAX
module: entries are keyed by ``state_dict`` names ("backbone.conv0.weight"),
where JAX keys by the flax tree's ``keystr``. The counts are of the
parameters and buffers of the state dict, as JAX's of its params tree:
pass ``dict(model.named_parameters())`` to leave the BatchNorm statistics
out, which JAX keeps in batch_stats.
"""

from __future__ import annotations

import torch


def _state(model_or_state) -> dict:
    if isinstance(model_or_state, torch.nn.Module):
        return model_or_state.state_dict()
    return dict(model_or_state)


def param_summary(model_or_state) -> str:
    """Per top-level module parameter counts in millions, then the total,
    one right-aligned line each, as JAX's summary prints them."""
    by_top: dict = {}
    total = 0
    for name, t in _state(model_or_state).items():
        top = name.split(".", 1)[0]
        by_top[top] = by_top.get(top, 0) + t.numel()
        total += t.numel()
    lines = [f"{k:>24s}: {by_top[k] / 1e6:8.2f} M" for k in sorted(by_top)]
    lines.append(f"{'TOTAL':>24s}: {total / 1e6:8.2f} M")
    return "\n".join(lines)


def check_parameter_shapes(model_or_state, expected: dict) -> list:
    """The mismatches of a {name: shape} subset against the state:
    (name, "missing", shape) or (name, actual shape, expected shape)."""
    shapes = {k: tuple(t.shape) for k, t in _state(model_or_state).items()}
    bad = []
    for k, shp in expected.items():
        if k not in shapes:
            bad.append((k, "missing", shp))
        elif shapes[k] != tuple(shp):
            bad.append((k, shapes[k], shp))
    return bad


def count_params(model_or_state) -> int:
    return int(sum(t.numel() for t in _state(model_or_state).values()))
