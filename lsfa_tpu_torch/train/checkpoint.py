"""Checkpoints over ``torch.save``, and the state-dict merges of the
pretrained init; the counterparts of ``lsfa_tpu.train.checkpoint``.

A checkpoint is ``<dir>/<epoch>.pt`` holding the model's and optimizer's
state dicts, the scheduler's, the trainer's step count and generator state,
and the epoch. `seed_small_net` copies the main backbone's weights into the
small-net trunk (the reference initializes small_net_* from the backbone);
`combine_checkpoints` merges pretrained sub-state-dicts by name and shape;
`import_torch_resnet` takes the convolutions of a torchvision ResNet.
"""

from __future__ import annotations

import os
import re

import torch

from lsfa_tpu_torch.parallel.tensor_parallel import is_sharded

_RUNNING = ("running_mean", "running_var")
_UNIT_CONV = re.compile(r"stage(\d)_unit(\d+)\.(conv[123]|sc)\.weight")


def _path(path: str, epoch: int) -> str:
    return os.path.join(path, f"{epoch}.pt")


def save_checkpoint(path: str, epoch: int, model, optimizer, scheduler, step: int,
                    rng_state):
    """Write <path>/<epoch>.pt (written to a temporary name, then renamed).
    optimizer and scheduler may be None (saved as None). Raises ValueError
    for a model under `parallel.shard_params`, whose state dict holds one
    rank's shards under the full model's names."""
    if is_sharded(model):
        raise ValueError("save_checkpoint of a tensor-parallel model would write one rank's "
                         "shards under the full model's names; save the unsharded model")
    os.makedirs(path, exist_ok=True)
    state = {"epoch": epoch, "step": step, "model": model.state_dict(),
             "optimizer": None if optimizer is None else optimizer.state_dict(),
             "scheduler": None if scheduler is None else scheduler.state_dict(),
             "rng_state": rng_state}
    tmp = _path(path, epoch) + f".{os.getpid()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, _path(path, epoch))


def latest_step(path: str) -> int | None:
    """Latest saved epoch under `path`, or None when nothing is saved."""
    if not os.path.isdir(path):
        return None
    epochs = [int(f[:-3]) for f in os.listdir(path)
              if f.endswith(".pt") and f[:-3].isdigit()]
    return max(epochs) if epochs else None


def load_checkpoint(path: str, epoch: int | None = None):
    """Load a checkpoint (the latest when epoch is None) onto the CPU.
    Returns (state dict as saved, epoch)."""
    epoch = latest_step(path) if epoch is None else epoch
    if epoch is None:
        raise FileNotFoundError(f"no checkpoint under {path}")
    return torch.load(_path(path, epoch), map_location="cpu", weights_only=True), epoch


def seed_small_net(state: dict) -> dict:
    """Copy main-backbone weights into the small-net trunk wherever names
    and shapes match. As in the JAX package only parameters are copied,
    not BatchNorm running statistics; a state dict with no small-net trunk
    (the R-FCN's) comes back unchanged. Returns a new state dict."""
    out = dict(state)
    src, dst = "backbone.", "small_net_backbone."
    for key in state:
        if not key.startswith(dst) or key.endswith(_RUNNING):
            continue
        s = src + key[len(dst):]
        if s in state and state[s].shape == state[key].shape:
            out[key] = state[s].clone()
    return out


def combine_checkpoints(state: dict, sources: dict) -> tuple[dict, int]:
    """Merge pretrained sub-state-dicts into `state`.

    sources: {top-level module name: its state dict, keyed below that
    name}. Entries are copied where the full name exists in `state` with
    the same shape. Returns (new state dict, number copied)."""
    out = dict(state)
    copied = 0
    for top, sub in sources.items():
        for k, v in sub.items():
            full = f"{top}.{k}"
            if full in out and tuple(v.shape) == tuple(out[full].shape):
                out[full] = v
                copied += 1
    return out, copied


def import_torch_resnet(state: dict, state_dict: dict, prefix: str = "backbone"):
    """Map a torchvision ResNet state_dict onto the `prefix` trunk of a
    model's state dict. Returns (new state dict, number imported).

    A secondary warm start: for the reference's pretrained weights use
    ``train.import_mxnet.import_mxnet_lsfa``, which also reads the
    BatchNorm running statistics. torchvision's ResNets are
    post-activation (v1) and the trunk here is pre-activation (v2), so
    their BatchNorms pair differently: this imports the stem conv
    (``conv1``) and each unit's convs by position (``layer{s}.{u}.conv{c}``,
    ``downsample.0``) where the shapes match, and leaves BatchNorm at
    init; callers check the count."""
    out = dict(state)
    imported = 0
    for key in state:
        if not key.startswith(prefix + "."):
            continue
        rest = key[len(prefix) + 1:]
        m = _UNIT_CONV.fullmatch(rest)
        if rest == "conv0.weight":
            src = "conv1.weight"
        elif m:
            s, u, conv = m.groups()
            src = f"layer{s}.{int(u) - 1}.{'downsample.0' if conv == 'sc' else conv}.weight"
        else:
            continue
        if src in state_dict and tuple(state_dict[src].shape) == tuple(state[key].shape):
            out[key] = torch.as_tensor(state_dict[src], dtype=torch.float32).clone()
            imported += 1
    return out, imported
