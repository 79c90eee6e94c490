"""Checkpoints over ``torch.save``, and the state-dict merges of the
pretrained init; the counterparts of ``lsfa_tpu.train.checkpoint``.

A checkpoint is ``<dir>/<epoch>.pt`` holding the model's and optimizer's
state dicts, the scheduler's, the trainer's step count and generator state,
and the epoch. `seed_small_net` copies the main backbone's weights into the
small-net trunk (the reference initializes small_net_* from the backbone);
`combine_checkpoints` merges pretrained sub-state-dicts by name and shape.
"""

from __future__ import annotations

import os

import torch

_RUNNING = ("running_mean", "running_var")


def _path(path: str, epoch: int) -> str:
    return os.path.join(path, f"{epoch}.pt")


def save_checkpoint(path: str, epoch: int, model, optimizer, scheduler, step: int,
                    rng_state):
    """Write <path>/<epoch>.pt (written to a temporary name, then renamed)."""
    os.makedirs(path, exist_ok=True)
    state = {"epoch": epoch, "step": step, "model": model.state_dict(),
             "optimizer": optimizer.state_dict(), "scheduler": scheduler.state_dict(),
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
    not BatchNorm running statistics. Returns a new state dict."""
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
