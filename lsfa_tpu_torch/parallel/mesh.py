"""Data parallelism over ``torch.distributed``; the counterpart of
``lsfa_tpu.parallel.mesh``.

The JAX package runs one jitted train step over a mesh: the global batch
is sharded over the devices, parameters are replicated and XLA inserts the
gradient all-reduce. Here one process drives each device and these helpers
give the same semantics: every rank holds the whole model
(`broadcast_parameters`), trains on its contiguous rows of the global
batch (`shard_batch`, or a ``data.loader.TrainLoader`` built with the
rank), normalizes its losses by counts over the global batch
(`sum_over_ranks`, without gradient; the train-mode BatchNorm's moments
through `sum_over_ranks_with_grad`) and sums the gradients
(`all_reduce_gradients`) before the optimizer's step, so that every rank
applies the one update the single-process step on the global batch gives.

The train step calls ``model.forward_train``, not ``model(...)``, so a
``DistributedDataParallel`` wrapper's hooks would never fire: the step
reduces the gradients itself, after ``backward()``.

With no process group (one process) every helper is the identity; with a
group of one rank the collectives run. They reduce over the whole world:
under a ("data", "model") mesh they would sum over the model ranks too,
so training under tensor parallelism is not wired up. The JAX package's
tensor-parallel helpers are in ``parallel/tensor_parallel.py``.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def initialize_distributed(coordinator: str | None = None, num_processes: int | None = None,
                           process_id: int | None = None, device=None) -> torch.device:
    """Join the process group and return the device this rank trains on.

    device: the rank's device; None means the card numbered LOCAL_RANK
    (0 when unset; raises without a card). The backend is NCCL on a card
    (raises where NCCL is not available: there is no fallback) and gloo on
    the CPU. coordinator: None reads ``env://`` (torchrun's MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE and RANK); else "host:port", with
    num_processes and process_id."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA card is available: pass device='cpu' for gloo on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        if not dist.is_nccl_available():
            raise RuntimeError("NCCL is not available in this torch build")
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        backend = "gloo"
    if coordinator is None:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id)
    return device


def active() -> bool:
    """Whether a process group is initialized."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def shard_batch(batch: dict, rank: int, world: int) -> dict:
    """Rank `rank`'s contiguous rows of every entry of a global batch."""
    n = len(next(iter(batch.values())))
    if n % world:
        raise ValueError(f"a global batch of {n} does not split over {world} ranks")
    b = n // world
    return {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}


def broadcast_parameters(model: torch.nn.Module):
    """Rank 0's parameters and buffers on every rank."""
    if active():
        with torch.no_grad():
            for t in list(model.parameters()) + list(model.buffers()):
                dist.broadcast(t.data, 0)


def sum_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """`t` summed over the ranks, without gradient (a new tensor; `t`
    itself without a process group)."""
    if not active():
        return t
    out = t.detach().clone()
    dist.all_reduce(out)
    return out


def sum_over_ranks_with_grad(t: torch.Tensor) -> torch.Tensor:
    """`t` summed over the ranks, differentiably: the backward sums the
    incoming gradients over the ranks too (`t` itself without a process
    group). Every rank must make the same calls in the same order."""
    if not active():
        return t
    import torch.distributed.nn.functional as dist_fn

    return dist_fn.all_reduce(t)


def all_reduce_gradients(model: torch.nn.Module):
    """Sum the gradients of the trainable parameters over the ranks, in
    one flat all-reduce. Frozen parameters (requires_grad False) are
    skipped; every rank must give the same parameters a gradient."""
    if not active():
        return
    grads = [p.grad for p in model.parameters() if p.requires_grad and p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def barrier():
    if active():
        dist.barrier()
