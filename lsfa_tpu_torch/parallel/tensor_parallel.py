"""Tensor parallelism of the head stack over a ("data", "model") mesh; the
counterpart of ``make_tp_mesh``, ``tensor_parallel_specs`` and
``shard_params`` in ``lsfa_tpu.parallel.mesh``.

The JAX package places the variables by PartitionSpecs and XLA's SPMD
pass inserts every collective. PyTorch has no such pass, and its
``parallelize_module`` styles shard ``nn.Linear`` and ``nn.Embedding``,
not convolutions, so `shard_params` swaps the five convolutions of the
head stack for modules that hold only their rank's shard and make their
collectives themselves:

- ``feat_conv_3x3`` (`ColumnParallelConv`, the 1024-channel DFF feature):
  rank r of n convolves into output channels [rF/n, (r+1)F/n), and the
  feature is gathered whole over the "model" group. Long-term
  aggregation, the float32 key-feature carry and ``forward_cur``'s input
  need it whole.
- the four 1x1 heads ``rpn_cls_score``, ``rpn_bbox_pred``, ``rfcn_cls``
  and ``rfcn_bbox`` (`RowParallelConv`): rank r takes input channels
  [rC/n, (r+1)C/n) of the head's input (a half of the whole feature) and
  convolves them without bias; the partial outputs are summed over the
  group in float32, the bias is added once, after the sum, and the sum is
  cast to the head's compute dtype.

The JAX docstring says no resharding happens between the two; it does:
rank r's feature block [rF/n, (r+1)F/n) is not the rank's slice
[r(F/2)/n, (r+1)(F/2)/n) of either half, and XLA reshards. Here the
heads slice the gathered feature. Every rank of a "model" group then
holds the same maps and runs proposals and NMS on them, as the SPMD
program does.

The collectives are differentiable, with the gradients of one loss that
every rank of a "model" group computes alike (the f and g operators of
Megatron-LM's tensor parallelism): ``feat_conv_3x3``'s input sums its
gradient over the group, the gather's backward keeps the rank's block of
the incoming gradient, a head's input slice gathers its gradient back to
full width, and the sum's backward passes the gradient through. So each rank gets the full model's gradient of its
shard and of the replicated parameters. Training under a 2-D mesh is not
wired up: ``parallel.mesh``'s data-parallel helpers reduce over the whole
world, not over the "data" group.

The "data" axis splits a batch with ``mesh.shard_batch(batch,
device_mesh.get_local_rank("data"), device_mesh.size(0))``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from lsfa_tpu_torch.models.layers import Conv, _precision

# JAX's _TP_OUT_MODULES and _TP_IN_MODULES: the conv whose output channels
# shard, and the four that contract the matching channels
TP_OUT_MODULES = ("feat_conv_3x3",)
TP_IN_MODULES = ("rpn_cls_score", "rpn_bbox_pred", "rfcn_cls", "rfcn_bbox")


def make_tp_mesh(n_model: int, n_data: int | None = None) -> DeviceMesh:
    """The (n_data, n_model) mesh named ("data", "model") over the default
    process group's ranks. n_data None means world // n_model. Its device
    type follows the group's backend: "cuda" under NCCL, "cpu" under gloo
    (whose ranks may still hold CUDA tensors). Raises RuntimeError without
    a process group and ValueError where n_data * n_model is not the world
    size."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_tp_mesh needs a process group: call "
                           "parallel.mesh.initialize_distributed first")
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_model < 1 or n_data < 1 or n_data * n_model != world:
        raise ValueError(f"a ({n_data}, {n_model}) mesh does not cover the {world} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_data, n_model), mesh_dim_names=("data", "model"))


def tensor_parallel_specs(model_or_state_dict) -> dict:
    """{state_dict name: Shard(dim) or Replicate()} by JAX's rule in
    torch's OIHW layout: ``feat_conv_3x3``'s weight and bias shard their
    output channels (Shard(0); JAX's P(None, None, None, axis) on HWIO and
    P(axis)), the four heads' weights their input channels (Shard(1);
    JAX's P(None, None, axis, None)), and everything else is replicated.
    Modules are matched by the last component of their name, as JAX
    matches the parent key, so the rule holds for the LSFA and the R-FCN
    of any trunk."""
    state = (model_or_state_dict.state_dict() if isinstance(model_or_state_dict, nn.Module)
             else model_or_state_dict)
    specs = {}
    for name, t in state.items():
        *path, leaf = name.split(".")
        mod = path[-1] if path else ""
        if mod in TP_OUT_MODULES and ((leaf == "weight" and t.ndim == 4)
                                      or (leaf == "bias" and t.ndim == 1)):
            specs[name] = Shard(0)
        elif mod in TP_IN_MODULES and leaf == "weight" and t.ndim == 4:
            specs[name] = Shard(1)
        else:
            specs[name] = Replicate()
    return specs


def _all_gather_channels(x, group, n):
    """Every rank's `x` (NCHW), concatenated over the group on channels,
    in the memory format of `x` (the convolutions that read the gathered
    feature then see the layout the unsharded conv's output has, and sum
    in the same order)."""
    channels_last = x.is_contiguous(memory_format=torch.channels_last) and not x.is_contiguous()
    x = x.contiguous(memory_format=torch.channels_last if channels_last else
                     torch.contiguous_format)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=1)


class _GatherChannels(torch.autograd.Function):
    """Forward: every rank's channel block, concatenated over the group.
    Backward: the rank's block of the gradient."""

    @staticmethod
    def forward(ctx, x, group, rank, n):
        ctx.rank, ctx.c = rank, x.shape[1]
        return _all_gather_channels(x, group, n)

    @staticmethod
    def backward(ctx, grad):
        return grad[:, ctx.rank * ctx.c:(ctx.rank + 1) * ctx.c], None, None, None


class _SliceChannels(torch.autograd.Function):
    """Forward: the rank's channel slice of a tensor every rank holds
    whole. Backward: every rank's slice of the gradient, concatenated."""

    @staticmethod
    def forward(ctx, x, group, rank, n):
        ctx.group, ctx.n = group, n
        c = x.shape[1] // n
        return x[:, rank * c:(rank + 1) * c]

    @staticmethod
    def backward(ctx, grad):
        return _all_gather_channels(grad, ctx.group, ctx.n), None, None, None


class _ToGroup(torch.autograd.Function):
    """Forward: the tensor as it is, input to a rank's shard of a conv.
    Backward: the gradient summed over the group (every rank's shard
    contributes to the input's gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        # an alias, not `x` itself: autograd re-views a returned input, which
        # resets the strides of size-1 dims and can move the conv that
        # follows off a channels-last layout (another summation order)
        return x.detach()

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _SumOverGroup(torch.autograd.Function):
    """Forward: the sum over the group. Backward: the gradient as it is
    (every rank computes the same loss from the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _shard_of(conv: Conv, weight: torch.Tensor, bias, cls, **kw):
    """A `cls` of `conv`'s hyperparameters holding `weight` and `bias`."""
    tp = cls(weight.shape[1] * conv.groups, weight.shape[0], conv.kernel_size[0],
             stride=conv.stride[0], dilate=conv.dilation[0], bias=False, dtype=conv.dtype,
             init=conv.init, groups=conv.groups, device="meta", **kw)
    tp.weight = nn.Parameter(weight.detach().clone(), requires_grad=conv.weight.requires_grad)
    if bias is not None:
        tp.bias = nn.Parameter(bias.detach().clone(), requires_grad=conv.bias.requires_grad)
    return tp


class _ShardedConv(Conv):
    """A `Conv` holding model rank `rank`'s shard of n, whose forward calls
    collectives over `group` (every rank of the group must call it)."""

    def __init__(self, *args, group=None, rank: int = 0, n: int = 1, **kw):
        super().__init__(*args, **kw)
        self.group, self.rank, self.n = group, rank, n


class ColumnParallelConv(_ShardedConv):
    """Output channels [rank * c, (rank + 1) * c) of a conv of c * n
    outputs; its output is the whole conv's, gathered over the group."""

    def forward(self, x):
        y = super().forward(_ToGroup.apply(x, self.group))
        return _GatherChannels.apply(y, self.group, self.rank, self.n)


class RowParallelConv(_ShardedConv):
    """Input channels [rank * c, (rank + 1) * c) of a conv of c * n inputs,
    and the whole bias. It takes the whole input, convolves its slice
    without bias, sums the partial outputs over the group in float32, adds
    the bias once and returns the compute dtype."""

    def forward(self, x):
        d = self.dtype
        xs = _SliceChannels.apply(x, self.group, self.rank, self.n)
        with _precision(d):
            partial = self._conv_forward(xs.to(d), self.weight.to(d), None)
        y = _SumOverGroup.apply(partial.float(), self.group)
        if self.bias is not None:
            y = y + self.bias.to(d).float()[:, None, None]
        return y.to(d)


def is_sharded(model: nn.Module) -> bool:
    """Whether `shard_params` has swapped a module of `model`."""
    return any(isinstance(m, _ShardedConv) for m in model.modules())


def shard_params(mesh: DeviceMesh, model: nn.Module, specs: dict):
    """Shard `model` in place by `specs` (`tensor_parallel_specs`) over the
    mesh's "model" dimension: each conv whose weight is Shard(0) becomes a
    `ColumnParallelConv` (its bias Shard(0) too), each whose weight is
    Shard(1) a `RowParallelConv` (its bias replicated), holding this
    rank's shard of the weights it had; the state_dict names stay. Load
    the weights before sharding. Returns the model.

    Raises RuntimeError without a process group, and ValueError where
    the "model" size does not divide feat_dim // 2 or a spec shards
    anything else."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("shard_params needs a process group: call "
                           "parallel.mesh.initialize_distributed first")
    if is_sharded(model):
        raise ValueError("the model is sharded already")
    group, rank, n = mesh.get_group("model"), mesh.get_local_rank("model"), mesh.size(
        mesh.mesh_dim_names.index("model"))
    half = model.feat_dim // 2
    if half % n:
        raise ValueError(f"{n} model ranks do not divide feat_dim // 2 = {half}")
    modules = dict(model.named_modules())
    swaps = {}
    for name, spec in specs.items():
        if not isinstance(spec, Shard):
            continue
        mod, leaf = name.rsplit(".", 1)
        conv = modules.get(mod)
        col = leaf == "weight" and spec.dim == 0
        if not (type(conv) is Conv and (col or (leaf == "weight" and spec.dim == 1)
                                        or (leaf == "bias" and spec.dim == 0))):
            raise ValueError(f"shard_params shards the weights of a Conv over dim 0 or 1, "
                             f"not {name} over {spec}")
        if leaf == "weight":
            swaps[mod] = (conv, col)
    shards = {}
    for mod, (conv, col) in swaps.items():         # every check before the first swap
        bias_spec = specs.get(mod + ".bias")
        if conv.bias is not None and isinstance(bias_spec, Shard) != col:
            raise ValueError(f"{mod}.bias must be {'Shard(0)' if col else 'Replicate()'}")
        w, b = conv.weight, conv.bias
        c, left = divmod(w.shape[0 if col else 1], n)
        if left:
            raise ValueError(f"{n} model ranks do not divide {mod}'s "
                             f"{'output' if col else 'input'} channels")
        if col:
            w, b = w[rank * c:(rank + 1) * c], None if b is None else b[rank * c:(rank + 1) * c]
        else:
            w = w[:, rank * c:(rank + 1) * c]
        shards[mod] = (conv, w, b, ColumnParallelConv if col else RowParallelConv)
    for mod, (conv, w, b, cls) in shards.items():
        parent, _, attr = mod.rpartition(".")
        setattr(modules[parent] if parent else model, attr,
                _shard_of(conv, w, b, cls, group=group, rank=rank, n=n))
    return model
