"""Parallelism over ``torch.distributed``: data parallelism (`mesh`) and
tensor parallelism of the head stack (`tensor_parallel`, whose
`make_tp_mesh`, `tensor_parallel_specs` and `shard_params` this package
exports)."""

_TENSOR_PARALLEL = ("make_tp_mesh", "tensor_parallel_specs", "shard_params")
__all__ = ["mesh", "tensor_parallel", *_TENSOR_PARALLEL]


def __getattr__(name):
    # imported on first use: tensor_parallel subclasses models.layers.Conv,
    # and models.layers imports this package's mesh
    if name in _TENSOR_PARALLEL:
        from lsfa_tpu_torch.parallel import tensor_parallel

        return getattr(tensor_parallel, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
