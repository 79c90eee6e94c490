"""Frozen BatchNorm with an optional ReLU: the plain version and the
binding of its CUDA kernel (``csrc/frozen_bn.cu``).

`frozen_bn_plain` is the chain `models/layers.py::FrozenBN` has always run
and still runs on the CPU and under autograd: upcast to float32,
``F.batch_norm`` on the running statistics, cast to the output dtype,
then ``torch.relu``. `frozen_bn_cuda` does the same in one kernel launch:
one read of x and one write of y, the affine in float32 and one rounding
to the output dtype. The source is compiled by ``nvcc`` for sm_90a on first
use (``ops/cuda_build.py``); a failed build raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from lsfa_tpu_torch.ops.cuda_build import CSRC, build_library

SOURCE = CSRC / "frozen_bn.cu"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
PEAK_BYTES = 3.35e12    # H100 SXM HBM3 (NVIDIA data sheet)

# the kernel's dtype bits (csrc/frozen_bn.cu): x bf16, y bf16, gamma and
# beta bf16
_X_BF16, _Y_BF16, _AFFINE_BF16 = 1, 2, 4
# x -> y: the same type, or float32 into a bf16 module (a fusion BatchNorm
# on the float32 warped feature)
_TYPES = {(torch.bfloat16, torch.bfloat16): _X_BF16 | _Y_BF16, (torch.float32, torch.float32): 0,
          (torch.float32, torch.bfloat16): _Y_BF16}
MAX_C = 4096    # the any route's table of constants in shared memory

_lib = None


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    lib = build_library(SOURCE, NVCC_FLAGS, "frozen_bn")
    fn = lib.frozen_bn_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                                           ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _lib = lib
    return lib


def bn_bytes(x: torch.Tensor, dtype: torch.dtype) -> int:
    """The pass's bytes: x read once, y (in `dtype`) written once, and at
    most four float32 values a channel read once."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return x.numel() * (x.element_size() + itemsize) + 16 * x.shape[1]


def bn_bound_ms(x: torch.Tensor, dtype: torch.dtype) -> float:
    """The least time of the pass on an H100: `bn_bytes` at PEAK_BYTES."""
    return bn_bytes(x, dtype) / PEAK_BYTES * 1e3


def frozen_bn_plain(x, mean, var, weight, bias, eps: float, relu: bool = False,
                    dtype: torch.dtype | None = None):
    """BatchNorm of x (N, C, ...) on running statistics in float32, the
    result cast to `dtype` (x's by default), then ReLU if `relu`."""
    w = None if weight is None else weight.float()
    y = F.batch_norm(x.float(), mean, var, w, bias.float(), training=False, eps=eps)
    y = y.to(x.dtype if dtype is None else dtype)
    return torch.relu(y) if relu else y


def frozen_bn_cuda(x, mean, var, weight, bias, eps: float, relu: bool = False,
                   dtype: torch.dtype | None = None, empty: bool = False):
    """`frozen_bn_plain` in one kernel launch on x's card, enqueued on the
    current stream without synchronizing; the output, in `dtype`, has x's
    strides. x (N, C, H, W) NCHW-contiguous or channels-last, C <= MAX_C;
    x -> `dtype` bfloat16 -> bfloat16, float32 -> float32 or float32 ->
    bfloat16; mean and var C float32 values, bias and weight (or None) C
    values in float32 or both in bfloat16, contiguous, on x's card. Raises
    on anything else. With `empty` the launch runs an empty kernel on the
    same grid and leaves the output unwritten: the launch's own floor, to
    measure."""
    dtype = x.dtype if dtype is None else dtype
    bits = _TYPES.get((x.dtype, dtype))
    if bits is None:
        raise TypeError(f"frozen_bn_cuda takes bfloat16 or float32 to the same type, or float32 "
                        f"to bfloat16, got {x.dtype} to {dtype}")
    if x.dim() != 4:
        raise ValueError(f"need x (N, C, H, W), got shape {tuple(x.shape)}")
    _, c, h, w = x.shape
    # the strides compared first: is_contiguous(memory_format=...) costs
    # microseconds of host time a call
    if x.stride() == (h * w * c, 1, w * c, c):
        inner = 1
    elif x.is_contiguous():
        inner = h * w
    elif x.is_contiguous(memory_format=torch.channels_last):
        inner = 1
    else:
        raise ValueError(f"x must be NCHW-contiguous or channels-last, got strides {x.stride()}")
    if c > MAX_C:
        raise ValueError(f"frozen_bn_cuda takes at most {MAX_C} channels, got {c}")
    index = x.get_device()
    affine = bias.dtype
    if affine == torch.bfloat16:
        bits |= _AFFINE_BF16
    ptrs = []
    for i, (p, want) in enumerate(((mean, torch.float32), (var, torch.float32),
                                   (weight, affine), (bias, affine))):
        if p is None and i == 2:       # no scale
            ptrs.append(None)
            continue
        if (p is None or p.dtype != want or want not in (torch.float32, torch.bfloat16)
                or p.shape != (c,) or p.get_device() != index or not p.is_contiguous()):
            raise ValueError(f"mean and var must be {c} contiguous float32 values and weight and "
                             f"bias {c} of float32 or both of bfloat16, on {x.device}; got "
                             f"{None if p is None else (p.dtype, tuple(p.shape), str(p.device))}")
        ptrs.append(p.data_ptr())
    if not x.is_cuda:
        raise ValueError(f"frozen_bn_cuda needs a CUDA tensor, got one on {x.device}")
    out = torch.empty_like(x, dtype=dtype)     # x's strides: x is dense
    n = x.numel()
    if n == 0:
        return out
    err = (_lib or build()).frozen_bn_launch(
        x.data_ptr(), out.data_ptr(), *ptrs, bits, n, c, inner, int(relu), eps, int(empty),
        index, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"frozen_bn launch failed with CUDA error {err}")
    return out
