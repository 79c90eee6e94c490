"""Shared building blocks, NCHW inside the models.

Parameters are float32 (flax's param_dtype) unless the trainer stores
them lower (``tpu.param_dtype``); a layer casts its input and weights to
its compute `dtype` when it runs, as a flax layer with `dtype=bfloat16`
does, and the BatchNorms read their scale and bias in float32. BatchNorm computes in float32 (eps 2e-5) and
returns its compute dtype; `FrozenBN` always uses its running statistics,
`BatchNorm` (the R-net's and the small-net fusion's) uses batch
statistics in training mode.

Each conv carries the name of its initializer (`init`), which
``models/lsfa.py::init_params`` reads to draw weights without JAX.

Padding: `Conv` pads as MXNet does, symmetrically; `SameConv` pads as
flax's ``padding="SAME"`` does, which the MobileNet trunks use. For a
stride-2 3x3 on an even input SAME pads 0 before and 1 after, so a
symmetric pad of 1 gives the same output size with every sample one pixel
off.

A float32 convolution (every conv of a float32 config, and the DCN offset
convs of any config) runs in full float32: on a card torch's default for
cuDNN convolutions is TF32 (10 mantissa bits), so `Conv` and `Deconv2x`
enter `full_float32` around a float32 call. Nothing is set at import.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from lsfa_tpu_torch.ops.bn_cuda import frozen_bn_cuda, frozen_bn_plain
from lsfa_tpu_torch.parallel import mesh
from lsfa_tpu_torch.utils.profiler import count

BN_EPS = 2e-5
BN_MOMENTUM = 0.9


@contextlib.contextmanager
def full_float32():
    """Convolutions inside run in full float32, not TF32: clears
    ``torch.backends.cudnn.allow_tf32`` and restores the caller's setting
    on exit. The flag is process-wide, so convolutions that other threads
    enqueue meanwhile see it too."""
    allowed = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = allowed


def _precision(dtype):
    """The context a convolution computing in `dtype` runs under."""
    return full_float32() if dtype is torch.float32 else contextlib.nullcontext()


def mx_pad(kernel: int, dilate: int = 1) -> int:
    """MXNet's symmetric pad for an odd kernel, ((k-1)*d+1)//2 per side —
    torch's `padding=p`, never "same" (which splits an odd total pad
    unevenly for stride 2)."""
    return ((kernel - 1) * dilate + 1) // 2


class Conv(nn.Conv2d):
    """Conv2d with MXNet symmetric padding, computing in `dtype`; groups
    as torch's (groups == cin is a depthwise conv).

    init: "lecun" (flax's default, truncated normal with fan-in variance),
    "he", "msra" (flax's variance_scaling(2, fan_in, "normal"): an
    untruncated normal), "normal01" (N(0, 0.01), the reference's init for
    new heads), "zeros", or "scale_map" (weight 0, bias 1)."""

    def __init__(self, cin: int, cout: int, kernel: int = 1, stride: int = 1,
                 dilate: int = 1, bias: bool = True, dtype=torch.float32,
                 init: str = "lecun", groups: int = 1, device=None):
        super().__init__(cin, cout, kernel, stride=stride, padding=mx_pad(kernel, dilate),
                         dilation=dilate, groups=groups, bias=bias, device=device)
        self.dtype = dtype
        self.init = init

    def forward(self, x):
        d = self.dtype
        bias = None if self.bias is None else self.bias.to(d)
        with _precision(d):
            return self._conv_forward(x.to(d), self.weight.to(d), bias)


def same_pads(n: int, kernel: int, stride: int, dilate: int) -> tuple[int, int]:
    """flax/XLA "SAME" padding of one axis of size n: (before, after),
    the odd unit of the total after."""
    total = max((math.ceil(n / stride) - 1) * stride + (kernel - 1) * dilate + 1 - n, 0)
    return total // 2, total - total // 2


class SameConv(Conv):
    """`Conv` with flax's ``padding="SAME"``: pads each axis by `same_pads`
    of its size (the odd unit after), then convolves unpadded."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.padding = (0, 0)

    def forward(self, x):
        (k, _), (s, _), (d, _) = self.kernel_size, self.stride, self.dilation
        top, bottom = same_pads(x.shape[-2], k, s, d)
        left, right = same_pads(x.shape[-1], k, s, d)
        return super().forward(F.pad(x, (left, right, top, bottom)))


class Deconv2x(nn.ConvTranspose2d):
    """4x4 stride-2 transposed conv giving exactly 2x the spatial size: a
    VALID transposed conv yields 2*in + 2, and one border row/col is
    cropped on each side (the reference's Deconvolution + Crop pair)."""

    def __init__(self, cin: int, cout: int, dtype=torch.float32, device=None):
        super().__init__(cin, cout, 4, stride=2, bias=True, device=device)
        self.dtype = dtype
        self.init = "lecun"

    def forward(self, x):
        d = self.dtype
        with _precision(d):
            y = F.conv_transpose2d(x.to(d), self.weight.to(d), self.bias.to(d), stride=2)
        return y[..., 1:-1, 1:-1]


class FrozenBN(nn.Module):
    """BatchNorm on running statistics; float32 math, output in `dtype`,
    then ReLU if the caller asks (``forward(x, relu=True)``).

    A CUDA tensor with autograd off (the eval entries run under
    ``torch.no_grad``) takes the fused kernel (``ops/bn_cuda.py``: one
    launch, one rounding to `dtype`). Every other call runs the plain chain
    of upcast, ``F.batch_norm``, cast and ``torch.relu``: the CPU, and a
    training step, frozen BatchNorms included, whose float32 results on
    the card then round as the CPU's do. Each call counts ``bn.fused`` or
    ``bn.plain``."""

    def __init__(self, features: int, use_scale: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features, device=device)) if use_scale else None
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))

    def forward(self, x, relu: bool = False):
        if x.is_cuda and not torch.is_grad_enabled():
            count("bn.fused")
            return frozen_bn_cuda(x, self.running_mean, self.running_var, self.weight,
                                  self.bias, BN_EPS, relu, self.dtype)
        count("bn.plain")
        return frozen_bn_plain(x, self.running_mean, self.running_var, self.weight,
                               self.bias, BN_EPS, relu, self.dtype)


class BatchNorm(FrozenBN):
    """BatchNorm with flax's training semantics (``nn.BatchNorm`` at
    momentum 0.9, the JAX package's `BatchNorm(frozen=False)`): in
    training mode it normalizes with the float32 batch mean and biased
    variance over (N, H, W), the variance as E[x^2] - E[x]^2 clamped at 0,
    and moves the running statistics to 0.9 * running + 0.1 * batch; in
    eval mode it is a FrozenBN. The update is computed here, because
    F.batch_norm would move running_var by the unbiased variance.

    The batch is the global one, as in the JAX step over a mesh: the
    per-channel sums of x and x^2 and the element count are summed over
    the ranks of the process group in one all-reduce that carries the
    gradient (``mesh.sum_over_ranks_with_grad``; the identity without a
    group). Every rank calls every train-mode BatchNorm of the model once
    per step, in the same order, forward and backward: no branch of the
    model skips one on its data."""

    def forward(self, x, relu: bool = False):
        if not self.training:
            return super().forward(x, relu)
        xf = x.float()
        c = xf.shape[1]
        count = torch.full((1,), xf.numel() // c, dtype=torch.float32, device=xf.device)
        sums = mesh.sum_over_ranks_with_grad(
            torch.cat([xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3)), count]))
        mean = sums[:c] / sums[-1]
        var = torch.clamp(sums[c:2 * c] / sums[-1] - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=1.0 - BN_MOMENTUM)
            self.running_var.mul_(BN_MOMENTUM).add_(var, alpha=1.0 - BN_MOMENTUM)
        mul = torch.rsqrt(var + BN_EPS) * self.weight.float()
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias.float()[:, None, None]
        y = y.to(self.dtype)
        return torch.relu(y) if relu else y


def avg_pool(x, window: int):
    return F.avg_pool2d(x, window, window)


def max_pool_3x3_s2(x):
    """MXNet pool(kernel=3, stride=2, pad=1)."""
    return F.max_pool2d(x, 3, 2, padding=1)


def leaky_relu(x, slope: float = 0.1):
    return F.leaky_relu(x, slope)


def relu6(x):
    return F.relu6(x)


def global_avg_pool(x):
    """Mean over H and W of an NCHW tensor, kept as 1x1."""
    return x.mean(dim=(2, 3), keepdim=True)
