"""The fused frozen-BatchNorm kernel (``ops/bn_cuda.py``) and
`models/layers.py::FrozenBN`'s dispatch to it.

JAX-free, so that it runs on a machine with a card and no JAX:

    python -m pytest --noconftest -q -s tests/test_torch_bn_cuda.py

On the CPU: the dispatch keeps the plain chain (``bn.plain`` counted, the
output bit-equal to the upcast, ``F.batch_norm``, cast formula) for CPU
tensors, with autograd on or off; ``relu=True`` equals ``torch.relu`` of
the unfused output; the wrapper raises on a type, rank, layout, channel
count, parameter or device it does not take.

On the card: the dispatch takes the kernel with autograd off and the
plain chain with it on, frozen parameters or not; the kernel against the plain
chain and against the affine in float64 over C in {3, 64, 256, 2048} at
the trunk's maps of a 608x1024 frame and one odd map, B in {1, 8}, both
layouts, ReLU, scale, and the types FrozenBN passes (bf16, float32,
float32 into bf16, bf16 scale and bias), within
``chip_smoke.bn_compare``'s tolerances (float32 ulps of the terms the
affine adds: 6 against float64, from the kernel's six roundings; 12
against the plain chain, whose grouping differs and is not documented,
where the card read up to 7; bf16 outputs a bf16 ulp more); a bf16
ResNet-101 trunk at 608x1024 with the kernel against the same trunk on
the plain chain, both under the same grad mode and cuDNN's deterministic
algorithms, far closer than a trunk whose BatchNorms round toward zero.
The share of bit-equal elements is printed (``-s``)."""

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from chip_smoke import bn_compare
from lsfa_tpu_torch.models import layers
from lsfa_tpu_torch.models.layers import BN_EPS, BatchNorm, FrozenBN
from lsfa_tpu_torch.models.resnet import ResNetBackbone
from lsfa_tpu_torch.ops.bn_cuda import frozen_bn_cuda, frozen_bn_plain
from lsfa_tpu_torch.utils.profiler import tracing

# (C, H, W): bn_data on the frame, bn0 after the stem, stage 1 (bn2/bn3 at
# 64 and bn1 at 256), stage 3 (256 and 1024 in the trunk, 256 here), stage 4
# (2048), at 608x1024; then an odd map (C / 8 = 3 groups, planes of 627)
MAPS = [(3, 608, 1024), (64, 304, 512), (64, 152, 256), (256, 152, 256),
        (256, 38, 64), (2048, 38, 64), (24, 19, 33)]
# (x, FrozenBN.dtype, scale and bias): what FrozenBN passes the kernel. A
# bf16 fusion BatchNorm takes the float32 warped feature; parameters stored
# in bf16 (tpu.param_dtype) give bf16 scale and bias
TYPES = [(torch.bfloat16, torch.bfloat16, torch.float32),
         (torch.float32, torch.float32, torch.float32),
         (torch.float32, torch.bfloat16, torch.float32),
         (torch.bfloat16, torch.bfloat16, torch.bfloat16)]
# the bf16 trunk with the kernel is held to this share of the distance that
# rounding every BatchNorm toward zero puts between two plain trunks
TRUNK_SHARE = 0.5


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def seeded_bn(c, use_scale, dtype, device, seed, affine=torch.float32):
    """A FrozenBN of C channels with seeded statistics, scale and bias
    (stored in `affine`): for C = 3 bn_data's pixel statistics, else a
    trunk's."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    bn = FrozenBN(c, use_scale=use_scale, dtype=dtype)
    with torch.no_grad():
        if c == 3:
            bn.running_mean.copy_(117.0 + 5.0 * torch.randn(c, generator=g))
            bn.running_var.copy_((58.0 + 3.0 * torch.randn(c, generator=g)) ** 2)
        else:
            bn.running_mean.copy_(torch.randn(c, generator=g))
            bn.running_var.copy_(0.25 + 2.0 * torch.rand(c, generator=g))
        if use_scale:
            bn.weight.copy_(0.5 + torch.rand(c, generator=g))
        bn.bias.copy_(0.3 * torch.randn(c, generator=g))
    for p in bn.parameters():
        p.data = p.data.to(affine)
    return bn.to(device)


def seeded_input(bn, b, h, w, dtype, channels_last, seed):
    """x around each channel's statistics (pixels 0-255 for C = 3)."""
    dev = bn.running_mean.device
    g = torch.Generator(device=dev).manual_seed(seed)
    c = bn.running_mean.shape[0]
    if c == 3:
        x = torch.randint(0, 256, (b, c, h, w), generator=g, device=dev).float()
    else:
        shift = bn.running_mean + 0.1 * torch.randn(c, generator=g, device=dev)
        scale = bn.running_var.sqrt() * (0.8 + 0.4 * torch.rand(c, generator=g, device=dev))
        x = torch.randn((b, c, h, w), generator=g, device=dev) * scale[:, None, None] \
            + shift[:, None, None]
    x = x.to(dtype)
    return x.contiguous(memory_format=torch.channels_last) if channels_last else x


def today(bn, x):
    """FrozenBN's formula before the kernel, written out."""
    w = None if bn.weight is None else bn.weight.float()
    y = torch.nn.functional.batch_norm(x.float(), bn.running_mean, bn.running_var, w,
                                       bn.bias.float(), training=False, eps=BN_EPS)
    return y.to(bn.dtype)


# ---- on the CPU ----

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("use_scale", [True, False])
@pytest.mark.parametrize("grad", [False, True])
def test_dispatch_keeps_the_plain_path_on_the_cpu(dtype, use_scale, grad):
    bn = seeded_bn(16, use_scale, dtype, "cpu", 0)
    x = seeded_input(bn, 2, 5, 7, dtype, True, 1)
    with torch.set_grad_enabled(grad), tracing() as rec:
        y = bn(x)
        y_relu = bn(x, relu=True)
    assert rec.counters == {"bn.plain": 2}
    want = today(bn, x)
    assert y.dtype == dtype and torch.equal(y, want)
    assert torch.equal(y_relu, torch.relu(want))
    assert y.requires_grad == grad


@pytest.mark.parametrize("module", ["frozen", "batchnorm_eval", "batchnorm_train"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_relu_equals_relu_of_the_unfused_output(module, dtype):
    if module == "frozen":
        bn = seeded_bn(8, True, dtype, "cpu", 2)
    else:
        bn = BatchNorm(8, dtype=dtype).train(module == "batchnorm_train")
        bn.load_state_dict(seeded_bn(8, True, dtype, "cpu", 2).state_dict())
    x = seeded_input(seeded_bn(8, True, dtype, "cpu", 2), 2, 4, 6, dtype, False, 3)
    with torch.no_grad():
        stats = [b.clone() for b in bn.buffers()]
        fused = bn(x, relu=True)
        for b, s in zip(bn.buffers(), stats):
            b.copy_(s)              # train mode moves the running statistics per call
        unfused = bn(x)
    assert (fused < 0).sum() == 0 and (unfused < 0).sum() > 0
    assert torch.equal(fused, torch.relu(unfused))


def test_wrapper_raises_on_what_it_does_not_take():
    bn = seeded_bn(4, True, torch.float32, "cpu", 4)
    args = (bn.running_mean, bn.running_var, bn.weight, bn.bias, BN_EPS)
    x = torch.ones(2, 4, 3, 5)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        frozen_bn_cuda(x.half(), *args)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        frozen_bn_cuda(x, *args, dtype=torch.float64)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        frozen_bn_cuda(x.bfloat16(), *args, dtype=torch.float32)
    with pytest.raises(ValueError, match="NCHW-contiguous or channels-last"):
        frozen_bn_cuda(x.transpose(2, 3), *args)
    with pytest.raises(ValueError, match="shape"):
        frozen_bn_cuda(torch.ones(4), *args)
    with pytest.raises(ValueError, match="shape"):
        frozen_bn_cuda(torch.ones(2, 4, 3), *args)
    with pytest.raises(ValueError, match="shape"):
        frozen_bn_cuda(torch.ones(1, 4, 2, 3, 5), *args)
    wide = seeded_bn(4097, False, torch.float32, "cpu", 4)
    with pytest.raises(ValueError, match="at most 4096 channels"):
        frozen_bn_cuda(torch.ones(1, 4097, 1, 1), wide.running_mean, wide.running_var, None,
                       wide.bias, BN_EPS)
    with pytest.raises(ValueError, match="4 contiguous"):
        frozen_bn_cuda(x, bn.running_mean[:3], *args[1:])
    with pytest.raises(ValueError, match="4 contiguous"):
        frozen_bn_cuda(x, bn.running_mean.double(), *args[1:])
    with pytest.raises(ValueError, match="4 contiguous"):
        frozen_bn_cuda(x, bn.running_mean.bfloat16(), *args[1:])
    with pytest.raises(ValueError, match="4 contiguous"):    # scale and bias in two types
        frozen_bn_cuda(x, *args[:3], bn.bias.bfloat16(), BN_EPS)
    with pytest.raises(ValueError, match="4 contiguous"):
        frozen_bn_cuda(x, *args[:3], bn.bias.double(), BN_EPS)
    with pytest.raises(ValueError, match="CUDA tensor"):
        frozen_bn_cuda(x, *args)
    with pytest.raises(ValueError, match="CUDA tensor"):
        frozen_bn_cuda(x.contiguous(memory_format=torch.channels_last).bfloat16(), *args,
                       relu=True)
    with pytest.raises(ValueError, match="CUDA tensor"):    # float32 into bf16, bf16 affine
        frozen_bn_cuda(x, *args[:2], bn.weight.bfloat16(), bn.bias.bfloat16(), BN_EPS,
                       dtype=torch.bfloat16)


# ---- on the card ----

@pytest.mark.cuda
@pytest.mark.parametrize("no_grad,frozen,x_grad,fused", [
    (True, False, False, True),       # the eval entries
    (False, False, False, False),     # a BatchNorm that autograd records for its parameters
    (False, True, False, False),      # the frozen front of a training step
    (False, True, True, False),       # a frozen BatchNorm under a trained part
])
def test_dispatch_takes_the_kernel_with_autograd_off(cuda_device, no_grad, frozen, x_grad,
                                                     fused):
    bn = seeded_bn(16, True, torch.bfloat16, cuda_device, 5).requires_grad_(not frozen)
    x = seeded_input(bn, 2, 5, 7, torch.bfloat16, True, 6).requires_grad_(x_grad)
    with torch.set_grad_enabled(not no_grad), tracing() as rec:
        y = bn(x, relu=True)
    assert rec.counters == {"bn.fused" if fused else "bn.plain": 1}
    assert y.requires_grad == (not no_grad and not (frozen and not x_grad))
    want = frozen_bn_plain(x.detach(), bn.running_mean, bn.running_var, bn.weight.detach(),
                           bn.bias.detach(), BN_EPS, True, torch.bfloat16)
    if fused:
        share, worst, off_exact = bn_compare(x.detach(), y, want, bn.running_mean,
                                             bn.running_var, bn.weight.detach(),
                                             bn.bias.detach(), BN_EPS, True)
        assert max(worst, off_exact) <= 1.0
    else:
        assert torch.equal(y.detach(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("c,h,w", MAPS)
def test_kernel_matches_the_plain_chain(cuda_device, c, h, w, b):
    lines = []
    for x_dtype, dtype, affine in TYPES:
        for use_scale in (True, False):
            bn = seeded_bn(c, use_scale, dtype, cuda_device, c + b, affine)
            for channels_last in (True, False):
                x = seeded_input(bn, b, h, w, x_dtype, channels_last, 7 * c + b)
                for relu in (False, True):
                    want = frozen_bn_plain(x, bn.running_mean, bn.running_var, bn.weight,
                                           bn.bias, BN_EPS, relu, dtype)
                    got = frozen_bn_cuda(x, bn.running_mean, bn.running_var, bn.weight,
                                         bn.bias, BN_EPS, relu, dtype)
                    torch.cuda.synchronize()
                    assert got.dtype == dtype and got.shape == x.shape
                    assert got.stride() == x.stride()
                    share, worst, off_exact = bn_compare(
                        x, got, want, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                        BN_EPS, relu)
                    lines.append(f"{str(x_dtype)[6:]} to {str(dtype)[6:]}, affine "
                                 f"{str(affine)[6:]} scale={int(use_scale)} "
                                 f"cl={int(channels_last)} relu={int(relu)}: {share:.6f} equal, "
                                 f"worst {worst:.3f} of the tolerance against the plain chain, "
                                 f"{off_exact:.3f} against float64")
                    assert max(worst, off_exact) <= 1.0, lines[-1]
                    del got, want
            del x
    print(f"\nC={c} {h}x{w} B={b}:\n  " + "\n  ".join(lines))


def seeded_trunk(dtype, device):
    """ResNet-101 (no DCN) at stride 16 with seeded He weights (0.3 on
    each unit's last conv) and BatchNorm statistics near unit scale."""
    g = torch.Generator(device="cpu").manual_seed(11)
    net = ResNetBackbone(101, 16, dtype=dtype)
    with torch.no_grad():
        for name, mod in net.named_modules():
            if isinstance(mod, nn.Conv2d):
                fan_in = mod.weight[0].numel()
                gain = 0.3 if name.endswith("conv3") else 1.0
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=g)
                                 * gain * (2.0 / fan_in) ** 0.5)
            elif isinstance(mod, FrozenBN) and mod is not net.bn_data:
                c = mod.bias.shape[0]
                mod.running_mean.copy_(0.1 * torch.randn(c, generator=g))
                mod.running_var.copy_(0.5 + torch.rand(c, generator=g))
                mod.weight.copy_(0.8 + 0.4 * torch.rand(c, generator=g))
                mod.bias.copy_(0.1 * torch.randn(c, generator=g))
    return net.to(device).eval().requires_grad_(False)


def truncating_chain(x, mean, var, weight, bias, eps: float, relu: bool = False,
                     dtype: torch.dtype | None = None):
    """`frozen_bn_plain` with its float32 result rounded toward zero to
    bf16 (the low 16 bits cleared) instead of to nearest: every output up
    to one bf16 ulp off, all toward zero."""
    w = None if weight is None else weight.float()
    y = F.batch_norm(x.float(), mean, var, w, bias.float(), training=False, eps=eps)
    y = (y.view(torch.int32) & -65536).view(torch.float32).to(dtype)
    return torch.relu(y) if relu else y


@pytest.mark.cuda
def test_bf16_trunk_within_bf16_rounding(cuda_device, monkeypatch):
    """The bf16 trunk with the kernel against the same trunk on the plain
    chain, both under ``torch.no_grad`` and cuDNN's deterministic
    algorithms (the plain chain put in the kernel's place), so that only
    the BatchNorms differ: each output's relative distance to the plain
    one is within TRUNK_SHARE of the distance between the plain trunk and
    a trunk whose BatchNorms round toward zero. The kernel rounds to
    nearest and differs from the plain chain on a few elements a call
    (99.996-100% bit-equal); a kernel that rounded every output one way
    would read near 1."""
    x = torch.randn((1, 3, 608, 1024), generator=torch.Generator(device=cuda_device)
                    .manual_seed(5), device=cuda_device)
    x = x.contiguous(memory_format=torch.channels_last)
    net = seeded_trunk(torch.bfloat16, cuda_device)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    with torch.no_grad(), tracing() as rec:
        fused = net(x)
    assert rec.counters == {"bn.fused": 102}
    runs = {}
    for name, chain in (("plain", frozen_bn_plain), ("truncating", truncating_chain)):
        monkeypatch.setattr(layers, "frozen_bn_cuda", chain)
        with torch.no_grad():
            runs[name] = net(x)
    rel = lambda a, b: float((a.float() - b.float()).norm() / b.float().norm())  # noqa: E731
    lines, ratios = [], []
    for i, (k, p, t) in enumerate(zip(fused, runs["plain"], runs["truncating"])):
        assert torch.isfinite(k.float()).all()
        ratios.append(rel(k, p) / rel(t, p))
        lines.append(f"out {i} {tuple(k.shape)}: kernel vs plain {rel(k, p):.3e}, "
                     f"rounding toward zero vs plain {rel(t, p):.3e}, ratio {ratios[-1]:.4f}")
    print("\n" + "\n".join(lines))
    assert max(ratios) <= TRUNK_SHARE, "\n".join(lines)
