"""forward_train of every variant of ``tests/test_torch_variants.py`` in
training mode against the JAX package, with the train-mode BatchNorms'
updated running statistics. Tiny models, float32; the maps at
``test_torch_variants.map_atol`` (1e-4 relative; absolute 1e-4, or 1e-5 of
the map's largest |value| where that is more), the running statistics at
1e-4.

Run as ``JAX_PLATFORMS=cpu python -m tests.test_torch_variants_train
[variant ...]``, it prints the float64 evidence behind `map_atol`: for each
variant and each output map of forward_train, forward_key, forward_cur and
forward_batch_gop, how far JAX's and the port's float32 maps lie from the
port's maps computed in float64, relative to the map's largest |value|.
"""

import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lsfa_tpu_torch.convert import flax_to_torch
from tests.test_torch_convert import two_torch_threads  # noqa: F401  (a fixture)
from tests.test_torch_variants import (  # noqa: F401  (variant: a fixture)
    FH, FW, H, TOL, W, VARIANTS, assert_outputs_close, t, to_numpy, variant, variant_kwargs)

pytestmark = pytest.mark.usefixtures("two_torch_threads")


def train_args():
    """The inputs of forward_train on a batch of two: the long-term
    aggregation (eq_flag_old 1) and the fresh-feature select (0)."""
    rng = np.random.default_rng(11)
    imgs = [rng.integers(0, 256, (2, H, W, 3)).astype(np.float32) for _ in range(3)]
    eq, eq_old = np.zeros(2, np.float32), np.asarray([0.0, 1.0], np.float32)
    mv = rng.normal(0, 1.5, (2, FH, FW, 2)).astype(np.float32)
    res = rng.normal(0, 20, (2, FH, FW, 3)).astype(np.float32)
    return (*imgs, eq, eq_old, mv, res)


def eval_calls(name):
    """(label, method, inputs) of the eval-mode forwards of
    ``test_torch_variants.test_variant_matches_jax``, on its inputs."""
    kw = variant_kwargs(name)
    rng = np.random.default_rng(9)
    data = rng.integers(0, 256, (1, H, W, 3)).astype(np.float32)
    prev = rng.normal(0, 60, (1, H, W, 3)).astype(np.float32)
    feat = rng.normal(0, 1, (1, FH, FW, 64)).astype(np.float32)
    small_hw = (H // 4, W // 4) if kw.get("small_net_stride", 4) == 4 else (H // 2, W // 2)
    small = rng.integers(0, 256, (2,) + small_hw + (3,)).astype(np.float32)
    mv = rng.normal(0, 1.5, (2, FH, FW, 2)).astype(np.float32)
    res = rng.normal(0, 20, (2, FH, FW, 3)).astype(np.float32)
    others = rng.integers(0, 256, (2, H, W, 3)).astype(np.uint8)
    calls = [("key", "forward_key", (data, prev, feat, np.zeros((1,), np.float32))),
             ("cur", "forward_cur", (small, np.repeat(feat, 2, axis=0), mv, res))]
    if kw.get("add_lt_aggregation", True):
        calls.append(("gop", "forward_batch_gop", (data.astype(np.uint8)[None, 0], others)))
    return calls


def test_variant_forward_train_matches_jax(variant):
    """forward_train in training mode on a batch of two (the long-term
    aggregation and the fresh-feature select), with the train-mode
    BatchNorms' updated running statistics where there are some."""
    name, jm, v, tm = variant
    args = train_args()
    want, mutated = jm.apply(v, *(jnp.asarray(a) for a in args), method=jm.forward_train,
                             mutable=["batch_stats"])
    before = {k: x.clone() for k, x in tm.state_dict().items()}
    tm.train()
    try:
        with torch.no_grad():
            got = tm.forward_train(*(t(a) for a in args))
        assert_outputs_close(got, want)
        stats = flax_to_torch(to_numpy({"batch_stats": mutated["batch_stats"]}))
        moved = [k for k, x in tm.state_dict().items() if not torch.equal(x, before[k])]
        assert all(k.endswith(("running_mean", "running_var")) for k in moved), moved
        for k in moved:
            np.testing.assert_allclose(tm.state_dict()[k].numpy(), stats[k].numpy(), err_msg=k,
                                       **TOL)
        assert bool(moved) == (name in ("stride8_options", "small_bn_scale"))
    finally:
        tm.load_state_dict(before)
        tm.eval()


def float64_errors(names):
    """{(variant, call, map): (|JAX - f64|, |port - f64|, |port - JAX|)},
    each the largest over the map's elements over the map's largest
    |float64 value|, where f64 is the port's model with every float32 made
    float64, on the tests' weights and inputs. It switches torch's float32
    to float64 for the rest of the process, so it runs only from
    ``__main__``."""
    from lsfa_tpu_torch.models.lsfa import LSFA
    from tests.test_torch_variants import build_variant

    f32 = {}
    for name in names:
        jm, v, tm = build_variant(name)
        state = {k: x.clone() for k, x in tm.state_dict().items()}
        want = jm.apply(v, *(jnp.asarray(a) for a in train_args()), method=jm.forward_train,
                        mutable=["batch_stats"])[0]
        with torch.no_grad():
            got = tm.train().forward_train(*(t(a) for a in train_args()))
        f32[name, "train"] = want, got
        tm.load_state_dict(state)
        tm.eval()
        for label, method, args in eval_calls(name):
            want = jm.apply(v, *(jnp.asarray(a) for a in args), method=getattr(jm, method))
            with torch.no_grad():
                f32[name, label] = want, getattr(tm, method)(*(t(a) for a in args))
        f32[name] = state
    torch.float32 = torch.float64
    torch.Tensor.float = torch.Tensor.double
    torch.set_default_dtype(torch.float64)
    out = {}
    for name in names:
        tm = LSFA(dtype=torch.float64, **variant_kwargs(name))
        for m in tm.modules():
            if isinstance(getattr(m, "dtype", None), torch.dtype):
                m.dtype = torch.float64
        state = {k: x.double() for k, x in f32[name].items()}
        tm.load_state_dict(state, strict=True)
        with torch.no_grad():
            refs = {"train": tm.double().train().forward_train(
                *(t(a.astype(np.float64)) for a in train_args()))}
            tm.load_state_dict(state)
            tm.eval()
            for label, method, args in eval_calls(name):
                refs[label] = getattr(tm, method)(*(
                    t(a.astype(np.float64)) if a.dtype == np.float32 else t(a) for a in args))
        for label, ref in refs.items():
            want, got = f32[name, label]
            for k in sorted(want):
                r = ref[k].numpy()
                mag = np.abs(r).max()
                if not mag:
                    continue
                j, p = np.asarray(want[k]), got[k].numpy()
                out[name, label, k] = (np.abs(j - r).max() / mag, np.abs(p - r).max() / mag,
                                       np.abs(p - j).max() / mag)
    return out


def conv_errors():
    """{(cin, k): (|XLA - f64|, |torch - f64|)} of one float32 convolution
    (64 outputs, seeded inputs) computed by XLA:CPU and by torch on the
    CPU, relative to the largest |float64 value|."""
    import jax

    rng = np.random.default_rng(0)
    out = {}
    for cin, k, hw in ((64, 3, (16, 24)), (512, 3, (4, 6)), (256, 1, (8, 12))):
        x = rng.normal(0, 1, (2,) + hw + (cin,)).astype(np.float32)
        w = rng.normal(0, 1 / np.sqrt(cin * k * k), (k, k, cin, 64)).astype(np.float32)

        def conv(a, b):
            return torch.nn.functional.conv2d(t(a).permute(0, 3, 1, 2), t(b).permute(3, 2, 0, 1),
                                              padding=k // 2).permute(0, 2, 3, 1).numpy()

        ref = conv(x.astype(np.float64), w.astype(np.float64))
        xla = np.asarray(jax.lax.conv_general_dilated(
            jnp.asarray(x), jnp.asarray(w), (1, 1), [(k // 2, k // 2)] * 2,
            dimension_numbers=("NHWC", "HWIO", "NHWC")))
        mag = np.abs(ref).max()
        out[cin, k] = np.abs(xla - ref).max() / mag, np.abs(conv(x, w) - ref).max() / mag
    return out


if __name__ == "__main__":
    for (cin, k), (x, p) in conv_errors().items():
        print(f"one {k}x{k} conv of {cin} channels: |XLA - f64| {x:.2e}, |torch - f64| {p:.2e}")
    errs = float64_errors(sys.argv[1:] or sorted(VARIANTS))
    for (name, label, k), (j, p, pj) in errs.items():
        print(f"{name}:{label} {k}: |JAX - f64| {j:.2e}, |port - f64| {p:.2e}, "
              f"|port - JAX| {pj:.2e} of the map's largest |value|")
    e = np.asarray(list(errs.values()))
    e = e[e[:, 0] > 0]                      # maps both packages compute exactly
    ratio = e[:, 1] / e[:, 0]
    print(f"largest: |JAX - f64| {e[:, 0].max():.2e}, |port - f64| {e[:, 1].max():.2e}, "
          f"|port - JAX| {e[:, 2].max():.2e}; port/JAX distance {ratio.min():.2f}-"
          f"{ratio.max():.2f}")
