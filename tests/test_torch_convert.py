"""The flax -> torch weight bridge (lsfa_tpu_torch.convert): a tiny LSFA,
the transposed-conv flip, the depthwise kernel's layout and one
bottleneck unit with DCN, each run by the JAX package and by the port on
the same numpy inputs; and every variant's variable tree (the model family
of tests/test_torch_variants.py) loaded with strict=True.

Tolerances: float32 on both sides, sums in another order, so 1e-4
relative and absolute (an error in a layout or a flip is O(1))."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import linen as fnn
from flax.traverse_util import flatten_dict, unflatten_dict

from lsfa_tpu.models.layers import deconv_x2
from lsfa_tpu.models.lsfa import LSFA as JaxLSFA
from lsfa_tpu.models.resnet import PreactUnit as JaxPreactUnit
from lsfa_tpu_torch.convert import flax_to_torch
from lsfa_tpu_torch.models.layers import Deconv2x, SameConv
from lsfa_tpu_torch.models.lsfa import LSFA
from lsfa_tpu_torch.models.resnet import PreactUnit

TOL = dict(rtol=1e-4, atol=1e-4)
H, W = 64, 96


def to_numpy(variables):
    return jax.tree.map(np.asarray, dict(variables))


@pytest.fixture(scope="module")
def two_torch_threads():
    """Two intra-op torch threads for a module's tests, then the caller's
    count again: the workers of a parallel run share the host's cores, and
    at torch's default (a thread per core) a worker's many small ops wait
    on one another's spinning threads (an 80-step tiny train loop went from
    17 s alone to 12 min in a 6-worker run). Alone, two threads run the
    variant tests as fast as eight."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def perturb(variables, seed):
    """Redraw the leaves a fresh init leaves degenerate, so a wrong mapping
    shows: BN scale/bias/stats (identity at init), DCN offset convs and
    the scale map (zero at init)."""
    rng = np.random.default_rng(seed)
    out = {}
    for col, tree in variables.items():
        flat = flatten_dict(tree)
        for path, v in flat.items():
            v = np.asarray(v, np.float32)
            name = path[-1]
            if name in ("scale", "var"):
                v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif name == "mean" or (name == "bias" and "BatchNorm_0" in path):
                v = rng.normal(0, 0.1, v.shape).astype(np.float32)
            elif name == "kernel" and ("offset" in path or "scale_map" in path):
                v = rng.normal(0, 0.01, v.shape).astype(np.float32)
            flat[path] = v
        out[col] = unflatten_dict(flat)
    return out


def torch_in(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(scope="module")
def tiny():
    jm = JaxLSFA(num_classes=5, feat_dim=64, num_layer=18, add_dcn=True,
                 dtype=jnp.float32)
    d = jnp.zeros((1, H, W, 3))
    v = jm.init(jax.random.PRNGKey(7), d, d, d, jnp.ones((1,)), jnp.ones((1,)),
                jnp.zeros((1, 4, 6, 2)), jnp.zeros((1, 4, 6, 3)))
    v = perturb(to_numpy(v), 0)
    tm = LSFA(num_classes=5, feat_dim=64, num_layer=18, add_dcn=True)
    tm.load_state_dict(flax_to_torch(v), strict=True)
    return jm, v, tm.eval()


def test_state_dict_keys_and_shapes_match(tiny):
    _, v, tm = tiny
    sd = flax_to_torch(v)
    want = tm.state_dict()
    assert sorted(sd) == sorted(want)
    for k, t in sd.items():
        assert tuple(t.shape) == tuple(want[k].shape), k


def test_tiny_lsfa_forward_key_matches_jax(tiny):
    jm, v, tm = tiny
    rng = np.random.default_rng(1234)
    data = rng.normal(0, 40, (1, H, W, 3)).astype(np.float32)
    old_img = rng.normal(0, 40, (1, H, W, 3)).astype(np.float32)
    old = rng.normal(0, 1, (1, 4, 6, 64)).astype(np.float32)
    for first in (0.0, 1.0):
        want = jm.apply(v, jnp.asarray(data), jnp.asarray(old_img), jnp.asarray(old),
                        jnp.full((1,), first), method=jm.forward_key)
        with torch.no_grad():
            got = tm.forward_key(torch_in(data), torch_in(old_img), torch_in(old),
                                 torch.full((1,), first))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       err_msg=k, **TOL)


def test_deconv_x2_flip():
    """flax ConvTranspose does not flip its kernel and torch's does: the
    converter flips, and without the flip the outputs disagree."""

    class Up(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return deconv_x2(x, 5, name="deconv5")

    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (2, 5, 7, 6)).astype(np.float32)
    m = Up()
    v = to_numpy(m.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    v["params"]["deconv5"]["bias"] = rng.normal(0, 1, 5).astype(np.float32)
    want = np.asarray(m.apply(v, jnp.asarray(x)))
    sd = flax_to_torch(v)
    tm = Deconv2x(6, 5)
    tm.load_state_dict({k.split(".", 1)[1]: t for k, t in sd.items()})
    with torch.no_grad():
        got = tm(torch_in(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
        tm.weight.copy_(torch.flip(tm.weight, dims=(2, 3)))
        unflipped = tm(torch_in(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 10, 14, 5)
    np.testing.assert_allclose(got, want, **TOL)
    assert np.abs(unflipped - want).max() > 0.1


def test_bottleneck_preact_unit_with_dcn():
    """The flagship's units are bottlenecks (the tiny net only has basic
    ones): one projection unit of 256 features with a 4-group DCN at
    dilation 2, as in stage 4."""
    jm = JaxPreactUnit(features=256, stride=1, dilate=2, dim_match=False,
                       bottleneck=True, deformable_groups=4, dtype=jnp.float32)
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (1, 9, 13, 128)).astype(np.float32)
    v = perturb(to_numpy(jm.init(jax.random.PRNGKey(2), jnp.asarray(x))), 6)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    sd = flax_to_torch(v)
    tm = PreactUnit(128, 256, stride=1, dilate=2, dim_match=False, bottleneck=True,
                    deformable_groups=4)
    tm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = tm(torch_in(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_depthwise_kernel_layout():
    """A flax depthwise conv's kernel (3, 3, 1, C) converts to torch's
    grouped layout (C, 1, 3, 3) by the plain kernel transpose: the port's
    SameConv(groups=C) gives flax's output (stride 2, SAME, as the
    MobileNet blocks' first dw conv)."""

    class Depthwise(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return fnn.Conv(12, (3, 3), strides=(2, 2), feature_group_count=12,
                            padding="SAME", use_bias=False, name="dw")(x)

    rng = np.random.default_rng(8)
    x = rng.normal(0, 1, (2, 10, 14, 12)).astype(np.float32)
    v = to_numpy(Depthwise().init(jax.random.PRNGKey(4), jnp.asarray(x)))
    assert v["params"]["dw"]["kernel"].shape == (3, 3, 1, 12)
    want = np.asarray(Depthwise().apply(v, jnp.asarray(x)))
    sd = flax_to_torch(v)
    assert tuple(sd["dw.weight"].shape) == (12, 1, 3, 3)
    tm = SameConv(12, 12, 3, 2, bias=False, groups=12)
    tm.load_state_dict({"weight": sd["dw.weight"]}, strict=True)
    with torch.no_grad():
        got = tm(torch_in(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 5, 7, 12)
    np.testing.assert_allclose(got, want, **TOL)


def _variant_names():
    from tests.test_torch_variants import VARIANTS

    return sorted(VARIANTS)


@pytest.mark.parametrize("name", _variant_names())
def test_variant_tree_loads_strict(name):
    """Every variant's flax variable tree (built abstractly, seeded numbers)
    maps onto the port model's state_dict with strict=True, each tensor
    landing where it belongs."""
    from tests.test_torch_train import flax_shapes
    from tests.test_torch_variants import variant_kwargs

    kw = variant_kwargs(name)
    shapes = flax_shapes(JaxLSFA(dtype=jnp.float32, **kw))
    rng = np.random.default_rng(0)
    v = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32), shapes)
    sd = flax_to_torch(v)
    tm = LSFA(**kw)
    tm.load_state_dict(sd, strict=True)
    state = tm.state_dict()
    assert all(torch.equal(state[k], t) for k, t in sd.items())
    tops = {k.split(".")[0] for k in sd}
    assert ("fgfa_net" in tops) == (name == "fgfa")
    assert ("fnet" in tops) == (name == "fnet_conv2")
    assert ("fuse_downsample" in tops) == (name == "fuse_concat")
