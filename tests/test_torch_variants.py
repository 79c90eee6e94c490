"""The LSFA switches the flagship leaves at their defaults, against the JAX
package: the ablation rungs (no R-net, no long-term aggregation, no small
net, all three or one at a time), plain averaging instead of the Nq-net,
the small net's BN/scale options at stride 4 and, with an R-net conv, BN
on the residual, un-normalized RPN deltas and BGR pixel means, at stride
8; and the rest of the model family: FGFA
aggregation, the F-net ('conv#2', 'res'), the concat fuse, the four other
small-net fuse modes, and the MobileNetV2 and Hobot trunks. Each variant
runs forward_key, forward_cur and (with a FlowNet) forward_batch_gop in
eval mode and forward_train in training mode. The non-local block, alone
and inside the ResNet trunk, and flax's SAME padding, which the MobileNet
trunks use, are held on their own. Tiny models, float32, 1e-4 relative
and absolute (sums reassociated; the ResNet trunk's O(100) stages within
1e-5 of their largest value)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import linen as fnn

from lsfa_tpu.models.lsfa import LSFA as JaxLSFA
from lsfa_tpu.models.resnet import NonLocalBlock as JaxNonLocalBlock
from lsfa_tpu.models.resnet import ResNetBackbone as JaxResNetBackbone
from lsfa_tpu_torch.convert import flax_to_torch
from lsfa_tpu_torch.models.layers import Conv, SameConv
from lsfa_tpu_torch.models.lsfa import LSFA
from lsfa_tpu_torch.models.resnet import NonLocalBlock, ResNetBackbone

H, W = 64, 96
FH, FW = H // 16, W // 16
TOL = dict(rtol=1e-4, atol=1e-4)
BASE = dict(num_classes=5, feat_dim=64, num_layer=18)
MOBILE = dict(add_small_net=False, pixel_means=(103.94, 116.78, 123.68))
VARIANTS = {
    "ablation": dict(add_rnet=False, add_lt_aggregation=False, add_small_net=False,
                     add_dcn=False),
    "average_no_nq": dict(add_Nq_net=False, add_dcn=False),
    "stride8_options": dict(small_net_stride=8, small_net_bn_before_fuse=True,
                            small_net_scale_before_fuse=True, res_diff_bn=True,
                            rnet_num_conv=1, normalize_rpn=False, add_dcn=False,
                            pixel_means=(103.94, 116.78, 123.68), pixel_scale=0.017),
    # the variants and ablation rungs of tests/test_graph_variants.py
    "rung_no_rnet": dict(add_rnet=False, add_dcn=False),
    "rung_no_lt": dict(add_lt_aggregation=False, add_Nq_net=False, add_dcn=False),
    "small_bn_scale": dict(small_net_bn_before_fuse=True, small_net_scale_before_fuse=True,
                           add_dcn=False),
    "fgfa": dict(add_Nq_net=False, add_Fgfa_net=True, add_dcn=False),
    "fnet_conv2": dict(fnet_type="conv#2", add_dcn=False),
    "fnet_res": dict(fnet_type="res", add_dcn=False),
    "fuse_concat": dict(fuse_type="concat", add_dcn=False),
    "small_addv2": dict(small_net_fuse_type="addv2", add_dcn=False),
    "small_concat": dict(small_net_fuse_type="concat", add_dcn=False),
    "small_concatv1": dict(small_net_fuse_type="concatv1", add_dcn=False),
    "small_concatv2": dict(small_net_fuse_type="concatv2", add_dcn=False),
    # the trunks of tests/test_mobilenet_metrics.py
    "mobilenet": dict(nettype="mobilenet", **MOBILE),
    "mobilenet_hobot": dict(nettype="mobilenet_hobot", pixel_scale=0.017, **MOBILE),
}
# tests/test_torch_convert.py parametrizes over VARIANTS, so its helpers
# are imported when called
def perturb(variables, seed):
    from tests.test_torch_convert import perturb as convert_perturb

    return convert_perturb(variables, seed)


def to_numpy(variables):
    return jax.tree.map(np.asarray, dict(variables))


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def variant_kwargs(name):
    return dict(BASE, **VARIANTS[name])


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def variant(request):
    """(name, JAX module, perturbed flax variables, port model loaded with
    strict=True) of a variant."""
    kw = variant_kwargs(request.param)
    jm = JaxLSFA(dtype=jnp.float32, **kw)
    d = jnp.zeros((1, H, W, 3))
    v = jm.init(jax.random.PRNGKey(5), d, d, d, jnp.ones((1,)), jnp.ones((1,)),
                jnp.zeros((1, FH, FW, 2)), jnp.zeros((1, FH, FW, 3)))
    v = perturb(to_numpy(v), 2)
    tm = LSFA(**kw)
    tm.load_state_dict(flax_to_torch(v), strict=True)
    return request.param, jm, v, tm


def assert_outputs_close(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), err_msg=k,
                                   **TOL)


def test_variant_matches_jax(variant):
    name, jm, v, tm = variant
    tm.eval()
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
    fk = np.repeat(feat, 2, axis=0)
    want_k = jm.apply(v, jnp.asarray(data), jnp.asarray(prev), jnp.asarray(feat),
                      jnp.zeros((1,)), method=jm.forward_key)
    want_c = jm.apply(v, jnp.asarray(small), jnp.asarray(fk), jnp.asarray(mv),
                      jnp.asarray(res), method=jm.forward_cur)
    with torch.no_grad():
        assert_outputs_close(tm.forward_key(t(data), t(prev), t(feat), torch.zeros(1)), want_k)
        assert_outputs_close(tm.forward_cur(t(small), t(fk), t(mv), t(res)), want_c)
        if kw.get("add_lt_aggregation", True):
            key = data.astype(np.uint8)[None, 0]
            want_b = jm.apply(v, jnp.asarray(key), jnp.asarray(others),
                              method=jm.forward_batch_gop)
            assert_outputs_close(tm.forward_batch_gop(t(key), t(others)), want_b)


def test_variant_forward_train_matches_jax(variant):
    """forward_train in training mode on a batch of two (the long-term
    aggregation and the fresh-feature select), with the train-mode
    BatchNorms' updated running statistics where there are some."""
    name, jm, v, tm = variant
    rng = np.random.default_rng(11)
    imgs = [rng.integers(0, 256, (2, H, W, 3)).astype(np.float32) for _ in range(3)]
    eq, eq_old = np.zeros(2, np.float32), np.asarray([0.0, 1.0], np.float32)
    mv = rng.normal(0, 1.5, (2, FH, FW, 2)).astype(np.float32)
    res = rng.normal(0, 20, (2, FH, FW, 3)).astype(np.float32)
    args = (*imgs, eq, eq_old, mv, res)
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


@pytest.mark.parametrize("case", ["block", "block_compress", "backbone"])
def test_non_local_matches_jax(case):
    """The embedded-gaussian non-local block alone (with and without the
    3x3/2 max-pool of key and value) and inside ResNetBackbone(non_local=
    True), where it sits between the last two units of stage 3."""
    rng = np.random.default_rng(4)
    if case == "backbone":
        jm = JaxResNetBackbone(num_layer=18, non_local=True, dtype=jnp.float32)
        tm = ResNetBackbone(18, non_local=True)
        x = rng.normal(0, 40, (1, H, W, 3)).astype(np.float32)
    else:
        compress = case == "block_compress"
        jm = JaxNonLocalBlock(64, compress=compress, dtype=jnp.float32)
        tm = NonLocalBlock(64, compress=compress)
        x = rng.normal(0, 1, (2, 7, 9, 64)).astype(np.float32)
    v = perturb(to_numpy(jm.init(jax.random.PRNGKey(1), jnp.asarray(x))), 3)
    sd = flax_to_torch(v)
    if case == "backbone":
        assert "non_local.conv_y.weight" in sd and "stage3_unit1.conv1.weight" in sd
        assert tm.stages[2] == ["stage3_unit1", "non_local", "stage3_unit2"]
    tm.load_state_dict(sd, strict=True)
    want = jm.apply(v, jnp.asarray(x))
    with torch.no_grad():
        got = tm(t(x).permute(0, 3, 1, 2))
    for g, w in zip(got if case == "backbone" else [got], want if case == "backbone" else [want]):
        # the trunk's activations reach O(100) from an O(40) image: its
        # stages are held within 1e-5 of their largest |value| (1e-4 for
        # the block alone, whose outputs are O(1))
        w = np.asarray(w)
        atol = 1e-5 * float(np.abs(w).max()) if case == "backbone" else TOL["atol"]
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w, rtol=TOL["rtol"], atol=atol)


@pytest.mark.parametrize("hw", [(64, 96), (63, 95)], ids=["even", "odd"])
def test_same_padding_matches_flax(hw):
    """The MobileNet stem (3x3, stride 2, flax padding="SAME"): SameConv
    gives flax's output on an even and an odd input. On the even input
    SAME pads 0 before and 1 after, so a symmetric pad of 1 (Conv) gives
    the same size but every sample one pixel off; on the odd one SAME
    pads 1 and 1, as Conv does."""

    class Stem(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return fnn.Conv(8, (3, 3), strides=(2, 2), padding="SAME", use_bias=False,
                            name="stem")(x)

    rng = np.random.default_rng(6)
    x = rng.normal(0, 1, (1,) + hw + (3,)).astype(np.float32)
    v = to_numpy(Stem().init(jax.random.PRNGKey(0), jnp.asarray(x)))
    want = np.asarray(Stem().apply(v, jnp.asarray(x)))
    weight = flax_to_torch(v)["stem.weight"]
    same, sym = SameConv(3, 8, 3, 2, bias=False), Conv(3, 8, 3, 2, bias=False)
    with torch.no_grad():
        same.weight.copy_(weight)
        sym.weight.copy_(weight)
        got = same(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
        symmetric = sym(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == symmetric.shape == want.shape == (1, 32, 48, 8)
    np.testing.assert_allclose(got, want, **TOL)
    if hw[0] % 2 == 0:
        assert np.abs(symmetric - want).max() > 0.1
    else:
        np.testing.assert_allclose(symmetric, want, **TOL)


def test_mobilenet_construction_rules():
    """nettype errors as the JAX model's: an unknown name, and a small net
    on a MobileNet trunk; the trunks' output widths feed feat_conv_3x3."""
    with pytest.raises(ValueError, match="unknown nettype"):
        LSFA(nettype="vgg", **BASE)
    with pytest.raises(ValueError, match="small_net"):
        LSFA(nettype="mobilenet", add_small_net=True, **BASE)
    for name, width in (("mobilenet", 1280), ("mobilenet_hobot", 320)):
        tm = LSFA(**variant_kwargs(name))
        assert tm.feat_conv_3x3.weight.shape[1] == width
        assert tm.backbone.out_channels == [width]
    assert "backbone.bottleneck1.expand.weight" in LSFA(**variant_kwargs("mobilenet_hobot")) \
        .state_dict()
    assert "backbone.block0_0.expand.weight" not in LSFA(**variant_kwargs("mobilenet")) \
        .state_dict()


@pytest.mark.parametrize("name", ["resnet-101", "resnet-18", "mobilenetv2-1.0",
                                  "mobilenetv2_hobot", "vgg16"])
def test_update_network_config_equals_jax(name):
    """update_network_config derives nettype, depth and pixel statistics
    from the pretrained name as JAX's does (a name of no known trunk
    raises in both); lsfa_from_config builds the trunk it names."""
    from lsfa_tpu.config import get_default_config as jax_default_config
    from lsfa_tpu.config import np_pixel_means as jax_np_pixel_means
    from lsfa_tpu.config import update_network_config as jax_update
    from lsfa_tpu_torch.config import get_default_config, np_pixel_means, update_network_config
    from lsfa_tpu_torch.models.lsfa import lsfa_from_config

    cfg, jcfg = get_default_config(), jax_default_config()
    cfg.network.pretrained = jcfg.network.pretrained = name
    if name == "vgg16":
        for update, c in ((update_network_config, cfg), (jax_update, jcfg)):
            with pytest.raises(ValueError, match="nettype"):
                update(c)
        return
    update_network_config(cfg)
    jax_update(jcfg)
    assert cfg == jcfg
    np.testing.assert_array_equal(np_pixel_means(cfg), jax_np_pixel_means(jcfg))
    if name.startswith("mobilenet"):
        cfg.network.add_small_net = False
        cfg.network.DFF_FEAT_DIM = 64
        model = lsfa_from_config(cfg, device="cpu")
        assert type(model.backbone).__name__ == (
            "MobileNetV2HobotBackbone" if "hobot" in name else "MobileNetV2Backbone")


@pytest.mark.parametrize("fnet_type", ["conv#2", "res", "None"])
def test_fnet_matches_jax(fnet_type):
    """FNet alone, every type: LSFA builds it only for 'conv#N' (JAX never
    calls it for 'res'), so the 'res' bottleneck with its skip and the
    'None' identity are held here."""
    from lsfa_tpu.models.aggregation import FNet as JaxFNet
    from lsfa_tpu_torch.models.aggregation import FNet

    rng = np.random.default_rng(12)
    x = rng.normal(0, 1, (2, FH, FW, 64)).astype(np.float32)
    jm = JaxFNet(fnet_type=fnet_type, feat_dim=64, dtype=jnp.float32)
    v = perturb(to_numpy(jm.init(jax.random.PRNGKey(2), jnp.asarray(x))), 5)
    tm = FNet(fnet_type, 64)
    tm.load_state_dict(flax_to_torch(v), strict=True)
    with torch.no_grad():
        got = tm(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, jnp.asarray(x))), **TOL)
    if fnet_type == "None":
        assert not list(tm.parameters()) and np.array_equal(got, x)
