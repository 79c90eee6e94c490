"""The MXNet ``.params`` reader/writer and the weight map of the port
against the JAX package.

* ``utils/mxnet_io.py`` is a copy: save_params writes byte-identical files
  in both packages, and load_params reads the legacy u32-shape, V1, V2
  and V3 layouts alike.
* ``train/import_mxnet.py`` maps the reference's names onto the port's
  state-dict keys. On the tiny LSFA (DCN, R-net with a conv, both
  train-mode BatchNorms, the scale-before-fuse conv) and the tiny R-FCN,
  seeded flax variables exported by JAX's ``export_mxnet_lsfa`` and
  imported by both packages give, through ``convert.flax_to_torch``, the
  same state dict bit for bit on every key, and the same imported,
  missing and unused lists; the port's export equals JAX's.
* The same holds for the FGFA, concat-fuse, concatv1 small-net and
  MobileNetV2 variants of tests/test_torch_variants.py, and a MobileNet
  depthwise kernel is written in MXNet's grouped layout (C, 1, 3, 3).
* Because export and import share one name map, a systematic misreading
  would cancel in a round trip; the hand-named fixture of
  ``tests/test_mxnet_fixture_independent.py`` (literal reference names,
  MXNet layouts, a numpy re-statement of MXNet's operators) holds the
  port's import to MXNet's semantics instead: activations within 1e-5 of
  the largest output, while a deconv weight flipped beforehand (what a
  flip carried over from the flax path would do) misses them.
"""

import struct

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.traverse_util import flatten_dict
from torch import nn

from lsfa_tpu.models.lsfa import LSFA as JaxLSFA
from lsfa_tpu.models.rfcn import RFCN as JaxRFCN
from lsfa_tpu.train import checkpoint as jax_checkpoint
from lsfa_tpu.train import import_mxnet as jax_import
from lsfa_tpu.utils import mxnet_io as jax_io
from lsfa_tpu_torch.convert import flax_to_torch
from lsfa_tpu_torch.models.layers import Conv, Deconv2x, FrozenBN
from lsfa_tpu_torch.train.checkpoint import import_torch_resnet
from lsfa_tpu_torch.train.import_mxnet import (
    export_mxnet_lsfa, import_mxnet_lsfa, torch_to_mx_name)
from lsfa_tpu_torch.utils import mxnet_io
from tests.test_mxnet_fixture_independent import (
    C0, C1, C2, C3, H, W, _literal_checkpoint, _oracle_forward)
from tests.test_torch_convert import to_numpy

LSFA_KW = dict(num_classes=5, feat_dim=64, num_layer=18, add_dcn=True, rnet_num_conv=1,
               res_diff_bn=True, small_net_bn_before_fuse=True,
               small_net_scale_before_fuse=True)


def _lsfa_shapes():
    m = JaxLSFA(dtype=jnp.float32, **LSFA_KW)
    d = jnp.zeros((1, 64, 64, 3))
    return jax.eval_shape(m.init, jax.random.PRNGKey(0), d, d, d, jnp.zeros((1,)),
                          jnp.zeros((1,)), jnp.zeros((1, 4, 4, 2)), jnp.zeros((1, 4, 4, 3)))


def _rfcn_shapes():
    return jax.eval_shape(JaxRFCN(num_classes=5, feat_dim=64, num_layer=18).init,
                          jax.random.PRNGKey(0), jnp.zeros((1, 64, 96, 3)), False)


@pytest.fixture(scope="module", params=["lsfa", "rfcn"])
def variables(request):
    """(source, target): two flax variable trees of the tiny model's
    structure and shapes (abstract init, no compile), numpy leaves drawn
    from seeds."""
    shapes = (_lsfa_shapes if request.param == "lsfa" else _rfcn_shapes)()
    rng = np.random.default_rng(1)
    return tuple(jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32),
                              {"params": shapes["params"], "batch_stats": shapes["batch_stats"]})
                 for _ in range(2))


IMPORT_VARIANTS = ("fgfa", "fuse_concat", "small_concatv1", "mobilenet")


@pytest.fixture(scope="module", params=IMPORT_VARIANTS)
def variant_variables(request):
    """`variables` for a variant of the model family."""
    from tests.test_torch_train import flax_shapes
    from tests.test_torch_variants import variant_kwargs

    shapes = flax_shapes(JaxLSFA(dtype=jnp.float32, **variant_kwargs(request.param)))
    rng = np.random.default_rng(2)
    return tuple(jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32),
                              {"params": shapes["params"], "batch_stats": shapes["batch_stats"]})
                 for _ in range(2))


def _torch_key(label, variables):
    """JAX's report label ('params/backbone/.../kernel') -> state-dict key."""
    col, *path = label.split("/")
    leaf = flatten_dict(variables[col])[tuple(path)]
    tree = node = {}
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = np.zeros_like(leaf)
    (key,) = flax_to_torch({col: tree})
    return key


# ---------------------------------------------------------------- format

def _raw_params(version):
    """A .params file in one layout (legacy: no magic, u32 shape; V1: i64
    shape; V2/V3: stype before the shape) with a float32 (2, 3, 4), an
    int64 (5,) and a float64 scalar."""
    arrays = {"arg:a": np.arange(24, dtype=np.float32).reshape(2, 3, 4) - 7.5,
              "aux:b": np.arange(5, dtype=np.int64) * 3,
              "arg:c": np.float64(2.25).reshape(())}
    flags = {np.dtype(np.float32): 0, np.dtype(np.float64): 1, np.dtype(np.int64): 6}
    out = struct.pack("<QQ", 0x112, 0) + struct.pack("<Q", len(arrays))
    for a in arrays.values():
        if version == "legacy":
            out += struct.pack("<I", a.ndim) + struct.pack(f"<{a.ndim}I", *a.shape)
        else:
            magic = {"v1": 0xF993FAC8, "v2": 0xF993FAC9, "v3": 0xF993FACA}[version]
            out += struct.pack("<I", magic)
            if version != "v1":
                out += struct.pack("<i", 1)
            out += struct.pack("<I", a.ndim) + struct.pack(f"<{a.ndim}q", *a.shape)
        out += struct.pack("<iii", 1, 0, flags[a.dtype]) + a.tobytes()
    out += struct.pack("<Q", len(arrays))
    for name in arrays:
        out += struct.pack("<Q", len(name)) + name.encode()
    return out, arrays


@pytest.mark.parametrize("version", ["legacy", "v1", "v2", "v3"])
def test_load_params_reads_every_layout_as_jax_does(version, tmp_path):
    data, want = _raw_params(version)
    path = tmp_path / f"{version}.params"
    path.write_bytes(data)
    ours, theirs = mxnet_io.load_params(str(path)), jax_io.load_params(str(path))
    assert list(ours) == list(theirs) == list(want)
    for k in want:
        assert ours[k].dtype == theirs[k].dtype == want[k].dtype
        np.testing.assert_array_equal(ours[k], want[k])
        np.testing.assert_array_equal(theirs[k], want[k])
    assert mxnet_io.split_arg_aux(ours)[1].keys() == {"b"}


def test_save_params_is_byte_identical_to_jax(tmp_path):
    rng = np.random.default_rng(0)
    named = {"arg:conv0_weight": rng.standard_normal((8, 3, 7, 7)).astype(np.float32),
             "aux:bn0_moving_mean": rng.standard_normal(8).astype(np.float32),
             "arg:scalar": np.float32(3.5).reshape(()),
             "arg:int64s": np.arange(5, dtype=np.int64),
             "arg:half": rng.standard_normal((2, 2)).astype(np.float16)}
    mxnet_io.save_params(str(tmp_path / "ours.params"), named)
    jax_io.save_params(str(tmp_path / "theirs.params"), named)
    assert (tmp_path / "ours.params").read_bytes() == (tmp_path / "theirs.params").read_bytes()
    back = mxnet_io.load_params(str(tmp_path / "ours.params"))
    for k, v in named.items():
        assert back[k].dtype == v.dtype
        np.testing.assert_array_equal(back[k], v)


def test_bad_files_raise_in_both(tmp_path):
    data, _ = _raw_params("v2")
    (tmp_path / "cut.params").write_bytes(data[:100])
    sparse = bytearray(data)
    sparse[24 + 4:24 + 8] = struct.pack("<i", 2)     # the first array's stype
    (tmp_path / "sparse.params").write_bytes(bytes(sparse))
    for io in (mxnet_io, jax_io):
        with pytest.raises(ValueError, match="truncated"):
            io.load_params(str(tmp_path / "cut.params"))
        with pytest.raises(NotImplementedError, match="sparse"):
            io.load_params(str(tmp_path / "sparse.params"))


# ----------------------------------------------------------- name mapping

def test_name_map_spot_checks():
    """JAX's spot checks (tests/test_mxnet_import.py), keyed by the port's
    state-dict names."""
    cases = {
        "backbone.conv0.weight": ("conv0_weight", "conv"),
        "backbone.bn_data.bias": ("bn_data_beta", "direct"),
        "backbone.bn_data.running_var": ("bn_data_moving_var", "direct"),
        "backbone.stage3_unit21.bn2.weight": ("stage3_unit21_bn2_gamma", "direct"),
        "backbone.stage2_unit4.conv2.offset.bias": ("stage2_unit4_conv2_offset_bias", "direct"),
        "backbone.stage3_unit23.conv2.offset.weight":
            ("stage3_unit23_conv2_offset_weight", "conv"),
        "backbone.stage4_unit1.sc.weight": ("stage4_unit1_sc_weight", "conv"),
        "small_net_backbone.stage1_unit2.conv1.weight":
            ("small_net_stage1_unit2_conv1_weight", "conv"),
        "flownet.conv1.weight": ("flow_conv1_weight", "conv"),
        "flownet.conv3_1.bias": ("conv3_1_bias", "direct"),
        "flownet.flow6.weight": ("Convolution1_weight", "conv"),
        "flownet.flow_final.weight": ("Convolution5_weight", "conv"),
        "flownet.scale_map.bias": ("Convolution5_scale_bias", "direct"),
        "flownet.deconv4.weight": ("deconv4_weight", "deconv"),
        "flownet.upflow5.weight": ("upsample_flow6to5_weight", "deconv"),
        "nq_net.conv2.weight": ("Nq_conv2_weight", "conv"),
        "rnet.conv0.weight": ("rnet_conv0_weight", "conv"),
        "rnet.bn.weight": ("res_diff_bn_gamma", "direct"),
        "fnet.conv1.weight": ("fnet_conv1_weight", "conv"),
        "fgfa_net.em_conv3.weight": ("em_conv3_weight", "conv"),
        "small_fuse.fuse_reduce_add.weight": ("fuse_reduce_add_weight", "conv"),
        "small_fuse.cur_feat_bn.running_mean": ("cur_feat_bn_moving_mean", "direct"),
        "small_fuse.warp_conv_feat_bn.bias": ("warp_conv_feat_bn_beta", "direct"),
        "fuse_downsample.weight": ("fuse_downsample_weight", "conv"),
        "feat_conv_3x3.weight": ("feat_conv_3x3_weight", "conv"),
        "rpn_cls_score.bias": ("rpn_cls_score_bias", "direct"),
        "rfcn_bbox.weight": ("rfcn_bbox_weight", "conv"),
        "backbone.bn1.running_var": ("bn1_moving_var", "direct"),
    }
    for key, want in cases.items():
        assert torch_to_mx_name(key) == want, key


def test_name_map_equals_jax_on_every_key(variables):
    src, _ = variables
    for col in ("params", "batch_stats"):
        for path in flatten_dict(src[col]):
            key = _torch_key(col + "/" + "/".join(path), src)
            assert torch_to_mx_name(key) == jax_import.flax_to_mx_name(path), (key, path)


# -------------------------------------------------- the tiny models, both ways

def test_import_equals_jax_bit_for_bit(variables, tmp_path):
    """JAX exports the source weights; each package imports the file into
    the same target weights: equal state dicts and reports."""
    src, dst = variables
    path = str(tmp_path / "model-0000.params")
    jax_import.export_mxnet_lsfa(src, path)
    jax_vars, jax_report = jax_import.import_mxnet_lsfa(dst, path)
    state, report = import_mxnet_lsfa(flax_to_torch(dst), path)
    want = flax_to_torch(to_numpy(jax_vars))
    assert list(state) == list(flax_to_torch(dst))
    assert state.keys() == want.keys()
    for k in want:
        assert state[k].dtype == torch.float32 and torch.equal(state[k], want[k]), k
    for k in ("imported", "missing"):
        assert sorted(report[k]) == sorted(_torch_key(x, dst) for x in jax_report[k]), k
    assert report["unused"] == jax_report["unused"]
    assert report["imported"] and not report["missing"] and not report["unused"]
    # the import changed every tensor: the file's weights, not the target's
    src_state = flax_to_torch(src)
    assert all(torch.equal(state[k], src_state[k]) for k in state)


def test_export_equals_jax(variables, tmp_path):
    src, _ = variables
    ours = export_mxnet_lsfa(flax_to_torch(src), str(tmp_path / "ours.params"))
    theirs = jax_import.export_mxnet_lsfa(src)
    assert ours.keys() == theirs.keys()
    for k in theirs:
        assert ours[k].dtype == np.float32
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    back = mxnet_io.load_params(str(tmp_path / "ours.params"))
    assert back.keys() == ours.keys()


def test_variant_name_map_equals_jax(variant_variables):
    test_name_map_equals_jax_on_every_key(variant_variables)


def test_variant_import_equals_jax_bit_for_bit(variant_variables, tmp_path):
    test_import_equals_jax_bit_for_bit(variant_variables, tmp_path)


def test_variant_export_equals_jax(variant_variables, tmp_path):
    test_export_equals_jax(variant_variables, tmp_path)


def test_depthwise_kernel_mxnet_layout(tmp_path):
    """A MobileNet depthwise kernel, flax (3, 3, 1, C), leaves JAX's export
    as MXNet's (C, 1, 3, 3) and lands in the port's grouped conv weight
    unchanged: the port's block gives JAX's output."""
    from lsfa_tpu.models.mobilenet import InvertedResidual as JaxInvertedResidual
    from lsfa_tpu_torch.models.mobilenet import InvertedResidual

    jm = JaxInvertedResidual(24, stride=2, expand=6, dtype=jnp.float32)
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (1, 10, 14, 16)).astype(np.float32)
    v = to_numpy(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    v = {"params": {"backbone": {"block1_0": v["params"]}},
         "batch_stats": {"backbone": {"block1_0": v["batch_stats"]}}}
    flat = jax_import.export_mxnet_lsfa(v)
    kernel = v["params"]["backbone"]["block1_0"]["dw"]["kernel"]
    assert kernel.shape == (3, 3, 1, 96) and flat["arg:block1_0_dw_weight"].shape == (96, 1, 3, 3)
    np.testing.assert_array_equal(flat["arg:block1_0_dw_weight"], kernel.transpose(3, 2, 0, 1))
    tm = InvertedResidual(16, 24, stride=2, expand=6)
    state = {"backbone.block1_0." + k: x for k, x in tm.state_dict().items()}
    state, report = import_mxnet_lsfa(state, flat)
    assert not report["missing"] and not report["unused"]
    tm.load_state_dict({k.split(".", 2)[2]: x for k, x in state.items()}, strict=True)
    want = np.asarray(jm.apply({"params": v["params"]["backbone"]["block1_0"],
                                "batch_stats": v["batch_stats"]["backbone"]["block1_0"]},
                               jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_baked_release_unbakes_as_jax(variables):
    """A test-only release ships only rfcn_bbox_{weight,bias}_test, baked
    with the bbox stds (do_checkpoint); the import un-bakes them to within
    1e-6 relative of the live weights, exactly as JAX does."""
    src, dst = variables
    flat = jax_import.export_mxnet_lsfa(src)
    w, b = flat.pop("arg:rfcn_bbox_weight"), flat.pop("arg:rfcn_bbox_bias")
    stds = np.tile(np.array([0.1, 0.1, 0.2, 0.2], np.float32), b.shape[0] // 4)
    flat["arg:rfcn_bbox_weight_test"] = w * stds[:, None, None, None]
    flat["arg:rfcn_bbox_bias_test"] = b * stds
    state, report = import_mxnet_lsfa(flax_to_torch(dst), flat)
    jax_vars, _ = jax_import.import_mxnet_lsfa(dst, flat)
    want = flax_to_torch(to_numpy(jax_vars))
    assert not report["unused"] and "rfcn_bbox.weight" in report["imported"]
    for key, live in (("rfcn_bbox.weight", w), ("rfcn_bbox.bias", b)):
        assert torch.equal(state[key], want[key])
        np.testing.assert_allclose(state[key].numpy(), live, rtol=1e-6, atol=0)


def test_strict_modules_raise_as_jax(variables):
    src, dst = variables
    flat = jax_import.export_mxnet_lsfa(src)
    del flat["arg:stage1_unit1_conv1_weight"]
    with pytest.raises(ValueError, match="strict import: backbone missing"):
        jax_import.import_mxnet_lsfa(dst, flat, strict_modules=("backbone",))
    with pytest.raises(ValueError, match=r"strict import: backbone missing \['backbone.stage1"):
        import_mxnet_lsfa(flax_to_torch(dst), flat, strict_modules=("backbone",))
    _, report = import_mxnet_lsfa(flax_to_torch(dst), flat, strict_modules=("rpn_cls_score",))
    assert report["missing"] == ["backbone.stage1_unit1.conv1.weight"]
    bad = dict(flat, **{"arg:conv0_weight": np.zeros((1, 2, 3, 4), np.float32)})
    with pytest.raises(ValueError, match="shape mismatch"):
        import_mxnet_lsfa(flax_to_torch(dst), bad)


def test_import_torch_resnet_equals_jax(variables):
    """A torchvision ResNet-18 state dict (seeded, with a BatchNorm, the fc
    layer and one convolution of the wrong shape that must be skipped):
    the same count and the same kernels as JAX's import."""
    _, dst = variables
    rng = np.random.default_rng(4)

    def f32(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    sd = {"conv1.weight": f32(64, 3, 7, 7), "bn1.weight": f32(64), "fc.weight": f32(10, 512)}
    cin = 64
    for s, c in enumerate((64, 128, 256, 512), start=1):
        for u in range(2):
            sd[f"layer{s}.{u}.conv1.weight"] = f32(c, cin if u == 0 else c, 3, 3)
            sd[f"layer{s}.{u}.conv2.weight"] = f32(c, c, 3, 3)
        if s > 1:
            sd[f"layer{s}.0.downsample.0.weight"] = f32(c, cin, 1, 1)
        cin = c
    sd["layer4.1.conv2.weight"] = f32(512, 512, 1, 1)
    params = jax.tree.map(np.array, dst["params"])
    jax_params, jax_n = jax_checkpoint.import_torch_resnet(params, dst["batch_stats"], sd)
    state, n = import_torch_resnet(flax_to_torch(dst), {k: torch.from_numpy(v)
                                                         for k, v in sd.items()})
    want = flax_to_torch({"params": jax_params, "batch_stats": dst["batch_stats"]})
    assert n == jax_n == 1 + 4 * 2 * 2 - 1 + 3
    for k in want:
        assert torch.equal(state[k], want[k]), k
    assert torch.equal(state["backbone.conv0.weight"], torch.from_numpy(sd["conv1.weight"]))


# ------------------------------------------------- the hand-named fixture

class _FixtureNet(nn.Module):
    """The fixture's stem -> dilated feat conv -> deconv -> 1x1, under the
    port's module names (bn_data with a scale, as the fixture's)."""

    def __init__(self):
        super().__init__()
        self.backbone = nn.Module()
        self.backbone.bn_data = FrozenBN(3)
        self.backbone.conv0 = Conv(3, C0, 7, 2)
        self.backbone.bn0 = FrozenBN(C0)
        self.feat_conv_3x3 = Conv(C0, C1, 3, dilate=2)
        self.flownet = nn.Module()
        self.flownet.upflow2 = Deconv2x(C1, C2)
        self.flownet.scale_map = Conv(C2, C3, 1)

    def forward(self, x):
        b = self.backbone
        h = torch.relu(b.bn0(b.conv0(b.bn_data(x))))
        h = torch.relu(self.feat_conv_3x3(h))
        return self.flownet.scale_map(self.flownet.upflow2(h))


@pytest.mark.parametrize("corrupt", [False, True], ids=["literal", "deconv_preflipped"])
def test_hand_named_fixture_matches_mxnet_semantics(corrupt, tmp_path):
    """The literal checkpoint (MXNet names and layouts) through the port's
    import: activations within 1e-5 of the largest output of numpy's
    MXNet re-statement; with the deconv weight flipped beforehand (what a
    wrong flip in the import would do) they are not."""
    rng = np.random.default_rng(42)
    ckpt = _literal_checkpoint(rng)
    x = rng.standard_normal((3, H, W)).astype(np.float32)
    want = _oracle_forward(x, ckpt)
    if corrupt:
        ckpt["arg:upsample_flow3to2_weight"] = np.ascontiguousarray(
            ckpt["arg:upsample_flow3to2_weight"][:, :, ::-1, ::-1])
    path = str(tmp_path / "literal-0000.params")
    mxnet_io.save_params(path, ckpt)
    model = _FixtureNet()
    state, report = import_mxnet_lsfa(model.state_dict(), path,
                                      strict_modules=("backbone", "flownet"))
    assert report["unused"] == [] and report["missing"] == []
    model.load_state_dict(state)
    with torch.no_grad():
        got = model(torch.from_numpy(x)[None])[0].double().numpy()
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    if corrupt:
        assert err > 1e-2
    else:
        assert err < 1e-5
