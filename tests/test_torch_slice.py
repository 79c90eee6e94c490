"""The port's streaming path against the JAX package, end to end.

One tiny LSFA (configs/lsfa_tiny_smoke.yaml with DCN on, float32) is
initialized by flax, carried across by convert.flax_to_torch, and run by
both packages on the same seeded payloads: forward_key and forward_cur
(1e-4: float32, sums reassociated), then two whole GOPs of I420 payloads
through StreamingDetector with the key-feature carry (carry 1e-3; on valid
detection rows labels equal, scores 1e-5, boxes 1e-3).

The rfcn_cls kernel is redrawn at std 0.05 before converting: with the
N(0, 0.01) init the class scores are near-uniform, and at std 1 they
saturate to 1.0 on these features; either way float noise reorders them.

The JAX reference of the streaming run runs op by op (jit disabled).
Under jit, XLA turns psroi_pool's division of the roi size by the constant
P into a multiply by 1/P, so a bin edge that lands exactly on a feature
cell moves one cell out (see test_psroi_pool_matches_jax_and_oracle);
op by op JAX divides, as the CUDA reference kernel and the port do.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lsfa_tpu.config import load_config as jax_load_config
from lsfa_tpu.eval.tester import StreamingDetector as JaxStreamingDetector
from lsfa_tpu.models.lsfa import lsfa_from_config as jax_lsfa_from_config
from lsfa_tpu_torch.config import get_default_config, load_config
from lsfa_tpu_torch.convert import flax_to_torch
from lsfa_tpu_torch.eval.tester import StreamingDetector
from lsfa_tpu_torch.models.lsfa import init_params, lsfa_from_config
from tests.test_torch_convert import perturb, to_numpy

CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs", "lsfa_tiny_smoke.yaml")
OVERRIDES = {"network": {"add_dcn": True}}
H, W = 64, 112
FH, FW = H // 16, W // 16
TOL = dict(rtol=1e-4, atol=1e-4)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(scope="module")
def models():
    jcfg = jax_load_config(CONFIG, overrides=OVERRIDES)
    jcfg.tpu.mv_res_dtype = "float32"          # the port's payloads are float32
    jm = jax_lsfa_from_config(jcfg)
    d = jnp.zeros((1, H, W, 3))
    v = jm.init(jax.random.PRNGKey(3), d, d, d, jnp.ones((1,)), jnp.ones((1,)),
                jnp.zeros((1, FH, FW, 2)), jnp.zeros((1, FH, FW, 3)))
    v = perturb(to_numpy(v), 1)
    k = v["params"]["rfcn_cls"]["kernel"]
    v["params"]["rfcn_cls"]["kernel"] = (
        np.random.default_rng(2).normal(0, 0.05, k.shape).astype(np.float32))
    cfg = load_config(CONFIG, overrides=OVERRIDES)
    tm = lsfa_from_config(cfg)
    tm.load_state_dict(flax_to_torch(v), strict=True)
    return jcfg, jm, v, cfg, tm.eval()


def test_config_defaults_equal_jax():
    from lsfa_tpu.config import get_default_config as jax_default

    assert get_default_config() == jax_default()
    assert load_config(CONFIG, overrides=OVERRIDES) == jax_load_config(CONFIG, overrides=OVERRIDES)


def test_forward_key_and_cur_match_jax(models):
    _, jm, v, _, tm = models
    rng = np.random.default_rng(0)
    i420 = rng.integers(0, 256, (1, H * 3 // 2, W, 1), dtype=np.uint8)
    prev = rng.normal(0, 60, (1, H, W, 3)).astype(np.float32)
    feat = rng.normal(0, 1, (1, FH, FW, 64)).astype(np.float32)
    small = rng.integers(0, 256, (3, H // 4, W // 4, 3), dtype=np.uint8)   # BGR
    mv = rng.normal(0, 1.5, (3, FH, FW, 2)).astype(np.float32)
    res = rng.normal(0, 20, (3, FH, FW, 3)).astype(np.float32)
    want_k = jm.apply(v, jnp.asarray(i420), jnp.asarray(prev), jnp.asarray(feat),
                      jnp.zeros((1,)), method=jm.forward_key)
    fk = np.broadcast_to(feat, (3,) + feat.shape[1:])
    want_c = jm.apply(v, jnp.asarray(small), jnp.asarray(fk), jnp.asarray(mv),
                      jnp.asarray(res), method=jm.forward_cur)
    with torch.no_grad():
        got_k = tm.forward_key(t(i420), t(prev), t(feat), torch.zeros(1))
        got_c = tm.forward_cur(t(small), t(fk), t(mv), t(res))
    for want, got in ((want_k, got_k), (want_c, got_c)):
        assert sorted(got) == sorted(want)
        for name in want:
            assert got[name].dtype == torch.float32, name
            np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                       err_msg=name, **TOL)


def payloads(seed, n_gops):
    """Seeded stand-ins for PreparedVideo.gop tuples at the tiny bucket:
    I420 frames and smalls with the Y=16, U=V=128 pad past 60x104."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_gops):
        frames = np.zeros((12, H * 3 // 2, W, 1), np.uint8)
        smalls = np.zeros((12, H // 4 * 3 // 2, W // 4, 1), np.uint8)
        for arr, h, w, ch, cw in ((frames, H, W, 60, 104), (smalls, H // 4, W // 4, 15, 26)):
            arr[:, :h] = 16
            arr[:, h:] = 128
            arr[:, :ch, :cw] = rng.integers(16, 236, (12, ch, cw, 1))
        mv = rng.normal(0, 1.0, (12, FH, FW, 2)).astype(np.float32)
        res = rng.normal(0, 10, (12, FH, FW, 3)).astype(np.float32)
        out.append((frames, smalls, mv, res, np.asarray([60.0, 104.0, 0.5], np.float32)))
    return out


def test_streaming_two_gops_match_jax(models):
    jcfg, jm, v, cfg, tm = models
    jdet = JaxStreamingDetector(jm, v, jcfg, (H, W))
    tdet = StreamingDetector(tm, cfg, (H, W))
    p = payloads(5, 2)
    with jax.disable_jit():
        want = [np.asarray(o) for o in jdet.process_prepared_window(p, first=True)]
    got = [o.numpy() for o in tdet.process_prepared_window(p, first=True)]
    np.testing.assert_allclose(tdet.feat_key.numpy(), np.asarray(jdet.feat_key),
                               rtol=1e-3, atol=1e-3)
    assert tdet.frame_id == jdet.frame_id == 24
    for dets, valid, jd, jv in ((got[0], got[1], want[0], want[1]),
                                (got[2], got[3], want[2], want[3])):
        assert dets.shape == jd.shape and dets.shape[-1] == 6
        np.testing.assert_array_equal(valid, jv)
        assert valid.sum() > 0
        np.testing.assert_array_equal(dets[valid][:, 0], jd[jv][:, 0])
        np.testing.assert_allclose(dets[valid][:, 1], jd[jv][:, 1], rtol=0, atol=1e-5)
        np.testing.assert_allclose(dets[valid][:, 2:], jd[jv][:, 2:], rtol=0, atol=1e-3)


def test_state_lt_off_and_init_params():
    """get_state/set_state restore a stream exactly; lt_off makes every key
    frame a stream start; init_params draws the flax initializers'
    statistics from a seeded generator."""
    cfg = load_config(CONFIG, overrides=OVERRIDES)
    tm = lsfa_from_config(cfg)
    init_params(tm, torch.Generator().manual_seed(0))
    sd = tm.state_dict()
    lecun_bound = 2 * (1 / 147) ** 0.5 / 0.87962566103423978      # fan-in 7*7*3
    w0 = sd["backbone.conv0.weight"]
    assert torch.all(w0.abs() <= lecun_bound) and float(w0.abs().max()) > 0.9 * lecun_bound
    assert torch.count_nonzero(sd["backbone.stage2_unit2.conv1.offset.weight"]) == 0
    assert torch.all(sd["flownet.scale_map.bias"] == 1)
    assert abs(float(sd["rfcn_cls.weight"].std()) - 0.01) < 1e-3
    det = StreamingDetector(tm, cfg, (H, W))
    p = payloads(8, 2)
    det.process_prepared_window(p[:1], first=True)
    state = det.get_state()
    a = det.process_prepared_window(p[1:])
    det.set_state(state)
    b = det.process_prepared_window(p[1:])
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert det.frame_id == 24
    assert [det.key_frame_flag(i) for i in (0, 1, 11, 12, 13, 24)] == [0, 2, 2, 1, 2, 1]

    off = StreamingDetector(tm, cfg, (H, W), lt_off=True)
    off.process_prepared_window(p[:1], first=True)
    fresh = StreamingDetector(tm, cfg, (H, W))
    for x, y in zip(off.process_prepared_window(p[1:]),
                    fresh.process_prepared_window(p[1:], first=True)):
        assert torch.equal(x, y)


@pytest.mark.slow
def test_flagship_conversion_resnet101():
    """The flagship (ResNet-101 with DCN, FlowNet-S, feat 1024, 31 classes)
    converts at full width: the flax variable tree, built abstractly by
    eval_shape and filled with seeded numbers, loads into the port's model
    with every key and shape matching, and values land transposed."""
    jcfg = jax_load_config(None)
    jm = jax_lsfa_from_config(jcfg)

    def init():
        d = jnp.zeros((1, 64, 96, 3))
        return jm.init(jax.random.PRNGKey(0), d, d, d, jnp.ones((1,)), jnp.ones((1,)),
                       jnp.zeros((1, 4, 6, 2)), jnp.zeros((1, 4, 6, 3)))

    shapes = jax.eval_shape(init)
    rng = np.random.default_rng(0)
    v = jax.tree.map(lambda s: rng.standard_normal(s.shape, np.float32), dict(shapes))
    tm = lsfa_from_config(load_config(None))
    sd = flax_to_torch(v)
    tm.load_state_dict(sd, strict=True)
    k = v["params"]["backbone"]["stage4_unit3"]["conv2"]["kernel"]          # DCN, HWIO
    np.testing.assert_array_equal(tm.backbone.stage4_unit3.conv2.weight.detach().numpy(),
                                  k.transpose(3, 2, 0, 1))
    k = v["params"]["flownet"]["deconv2"]["kernel"]
    np.testing.assert_array_equal(tm.flownet.deconv2.weight.detach().numpy(),
                                  k[::-1, ::-1].transpose(2, 3, 0, 1))
    assert sum(t.numel() for t in sd.values()) == sum(
        t.numel() for t in tm.state_dict().values())
