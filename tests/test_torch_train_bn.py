"""The train-mode BatchNorm variants of LSFA (network.res_diff_bn,
network.small_net_bn_before_fuse) against the JAX package.

The BatchNorm layer against flax's at momentum 0.9 (batch mean and biased
variance in float32, running statistics moved by 0.1 of the batch's),
then the tiny LSFA (configs/lsfa_tiny_smoke.yaml, float32, RPN tier 128)
with both variants on: one whole train step against JAX's, the updated
`batch_stats` against the port's running statistics, and forward_key /
forward_cur in eval mode. Weights are the port's seeded init carried into
the flax tree and perturbed as in test_torch_convert, so every BatchNorm
starts from non-trivial statistics. Tolerances are those of
test_torch_train_step (metrics 1e-4 relative, gradients 1e-3 of the
tensor's largest, parameters 1e-5) and, for the running statistics,
1e-5 relative; the JAX step is compiled with XLA's algsimp pass off for
the reason given there.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from lsfa_tpu.config import load_config as jax_load_config
from lsfa_tpu.models.layers import BatchNorm as JaxBatchNorm
from lsfa_tpu.models.lsfa import lsfa_from_config as jax_lsfa_from_config
from lsfa_tpu.ops.anchors import anchor_grid
from lsfa_tpu.train.schedule import freeze_mask, make_optimizer as jax_make_optimizer
from lsfa_tpu.train.train_step import TrainSettings as JaxTrainSettings
from lsfa_tpu.train.train_step import detection_losses as jax_detection_losses
from lsfa_tpu_torch.config import load_config
from lsfa_tpu_torch.convert import flax_to_torch
from lsfa_tpu_torch.data.loader import batch_to_device, synthetic_train_batches
from lsfa_tpu_torch.models.layers import BatchNorm
from lsfa_tpu_torch.models.lsfa import init_params, lsfa_from_config
from lsfa_tpu_torch.train.schedule import frozen_names, make_optimizer
from lsfa_tpu_torch.train.train_step import TrainSettings, make_train_step
from tests.test_torch_convert import perturb
from tests.test_torch_train import flax_shapes, torch_to_flax
from tests.test_torch_train_step import BATCH_KEYS, NO_ALGSIMP, jax_draws

CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs", "lsfa_tiny_smoke.yaml")
OVERRIDES = {
    "network": {"res_diff_bn": True, "small_net_bn_before_fuse": True},
    "TRAIN": {"RPN_PRE_NMS_TOP_N": 6000, "RPN_POST_NMS_TOP_N": 32, "BATCH_ROIS_OHEM": 16,
              "RPN_BATCH_SIZE": 64, "lr": 0.001},
    "tpu": {"nms_tier": 128, "max_gt_boxes": 8},
}
H, W = 64, 96
FH, FW = H // 16, W // 16
BNS = ("rnet.bn", "small_fuse.cur_feat_bn", "small_fuse.warp_conv_feat_bn")


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("train,dtype", [(True, "float32"), (False, "float32"),
                                         (True, "bfloat16")])
def test_batchnorm_matches_flax(train, dtype):
    """Output and updated running statistics of one call; torch's own
    F.batch_norm update (unbiased variance) would differ."""
    rng = np.random.default_rng(0)
    x = (rng.normal(0, 3, (3, 4, 6, 5)) + 2.0).astype(np.float32)         # NHWC, 5 channels
    scale, bias = rng.uniform(0.5, 1.5, 5), rng.normal(0, 0.1, 5)
    mean, var = rng.normal(0, 0.5, 5), rng.uniform(0.5, 2.0, 5)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    variables = {"params": {"BatchNorm_0": {"scale": scale, "bias": bias}},
                 "batch_stats": {"BatchNorm_0": {"mean": mean, "var": var}}}
    variables = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), variables)
    jbn = JaxBatchNorm(frozen=False, dtype=jdt)
    want, mut = jbn.apply(variables, jnp.asarray(x).astype(jdt), train, mutable=["batch_stats"])
    bn = BatchNorm(5, dtype=tdt)
    sd = flax_to_torch({c: {"bn": tree} for c, tree in jax.tree.map(np.asarray, variables).items()})
    bn.load_state_dict({k.split(".", 1)[1]: x for k, x in sd.items()})
    bn.train(train)
    got = bn(t(x).to(tdt).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.dtype == tdt
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)
    stats = flatten_dict(jax.tree.map(np.asarray, dict(mut["batch_stats"])))
    np.testing.assert_allclose(bn.running_mean.numpy(), stats[("BatchNorm_0", "mean")],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), stats[("BatchNorm_0", "var")],
                               rtol=1e-6, atol=1e-6)
    if train:
        assert not np.allclose(bn.running_var.numpy(), var)
        rv = torch.tensor(var, dtype=torch.float32)
        torch.nn.functional.batch_norm(t(x).permute(0, 3, 1, 2), torch.zeros(5), rv,
                                       training=True, momentum=0.1)
        assert not np.allclose(rv.numpy(), stats[("BatchNorm_0", "var")], rtol=1e-4)
    else:
        np.testing.assert_array_equal(bn.running_var.numpy(), np.float32(var))


@pytest.fixture(scope="module")
def stepped():
    jcfg = jax_load_config(CONFIG, overrides=OVERRIDES)
    cfg = load_config(CONFIG, overrides=OVERRIDES)
    jm = jax_lsfa_from_config(jcfg)
    tm = lsfa_from_config(cfg, device="cpu")
    init_params(tm, torch.Generator().manual_seed(3))
    v = perturb(torch_to_flax(tm.state_dict(), flax_shapes(jm)), 1)
    hr = np.random.default_rng(2)
    for name in ("rpn_cls_score", "rfcn_cls", "rfcn_bbox"):
        k = v["params"][name]["kernel"]
        v["params"][name]["kernel"] = hr.normal(0, 0.05, k.shape).astype(np.float32)
    tm.load_state_dict(flax_to_torch(v), strict=True)
    start = {k: x.clone() for k, x in tm.state_dict().items()}

    batch = synthetic_train_batches(1, (H, W), seed=4, batch_images=2, max_gt=8,
                                    content_hw=(60, 90), max_boxes=5)[0]
    batch["eq_flag_old"][:] = 0.0
    rng = jax.random.PRNGKey(5)
    draws = jax_draws(rng, 2, FH * FW * jcfg.network.NUM_ANCHORS)

    settings = JaxTrainSettings.from_config(jcfg)
    anchors = jnp.asarray(anchor_grid(FH, FW, settings.feat_stride,
                                      settings.anchor_ratios, settings.anchor_scales))
    jbatch = {k: jnp.asarray(a) for k, a in batch.items()}
    params = jax.tree.map(jnp.asarray, v["params"])
    stats = jax.tree.map(jnp.asarray, v["batch_stats"])
    opt = jax_make_optimizer(params, base_lr=jcfg.TRAIN.lr, lr_steps=[1000])

    def step(params, stats, opt_state, batch, rng):
        def loss_fn(p):
            out, mut = jm.apply({"params": p, "batch_stats": stats},
                                *(batch[k] for k in BATCH_KEYS), method=jm.forward_train,
                                mutable=["batch_stats"])
            total, metrics = jax_detection_losses(out, batch, anchors, rng, settings)
            return total, (metrics, mut["batch_stats"])

        (total, (metrics, new_stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, _ = opt.update(grads, opt_state, params)
        return (optax.apply_updates(params, updates), new_stats, grads,
                {**metrics, "total_loss": total})

    args = (params, stats, opt.init(params), jbatch, rng)
    new_params, new_stats, grads, jmetrics = jax.jit(step).lower(*args).compile(
        compiler_options=NO_ALGSIMP)(*args)

    optimizer, scheduler = make_optimizer(tm, base_lr=cfg.TRAIN.lr, lr_steps=[1000])
    metrics = make_train_step(tm, TrainSettings.from_config(cfg), optimizer, scheduler)(
        batch_to_device(batch, "cpu"), draws)
    numpy = lambda tree: jax.tree.map(np.asarray, tree)   # noqa: E731
    return dict(jm=jm, v=v, cfg=cfg, start=start,
                jmetrics={k: float(x) for k, x in jmetrics.items()},
                jgrads=flax_to_torch({"params": numpy(grads)}),
                jstate=flax_to_torch({"params": numpy(new_params),
                                      "batch_stats": numpy(dict(new_stats))}),
                metrics={k: float(x) for k, x in metrics.items()},
                tgrads={n: p.grad for n, p in tm.named_parameters() if p.requires_grad},
                tm=tm)


def test_bn_step_metrics_and_gradients_match_jax(stepped):
    want, got = stepped["jmetrics"], stepped["metrics"]
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=0, err_msg=k)
    jg, tg = stepped["jgrads"], stepped["tgrads"]
    assert set(tg) == set(jg) - frozen_names(stepped["tm"])
    for name, g in tg.items():
        w = jg[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-3 * float(np.abs(w).max()) + 1e-6,
                                   err_msg=name)
    # the gradient reaches the R-net's conv through its batch-normalized input
    assert float(tg["rnet.conv0.weight"].abs().max()) > 0


def test_bn_step_parameters_and_running_statistics_match_jax(stepped):
    """Parameters after the update within 1e-5; the running statistics of
    every BatchNorm equal JAX's updated batch_stats: the three variant
    BatchNorms moved, the frozen ones did not."""
    tm, want, start = stepped["tm"], stepped["jstate"], stepped["start"]
    state = tm.state_dict()
    assert sorted(state) == sorted(want)
    for name, x in state.items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(x.numpy(), want[name].numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(x.numpy(), want[name].numpy(), rtol=0, atol=1e-5,
                                       err_msg=name)
    moved = {k for k, x in state.items() if k.endswith(("running_mean", "running_var"))
             and not torch.equal(x, start[k])}
    assert moved == {f"{bn}.{s}" for bn in BNS for s in ("running_mean", "running_var")}
    for bn in BNS:                      # FIXED_PARAMS: scale and bias stay
        for p in ("weight", "bias"):
            assert torch.equal(state[f"{bn}.{p}"], start[f"{bn}.{p}"])


def test_bn_variants_eval_forward_matches_jax(stepped):
    """forward_key and forward_cur in eval mode (running statistics) on the
    perturbed weights, against JAX's inference graphs."""
    jm, v, cfg = stepped["jm"], stepped["v"], stepped["cfg"]
    tm = lsfa_from_config(cfg, device="cpu")
    tm.load_state_dict(flax_to_torch(v), strict=True)
    tm.eval()
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, (1, H, W, 3), dtype=np.uint8)
    prev = rng.normal(0, 60, (1, H, W, 3)).astype(np.float32)
    feat = rng.normal(0, 1, (1, FH, FW, 64)).astype(np.float32)
    small = rng.integers(0, 256, (3, H // 4, W // 4, 3), dtype=np.uint8)
    mv = rng.normal(0, 1.5, (3, FH, FW, 2)).astype(np.float32)
    res = rng.normal(0, 20, (3, FH, FW, 3)).astype(np.float32)
    fk = np.broadcast_to(feat, (3,) + feat.shape[1:])
    want_k = jax.jit(lambda *a: jm.apply(v, *a, method=jm.forward_key))(
        data, prev, feat, jnp.zeros((1,)))
    want_c = jax.jit(lambda *a: jm.apply(v, *a, method=jm.forward_cur))(small, fk, mv, res)
    with torch.no_grad():
        got_k = tm.forward_key(t(data), t(prev), t(feat), torch.zeros(1))
        got_c = tm.forward_cur(t(small), t(fk), t(mv), t(res))
    for want, got in ((want_k, got_k), (want_c, got_c)):
        assert sorted(got) == sorted(want)
        for name in want:
            w = np.asarray(want[name])
            np.testing.assert_allclose(got[name].numpy(), w, rtol=1e-4,
                                       atol=1e-4 * max(1.0, float(np.abs(w).max())), err_msg=name)


def test_freeze_and_init_cover_train_mode_bn():
    """frozen_names and init_params reach the variant BatchNorms: their
    scale and bias are frozen as JAX's freeze_mask freezes them, and
    init_params gives them scale 1, bias 0, mean 0, var 1."""
    jm = jax_lsfa_from_config(jax_load_config(CONFIG, overrides=OVERRIDES))
    tm = lsfa_from_config(load_config(CONFIG, overrides=OVERRIDES), device="cpu")
    with torch.no_grad():
        for bn in BNS:
            for x in tm.get_submodule(bn).state_dict().values():
                x.fill_(7.0)
    init_params(tm, torch.Generator().manual_seed(0))
    for bn in BNS:
        m = tm.get_submodule(bn)
        assert isinstance(m, BatchNorm)
        for x, want in ((m.weight, 1.0), (m.bias, 0.0), (m.running_mean, 0.0),
                        (m.running_var, 1.0)):
            assert torch.all(x == want), bn
    v = torch_to_flax(tm.state_dict(), flax_shapes(jm))
    mask = flatten_dict(freeze_mask(v["params"]))
    frozen = {p: x for p, x in flatten_dict(v["params"]).items() if not mask[p]}
    want = set(flax_to_torch({"params": unflatten_dict(frozen)}))
    assert want == frozen_names(tm)
    assert {f"{bn}.{p}" for bn in BNS for p in ("weight", "bias")} <= want
