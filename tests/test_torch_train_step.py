"""One whole LSFA train step of the port against the JAX package, and the
port's trainer round trip.

The tiny LSFA (configs/lsfa_tiny_smoke.yaml with DCN on, float32, RPN tier
128) takes the port's seeded init, carried into the flax tree (the inverse
of convert.flax_to_torch) and perturbed as in test_torch_convert; both
packages then take one step on the same seeded batch of two images (a key
pair and a pair that runs the long-term aggregation) with the same uniform
draws: the ones JAX's detection_losses makes from its key, passed to the
port. Tolerances (float32 on both sides, sums reassociated): the metric
dict 1e-4 relative; every gradient within 1e-3 of its tensor's largest
JAX gradient, plus 1e-6 for a gradient that cancels analytically (the
Nq-net's last bias is shared by both softmax branches: both packages give
float noise of ~1e-8 there); parameters after the SGD update within 1e-5;
frozen parameters unchanged.

The JAX step is JAX's own loss and update (value_and_grad of
forward_train + detection_losses, then the optax update, as
train_step.py:250-269 does), jitted, with XLA's algebraic simplifier off:
it would turn psroi_pool's division of the roi size by P into a multiply
by 1/P, which moves bin edges that fall exactly on a feature cell, and
proposal_target adds the gt boxes as rois. Without that pass the compiled
step divides as the op-by-op reference does
(test_jit_without_algsimp_keeps_psroi_division).
"""

import copy
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from lsfa_tpu.config import load_config as jax_load_config
from lsfa_tpu.models.lsfa import lsfa_from_config as jax_lsfa_from_config
from lsfa_tpu.ops.anchors import anchor_grid
from lsfa_tpu.ops.psroi_pool import psroi_pool as jax_psroi_pool
from lsfa_tpu.train.schedule import make_optimizer as jax_make_optimizer
from lsfa_tpu.train.train_step import TrainSettings as JaxTrainSettings
from lsfa_tpu.train.train_step import detection_losses as jax_detection_losses
from lsfa_tpu_torch.config import load_config
from lsfa_tpu_torch.convert import flax_to_torch
from lsfa_tpu_torch.data.loader import batch_to_device, synthetic_train_batches
from lsfa_tpu_torch.models.lsfa import init_params, lsfa_from_config
from lsfa_tpu_torch.train.driver import cast_parameters, init_model, train_net
from lsfa_tpu_torch.train.schedule import frozen_names, make_optimizer
from lsfa_tpu_torch.train.train_step import TrainSettings, draw_uniforms, make_train_step
from tests.test_torch_convert import perturb
from tests.test_torch_train import flax_shapes, torch_to_flax

CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs", "lsfa_tiny_smoke.yaml")
OVERRIDES = {
    "network": {"add_dcn": True},
    "TRAIN": {"RPN_PRE_NMS_TOP_N": 6000, "RPN_POST_NMS_TOP_N": 32, "BATCH_ROIS_OHEM": 16,
              "RPN_BATCH_SIZE": 64, "lr": 0.001},
    "tpu": {"nms_tier": 128, "max_gt_boxes": 8},
}
H, W = 64, 96
FH, FW = H // 16, W // 16
BATCH_KEYS = ("data", "data_ref", "data_ref_old", "eq_flag", "eq_flag_old",
              "motion_vector", "res_diff")
NO_ALGSIMP = {"xla_disable_hlo_passes": "algsimp"}


def jax_draws(rng, b, k):
    """The uniforms detection_losses draws for anchor subsampling:
    split(rng, b), then split(key) into the fg and bg keys."""
    fg, bg = [], []
    for key in jax.random.split(rng, b):
        kf, kb = jax.random.split(key)
        fg.append(np.asarray(jax.random.uniform(kf, (k,))))
        bg.append(np.asarray(jax.random.uniform(kb, (k,))))
    return {"rpn_fg": torch.from_numpy(np.stack(fg)), "rpn_bg": torch.from_numpy(np.stack(bg))}


def test_jit_without_algsimp_keeps_psroi_division():
    """Plain jit moves knife-edge PSROI bins (roi sizes a multiple of 7
    cells, edges on the grid); compiled without algsimp it equals op by op."""
    rng = np.random.default_rng(0)
    n = 200
    x1 = rng.integers(0, 40, n) * 1.0
    y1 = rng.integers(0, 30, n) * 1.0
    x2 = np.minimum(x1 + rng.integers(1, 8, n) * 7 - 1, 95)
    y2 = np.minimum(y1 + rng.integers(1, 5, n) * 7 - 1, 63)
    rois = jnp.asarray(np.stack([np.zeros(n), x1, y1, x2, y2], 1).astype(np.float32))
    feat = jnp.asarray(rng.normal(size=(FH, FW, 5 * 49)).astype(np.float32))
    with jax.disable_jit():
        eager = np.asarray(jax_psroi_pool(feat, rois, output_dim=5, spatial_scale=1 / 16))
    fn = jax.jit(lambda f, r: jax_psroi_pool(f, r, output_dim=5, spatial_scale=1 / 16))
    plain = np.asarray(fn(feat, rois))
    exact = np.asarray(fn.lower(feat, rois).compile(compiler_options=NO_ALGSIMP)(feat, rois))
    assert np.abs(plain - eager).max() > 1e-3
    np.testing.assert_array_equal(exact, eager)


@pytest.fixture(scope="module")
def stepped():
    return step_both(OVERRIDES)


def step_both(overrides, param_dtype=None):
    """One train step of the JAX package and one of the port on the tiny
    config with `overrides`, from the same weights, batch and draws.
    Returns JAX's metrics, gradients and updated parameters (as state-dict
    entries, float32), the port's metrics and gradients, its model after
    the step and its state before it. param_dtype ("bfloat16"): both
    packages store the parameters in it, from the same float32 weights
    rounded, as each package's `init_model` casts."""
    jcfg = jax_load_config(CONFIG, overrides=overrides)
    cfg = load_config(CONFIG, overrides=overrides)
    jm = jax_lsfa_from_config(jcfg)
    tm = lsfa_from_config(cfg, device="cpu")
    init_params(tm, torch.Generator().manual_seed(3))
    v = perturb(torch_to_flax(tm.state_dict(), flax_shapes(jm)), 1)
    # spread the head outputs, so that float noise reorders no proposal
    # scores and no OHEM losses (at N(0, 0.01) they are near-uniform)
    hr = np.random.default_rng(2)
    for name in ("rpn_cls_score", "rfcn_cls", "rfcn_bbox"):
        k = v["params"][name]["kernel"]
        v["params"][name]["kernel"] = hr.normal(0, 0.05, k.shape).astype(np.float32)
    tm.load_state_dict(flax_to_torch(v), strict=True)
    if param_dtype is not None:
        cast_parameters(tm, getattr(torch, param_dtype))

    batch = synthetic_train_batches(1, (H, W), seed=4, batch_images=2, max_gt=8,
                                    content_hw=(60, 90), max_boxes=5)[0]
    batch["eq_flag_old"][:] = 0.0              # image 1 runs FlowNet and the Nq-net
    rng = jax.random.PRNGKey(5)
    draws = jax_draws(rng, 2, FH * FW * jcfg.network.NUM_ANCHORS)

    # JAX: its loss, gradients and optax update, compiled without algsimp
    settings = JaxTrainSettings.from_config(jcfg)
    anchors = jnp.asarray(anchor_grid(FH, FW, settings.feat_stride,
                                      settings.anchor_ratios, settings.anchor_scales))
    jbatch = {k: jnp.asarray(a) for k, a in batch.items()}
    params = jax.tree.map(lambda x: jnp.asarray(x, param_dtype or x.dtype), v["params"])
    stats = jax.tree.map(jnp.asarray, v["batch_stats"])
    opt = jax_make_optimizer(params, base_lr=jcfg.TRAIN.lr, lr_steps=[1000])

    def step(params, opt_state, batch, rng):
        def loss_fn(p):
            out = jm.apply({"params": p, "batch_stats": stats},
                           *(batch[k] for k in BATCH_KEYS), method=jm.forward_train)
            return jax_detection_losses(out, batch, anchors, rng, settings)

        (total, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, _ = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), grads, {**metrics, "total_loss": total}

    args = (params, opt.init(params), jbatch, rng)
    new_params, grads, jmetrics = jax.jit(step).lower(*args).compile(
        compiler_options=NO_ALGSIMP)(*args)

    # the port: one step of make_train_step
    before = {k: t.clone() for k, t in tm.state_dict().items()}
    optimizer, scheduler = make_optimizer(tm, base_lr=cfg.TRAIN.lr, lr_steps=[1000])
    step = make_train_step(tm, TrainSettings.from_config(cfg), optimizer, scheduler)
    metrics = step(batch_to_device(batch, "cpu"), draws)
    numpy = lambda tree: jax.tree.map(lambda x: np.asarray(x, np.float32), tree)  # noqa: E731
    return dict(jmetrics={k: float(x) for k, x in jmetrics.items()},
                jgrads=flax_to_torch({"params": numpy(grads)}),
                jparams=flax_to_torch({"params": numpy(new_params)}),
                metrics={k: float(x) for k, x in metrics.items()},
                tgrads={n: p.grad for n, p in tm.named_parameters() if p.requires_grad},
                tm=tm, before=before)


def test_step_metrics_match_jax(stepped):
    want, got = stepped["jmetrics"], stepped["metrics"]
    assert sorted(got) == sorted(want) == sorted(
        ["rpn_acc", "rcnn_acc", "rpn_cls_loss", "rpn_bbox_loss", "rcnn_cls_loss",
         "rcnn_bbox_loss", "total_loss"])
    for k in want:
        assert np.isfinite(got[k]), k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=0, err_msg=k)
    assert want["rcnn_bbox_loss"] > 0 and want["rpn_bbox_loss"] > 0


def test_step_gradients_match_jax(stepped):
    jg, tg = stepped["jgrads"], stepped["tgrads"]
    assert set(tg) == set(jg) - frozen_names(stepped["tm"])
    for name, g in tg.items():
        want = jg[name].numpy()
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=1e-3 * scale + 1e-6,
                                   err_msg=name)
    assert float(tg["backbone.stage4_unit2.conv1.weight"].abs().max()) > 0   # DCN weights


def test_step_updated_params_match_jax(stepped):
    assert_updated_params_match(stepped)
    tm, before = stepped["tm"], stepped["before"]
    assert float((tm.rfcn_cls.weight.detach() - before["rfcn_cls.weight"]).abs().max()) > 1e-4


def assert_updated_params_match(stepped):
    """The port's parameters after the step within 1e-5 of JAX's, the
    frozen ones unchanged, and the same parameters unchanged in both."""
    tm, before, want = stepped["tm"], stepped["before"], stepped["jparams"]
    frozen = frozen_names(tm)
    still, jax_still = set(), set()
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0,
                                   atol=1e-5, err_msg=name)
        if torch.equal(p.detach(), before[name]):
            still.add(name)
        if np.array_equal(want[name].numpy(), before[name].numpy()):
            jax_still.add(name)
    assert frozen <= still
    assert still == jax_still


def test_train_step_batch_rois_without_ohem(stepped):
    """The BATCH_ROIS > 0 recipe (ENABLE_OHEM off): a fixed fg/bg roi
    minibatch from draw_uniforms' roi draws; finite metrics, heads move."""
    tm = copy.deepcopy(stepped["tm"])
    cfg = load_config(CONFIG, overrides={
        **OVERRIDES, "TRAIN": {**OVERRIDES["TRAIN"], "ENABLE_OHEM": False, "BATCH_ROIS": 16}})
    settings = TrainSettings.from_config(cfg)
    optimizer, scheduler = make_optimizer(tm, base_lr=cfg.TRAIN.lr, lr_steps=[1000])
    step = make_train_step(tm, settings, optimizer, scheduler)
    batch = batch_to_device(synthetic_train_batches(1, (H, W), seed=7, batch_images=2,
                                                    max_gt=8, content_hw=(60, 90))[0], "cpu")
    draws = draw_uniforms(settings, batch, torch.Generator().manual_seed(0))
    assert draws["roi_gap"].shape == (2, 32 + 8)
    before = tm.rfcn_bbox.weight.detach().clone()
    metrics = step(batch, draws)
    assert all(np.isfinite(float(v)) for v in metrics.values()), metrics
    assert float(metrics["rcnn_bbox_loss"]) > 0
    assert not torch.equal(tm.rfcn_bbox.weight.detach(), before)


def test_train_net_resume_equals_straight_run(tmp_path):
    """2 steps, checkpoint, resume, 1 step == 3 straight steps: weights,
    optimizer momentum, schedule and the generator's draws all resume."""
    cfg = load_config(CONFIG, overrides={
        **OVERRIDES, "TRAIN": {**OVERRIDES["TRAIN"], "end_epoch": 2, "lr_step": "1.0"}})
    batches = synthetic_train_batches(2, (H, W), seed=6, max_gt=8, content_hw=(60, 90))
    straight_m, resumed_m = [], []

    def hook(log):
        return lambda step, m: log.append((step, float(m["total_loss"])))

    model = init_model(cfg, 0, device="cpu")
    ckpt = str(tmp_path / "ckpt")
    train_net(cfg, batches=batches, ckpt_dir=ckpt, max_steps=2, model=copy.deepcopy(model),
              metrics_hook=hook(resumed_m), seed=9)
    straight = train_net(cfg, batches=batches, max_steps=3, model=model,
                         metrics_hook=hook(straight_m), seed=9)
    assert sorted(os.listdir(ckpt)) == ["1.pt"]
    cfg.TRAIN.RESUME = True                    # into an uninitialized model
    resumed = train_net(cfg, batches=batches, ckpt_dir=ckpt, max_steps=1,
                        model=lsfa_from_config(cfg, device="cpu"), metrics_hook=hook(resumed_m), seed=0)
    assert resumed_m == straight_m and [s for s, _ in straight_m] == [0, 1, 2]
    for (name, a), b in zip(straight.state_dict().items(), resumed.state_dict().values()):
        assert torch.equal(a, b), name
