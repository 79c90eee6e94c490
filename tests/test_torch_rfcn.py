"""The single-frame R-FCN baseline of the port against the JAX package.

The tiny R-FCN (configs/rfcn_tiny_smoke.yaml: ResNet-18, feat 64, 64x112,
float32) is initialized by flax, perturbed as in test_torch_convert (its
BatchNorms get non-trivial statistics), its rfcn_cls and rpn_cls_score
kernels spread to std 0.05 (at N(0, 0.01) the scores are near-uniform and
float noise would reorder them), and carried across by
convert.flax_to_torch. Then:
- the forward: every output within 1e-4 of its largest value (float32,
  sums reassociated);
- RFCNDetector.detect: valid masks equal, sorted scores within 1e-4;
- one train step of make_rfcn_train_step against JAX's step
  (train_step.py::make_rfcn_train_step: the forward of data alone, the
  anchor grid at data's size // stride), with the tolerances of
  test_torch_train_step: metrics 1e-4 relative, gradients 1e-3 of the
  tensor's largest, parameters 1e-5.
JAX's detector step and train step are compiled with XLA's algsimp pass
off, which keeps psroi_pool's division (test_torch_train_step explains
why). Last, the trainer on the R-FCN config (init_model, train_net with
a checkpoint and resume) and the smoke script's copy of the published
R-FCN config.
"""

import copy
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from lsfa_tpu.config import load_config as jax_load_config
from lsfa_tpu.eval.rfcn_tester import RFCNDetector as JaxRFCNDetector
from lsfa_tpu.eval.rfcn_tester import rfcn_from_config as jax_rfcn_from_config
from lsfa_tpu.ops.anchors import anchor_grid
from lsfa_tpu.train.schedule import make_optimizer as jax_make_optimizer
from lsfa_tpu.train.train_step import TrainSettings as JaxTrainSettings
from lsfa_tpu.train.train_step import detection_losses as jax_detection_losses
from lsfa_tpu_torch.config import load_config
from lsfa_tpu_torch.convert import flax_to_torch
from lsfa_tpu_torch.data.loader import batch_to_device, synthetic_train_batches
from lsfa_tpu_torch.eval.rfcn_tester import RFCNDetector, rfcn_from_config
from lsfa_tpu_torch.models.rfcn import RFCN
from lsfa_tpu_torch.train.checkpoint import seed_small_net
from lsfa_tpu_torch.train.driver import init_model, is_rfcn, train_net
from lsfa_tpu_torch.train.schedule import frozen_names, make_optimizer
from lsfa_tpu_torch.train.train_step import TrainSettings, make_rfcn_train_step
from tests.test_torch_convert import perturb, to_numpy
from tests.test_torch_train_step import NO_ALGSIMP, jax_draws

ROOT = os.path.join(os.path.dirname(__file__), "..")
CONFIG = os.path.join(ROOT, "configs", "rfcn_tiny_smoke.yaml")
FLAGSHIP = os.path.join(ROOT, "configs", "rfcn_resnet101_vid.yaml")
OVERRIDES = {
    "TRAIN": {"RPN_PRE_NMS_TOP_N": 6000, "RPN_POST_NMS_TOP_N": 32, "BATCH_ROIS_OHEM": 16,
              "RPN_BATCH_SIZE": 64},
    "tpu": {"nms_tier": 128, "max_gt_boxes": 8},
}
H, W = 64, 112
FH, FW = H // 16, W // 16


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(scope="module")
def models():
    jcfg = jax_load_config(CONFIG, overrides=OVERRIDES)
    jm = jax_rfcn_from_config(jcfg)
    v = perturb(to_numpy(jm.init(jax.random.PRNGKey(3), jnp.zeros((1, H, W, 3)), False)), 1)
    hr = np.random.default_rng(2)
    for name in ("rpn_cls_score", "rfcn_cls", "rfcn_bbox"):
        k = v["params"][name]["kernel"]
        v["params"][name]["kernel"] = hr.normal(0, 0.05, k.shape).astype(np.float32)
    cfg = load_config(CONFIG, overrides=OVERRIDES)
    tm = rfcn_from_config(cfg, device="cpu")
    tm.load_state_dict(flax_to_torch(v), strict=True)
    return jcfg, jm, v, cfg, tm


def test_rfcn_forward_matches_jax(models):
    _, jm, v, _, tm = models
    data = np.random.default_rng(0).integers(0, 256, (2, H, W, 3), dtype=np.uint8)
    want = jax.jit(lambda d: jm.apply(v, d))(data)
    with torch.no_grad():
        got = tm.eval()(t(data))
    assert sorted(got) == sorted(want)
    for name in want:
        w = np.asarray(want[name])
        assert got[name].shape == w.shape, name
        np.testing.assert_allclose(got[name].numpy(), w, rtol=0,
                                   atol=1e-4 * max(1.0, float(np.abs(w).max())), err_msg=name)
    assert got["rpn_cls"].dtype == torch.float32 and got["rpn_fg"].shape == (2, FH, FW, 9)


def test_rfcn_detector_matches_jax(models):
    jcfg, jm, v, cfg, tm = models
    jdet = JaxRFCNDetector(jm, v, jcfg, (H, W))
    det = RFCNDetector(tm, cfg, (H, W))
    rng = np.random.default_rng(1)
    for scale, (ch, cw) in ((0.5, (60, 104)), (1.0, (48, 80))):
        data = np.zeros((1, H, W, 3), np.uint8)
        data[:, :ch, :cw] = rng.integers(0, 256, (1, ch, cw, 3), dtype=np.uint8)
        info = np.asarray([[ch, cw, scale]], np.float32)
        args = (jdet.variables, jnp.asarray(data), jnp.asarray(info))
        want_d, want_v = jdet._step.lower(*args).compile(compiler_options=NO_ALGSIMP)(*args)
        got_d, got_v = det.detect(data, info)
        assert got_d.shape == (20, 6) and got_v.shape == (20,)
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
        assert int(got_v.sum()) > 5
        np.testing.assert_allclose(np.sort(got_d[:, 1].numpy()), np.sort(np.asarray(want_d)[:, 1]),
                                   rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def stepped(models):
    jcfg, jm, v, cfg, _ = models
    tm = rfcn_from_config(cfg, device="cpu")
    tm.load_state_dict(flax_to_torch(v), strict=True)
    batch = synthetic_train_batches(1, (H, W), seed=4, batch_images=2, max_gt=8,
                                    content_hw=(60, 104), max_boxes=5)[0]
    rng = jax.random.PRNGKey(5)
    draws = jax_draws(rng, 2, FH * FW * jcfg.network.NUM_ANCHORS)

    # JAX: make_rfcn_train_step's loss and update, compiled without algsimp
    settings = JaxTrainSettings.from_config(jcfg)
    anchors = jnp.asarray(anchor_grid(FH, FW, settings.feat_stride,
                                      settings.anchor_ratios, settings.anchor_scales))
    jbatch = {k: jnp.asarray(a) for k, a in batch.items()}
    params = jax.tree.map(jnp.asarray, v["params"])
    stats = jax.tree.map(jnp.asarray, v["batch_stats"])
    opt = jax_make_optimizer(params, base_lr=jcfg.TRAIN.lr, lr_steps=[1000])

    def step(params, opt_state, batch, rng):
        def loss_fn(p):
            out = jm.apply({"params": p, "batch_stats": stats}, batch["data"], True)
            return jax_detection_losses(out, batch, anchors, rng, settings)

        (total, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, _ = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), grads, {**metrics, "total_loss": total}

    args = (params, opt.init(params), jbatch, rng)
    new_params, grads, jmetrics = jax.jit(step).lower(*args).compile(
        compiler_options=NO_ALGSIMP)(*args)

    before = {k: x.clone() for k, x in tm.state_dict().items()}
    optimizer, scheduler = make_optimizer(tm, base_lr=cfg.TRAIN.lr, lr_steps=[1000])
    step = make_rfcn_train_step(tm, TrainSettings.from_config(cfg), optimizer, scheduler)
    metrics = step(batch_to_device(batch, "cpu"), draws)
    numpy = lambda tree: jax.tree.map(np.asarray, tree)   # noqa: E731
    return dict(jmetrics={k: float(x) for k, x in jmetrics.items()},
                jgrads=flax_to_torch({"params": numpy(grads)}),
                jparams=flax_to_torch({"params": numpy(new_params)}),
                metrics={k: float(x) for k, x in metrics.items()},
                tgrads={n: p.grad for n, p in tm.named_parameters() if p.requires_grad},
                tm=tm, before=before)


def test_rfcn_step_metrics_match_jax(stepped):
    want, got = stepped["jmetrics"], stepped["metrics"]
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.isfinite(got[k]), k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=0, err_msg=k)
    assert want["rcnn_bbox_loss"] > 0 and want["rpn_bbox_loss"] > 0


def test_rfcn_step_gradients_match_jax(stepped):
    jg, tg = stepped["jgrads"], stepped["tgrads"]
    assert set(tg) == set(jg) - frozen_names(stepped["tm"])
    for name, g in tg.items():
        want = jg[name].numpy()
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=1e-3 * float(np.abs(want).max()) + 1e-6, err_msg=name)
    assert float(tg["feat_conv_3x3.weight"].abs().max()) > 0


def test_rfcn_step_updated_params_match_jax(stepped):
    tm, before, want = stepped["tm"], stepped["before"], stepped["jparams"]
    frozen = frozen_names(tm)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)
        assert torch.equal(p.detach(), before[name]) == (name in frozen), name


def test_rfcn_init_model_and_train_net_resume(tmp_path):
    """init_model builds the R-FCN for an rfcn* symbol (seed_small_net
    leaves its state dict unchanged); train_net runs make_rfcn_train_step,
    and 1 step, checkpoint, resume, 1 step equals 2 straight steps."""
    cfg = load_config(CONFIG, overrides={**OVERRIDES, "TRAIN": {
        **OVERRIDES["TRAIN"], "end_epoch": 2, "lr_step": "1.0"}})
    assert is_rfcn(cfg)
    model = init_model(cfg, 0, device="cpu")
    assert isinstance(model, RFCN) and model.backbone.conv0.weight.device.type == "cpu"
    state = model.state_dict()
    seeded = seed_small_net(state)
    assert seeded.keys() == state.keys() and all(seeded[k] is state[k] for k in state)
    state = {k: x.clone() for k, x in state.items()}
    batches = synthetic_train_batches(1, (H, W), seed=6, max_gt=8, content_hw=(60, 104))
    straight_m, resumed_m = [], []

    def hook(log):
        return lambda step, m: log.append((step, float(m["total_loss"])))

    ckpt = str(tmp_path / "ckpt")
    train_net(cfg, batches=batches, ckpt_dir=ckpt, max_steps=1, model=copy.deepcopy(model),
              metrics_hook=hook(resumed_m), seed=9)
    straight = train_net(cfg, batches=batches, max_steps=2, model=model,
                         metrics_hook=hook(straight_m), seed=9)
    assert sorted(os.listdir(ckpt)) == ["1.pt"]
    cfg.TRAIN.RESUME = True
    resumed = train_net(cfg, batches=batches, ckpt_dir=ckpt, max_steps=1,
                        model=rfcn_from_config(cfg, device="cpu"),
                        metrics_hook=hook(resumed_m), seed=0)
    assert resumed_m == straight_m and all(np.isfinite(x) for _, x in straight_m)
    for (name, a), b in zip(straight.state_dict().items(), resumed.state_dict().values()):
        assert torch.equal(a, b), name
    assert not torch.equal(straight.rfcn_cls.weight, state["rfcn_cls.weight"])


def test_rfcn_constructors_default_to_the_card():
    """rfcn_from_config, init_model and train_net build the R-FCN on the
    card when no device is given; without a card they raise."""
    cfg = load_config(CONFIG)
    if not torch.cuda.is_available():
        for build in (rfcn_from_config, init_model, lambda c: train_net(c, batches=[])):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                build(cfg)
        return
    for model in (rfcn_from_config(cfg), init_model(cfg)):
        assert {p.device.type for p in model.parameters()} == {"cuda"}


def test_chip_smoke_rfcn_overrides_equal_published_config():
    """chip_smoke.py reads configs/rfcn_resnet101_vid.yaml through its JSON
    twin (no yaml on the card's machine); both load to the same tree, which
    is also the JAX package's."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    ours = load_config(chip_smoke.RFCN_CONFIG)
    assert ours == load_config(FLAGSHIP) == jax_load_config(FLAGSHIP)
    assert (ours.network.num_layer, ours.network.add_dcn, ours.network.DFF_FEAT_DIM,
            ours.tpu.compute_dtype, ours.tpu.nms_tier, ours.TEST.NMS) == (
                101, False, 1024, "bfloat16", 2048, 0.3)


@pytest.mark.slow
def test_flagship_rfcn_state_dict_matches_flax():
    """The published R-FCN (ResNet-101, feat 1024) at full width: the flax
    variable tree converts onto the port's state dict, key for key and
    shape for shape (abstract init, no compile)."""
    jcfg = jax_load_config(FLAGSHIP)
    jm = jax_rfcn_from_config(jcfg)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 608, 1024, 3)), False)
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), dict(shapes))
    model = rfcn_from_config(load_config(FLAGSHIP), device="meta")
    want = {k: tuple(x.shape) for k, x in model.state_dict().items()}
    got = {k: tuple(x.shape) for k, x in flax_to_torch(zeros).items()}
    assert got == want
