"""The port's training modules against the JAX package's, module by module.

Inputs are made with numpy from a seed and handed to both packages; the
random draws of the subsampling are the ones the JAX function makes from
its key, passed to the port as tensors. JAX functions run jitted (none of
these reaches psroi_pool). Tolerances: labels, masks and selections equal;
float32 values 1e-5; the model's forward_train 1e-4 of each output's
largest value (sums reassociated over a whole network whose features
reach ~100 with perturbed BatchNorms; op by op JAX differs from its own
jit by as much).
"""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from lsfa_tpu.config import load_config as jax_load_config
from lsfa_tpu.data.loader import collate_train_batch as jax_collate
from lsfa_tpu.models.lsfa import lsfa_from_config as jax_lsfa_from_config
from lsfa_tpu.ops import boxes as jboxes
from lsfa_tpu.ops.anchors import anchor_grid
from lsfa_tpu.train import checkpoint as jckpt
from lsfa_tpu.train import losses as jlosses
from lsfa_tpu.train import metrics as jmetrics
from lsfa_tpu.train.anchor_assign import assign_anchors as jax_assign_anchors
from lsfa_tpu.train.ohem import ohem_select as jax_ohem_select
from lsfa_tpu.train.proposal_target import proposal_target as jax_proposal_target
from lsfa_tpu.train.proposal_target import sample_rois_fixed as jax_sample_rois_fixed
from lsfa_tpu.train.schedule import freeze_mask, make_optimizer as jax_make_optimizer
from lsfa_tpu.train.schedule import warmup_multifactor as jax_warmup_multifactor
from lsfa_tpu_torch.config import load_config
from lsfa_tpu_torch.convert import flax_to_torch
from lsfa_tpu_torch.data.loader import (
    collate_train_batch, synthetic_sample, synthetic_train_batches)
from lsfa_tpu_torch.models.lsfa import init_params, lsfa_from_config
from lsfa_tpu_torch.ops.boxes import bbox_transform, iou_transform
from lsfa_tpu_torch.train import checkpoint, losses, metrics
from lsfa_tpu_torch.train.anchor_assign import assign_anchors
from lsfa_tpu_torch.train.driver import init_model
from lsfa_tpu_torch.train.ohem import ohem_select
from lsfa_tpu_torch.train.proposal_target import proposal_target, sample_rois_fixed
from lsfa_tpu_torch.train.schedule import frozen_names, make_optimizer, warmup_multifactor
from tests.test_torch_convert import perturb

CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs", "lsfa_tiny_smoke.yaml")
H, W = 64, 96
FH, FW = H // 16, W // 16
TOL = dict(rtol=1e-5, atol=1e-5)


def t(x):
    return torch.from_numpy(np.array(x))


def torch_to_flax(state_dict, shapes):
    """The inverse of convert.flax_to_torch onto the flax variable tree
    whose leaves `shapes` gives (numpy leaves)."""
    names = {"scale": "weight", "bias": "bias", "mean": "running_mean",
             "var": "running_var", "kernel": "weight"}
    out = {}
    for col, tree in shapes.items():
        flat = {}
        for path, leaf in flatten_dict(tree).items():
            mods = [p for p in path[:-1] if p != "BatchNorm_0"]
            a = state_dict[".".join(mods + [names[path[-1]]])].numpy()
            if path[-1] == "kernel" and a.ndim == 4:
                a = (a.transpose(2, 3, 0, 1)[::-1, ::-1]
                     if mods[-1].startswith(("deconv", "upflow")) else a.transpose(2, 3, 1, 0))
            elif path[-1] == "kernel" and a.ndim == 2:
                a = a.T
            assert a.shape == leaf.shape, path
            flat[path] = np.ascontiguousarray(a)
        out[col] = unflatten_dict(flat)
    return out


def flax_shapes(jm, h=H, w=W):
    """The flax variable tree of `jm`, abstractly (no compile)."""
    d = jnp.zeros((1, h, w, 3))
    return dict(jax.eval_shape(jm.init, jax.random.PRNGKey(0), d, d, d, jnp.ones((1,)),
                               jnp.ones((1,)), jnp.zeros((1, h // 16, w // 16, 2)),
                               jnp.zeros((1, h // 16, w // 16, 3))))


def random_boxes(rng, shape, hi_x=90.0, hi_y=60.0, min_wh=4.0, max_wh=40.0):
    x1 = rng.uniform(0, hi_x - min_wh, shape)
    y1 = rng.uniform(0, hi_y - min_wh, shape)
    x2 = np.minimum(x1 + rng.uniform(min_wh, max_wh, shape), hi_x)
    y2 = np.minimum(y1 + rng.uniform(min_wh, max_wh, shape), hi_y)
    return np.stack([x1, y1, x2, y2], -1).astype(np.float32)


@pytest.mark.parametrize("path", [None, CONFIG])
def test_train_settings_equal_jax(path):
    from lsfa_tpu.train.train_step import TrainSettings as JaxTrainSettings
    from lsfa_tpu_torch.train.train_step import TrainSettings

    ours = dataclasses.asdict(TrainSettings.from_config(load_config(path)))
    theirs = dataclasses.asdict(JaxTrainSettings.from_config(jax_load_config(path)))
    del theirs["nms_pallas"]           # the port takes the kernel on any card
    assert ours == theirs


def test_bbox_and_iou_transform_match_jax():
    rng = np.random.default_rng(0)
    ex, gt = random_boxes(rng, (50,)), random_boxes(rng, (50,))
    np.testing.assert_allclose(bbox_transform(t(ex), t(gt)).numpy(),
                               np.asarray(jboxes.bbox_transform(ex, gt)), **TOL)
    # broadcast over a leading batch dim, as the anchor assignment uses it
    np.testing.assert_allclose(bbox_transform(t(ex), t(np.stack([gt, ex]))).numpy()[0],
                               np.asarray(jboxes.bbox_transform(ex, gt)), **TOL)
    np.testing.assert_array_equal(iou_transform(t(ex), t(gt)).numpy(),
                                  np.asarray(jboxes.iou_transform(ex, gt)))


def gt_batch(rng, counts, num_classes=5, max_gt=8):
    """(B, max_gt, 5) padded gt and (B, max_gt) validity; image 0's first
    box sits halfway between two anchors of one shape, so that both are
    its best anchors (a tie)."""
    b = len(counts)
    gt = np.zeros((b, max_gt, 5), np.float32)
    gv = np.zeros((b, max_gt), bool)
    for i, n in enumerate(counts):
        gt[i, :n, :4] = random_boxes(rng, (n,), max_wh=50.0)
        gt[i, :n, 4] = rng.integers(1, num_classes, n)
        gv[i, :n] = True
    if counts[0]:
        a = anchor_grid(FH, FW, 16, (0.5, 1, 2), (1, 2, 4))[9 * (FW + 1) + 4]   # (1, 1), ratio 1
        gt[0, 0, :4] = a + np.float32([8.0, 0.0, 8.0, 0.0])
    return gt, gv


@pytest.mark.parametrize("case", ["keep_positives", "clobber_positives", "no_gt"])
def test_assign_anchors_matches_jax(case):
    rng = np.random.default_rng(1)
    anchors = anchor_grid(FH, FW, 16, (0.5, 1, 2), (1, 2, 4))
    k = anchors.shape[0]
    gt, gv = gt_batch(rng, [0, 0] if case == "no_gt" else [6, 3])
    im_info = np.asarray([[60.0, 90.0, 1.0], [52.0, 80.0, 1.0]], np.float32)
    kw = dict(rpn_batch=32, fg_fraction=0.25, pos_thresh=0.5, neg_thresh=0.3,
              clobber_positives=case == "clobber_positives",
              rpn_bbox_weights=(1.0, 0.5, 1.0, 2.0))
    keys = jax.random.split(jax.random.PRNGKey(7), 2)
    want = jax.jit(jax.vmap(lambda g, v, i, key: jax_assign_anchors(
        jnp.asarray(anchors), g, v, i, key, **kw)))(gt, gv, im_info, keys)
    u = [[np.asarray(jax.random.uniform(sk, (k,))) for sk in jax.random.split(key)]
         for key in keys]
    got = assign_anchors(t(anchors), t(gt), t(gv), t(im_info), t([x[0] for x in u]),
                         t([x[1] for x in u]), **kw)
    np.testing.assert_array_equal(got["label"].numpy(), np.asarray(want["label"]))
    for name in ("bbox_target", "bbox_weight"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), err_msg=name, **TOL)
    label = got["label"].numpy()
    assert (label == 0).sum(-1).max() > 0
    if case != "no_gt":
        n_fg = (label == 1).sum(-1)
        assert n_fg.max() == 8 if case == "keep_positives" else n_fg.max() <= 8   # fg quota
        assert ((label >= 0).sum(-1) == 32).all()       # bg filled the batch


@pytest.mark.parametrize("num_reg_classes", [2, 5])
def test_proposal_target_matches_jax(num_reg_classes):
    rng = np.random.default_rng(2)
    gt, gv = gt_batch(rng, [4, 2])
    rois = np.zeros((2, 30, 5), np.float32)
    rois[..., 1:] = random_boxes(rng, (2, 30), max_wh=60.0)
    rois[:, :4, 1:] = gt[:, :4, :4] + rng.normal(0, 2, (2, 4, 4)).astype(np.float32)
    rois[0, 5, 1:] = [50.0, 40.0, 10.0, 5.0]            # inverted: nan/inf targets
    kw = dict(fg_thresh=0.5, num_reg_classes=num_reg_classes, bbox_weights=(1.0, 1.0, 2.0, 2.0))
    want = jax.jit(jax.vmap(lambda r, g, v: jax_proposal_target(r, g, v, **kw)))(rois, gt, gv)
    got = proposal_target(t(rois), t(gt), t(gv), **kw)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), err_msg=name, **TOL)
    assert np.isfinite(got["bbox_target"].numpy()).all()
    assert (got["label"].numpy() > 0).sum() >= 6
    assert (got["label"].numpy() == -1).sum() == (~gv).sum()


def test_sample_rois_fixed_matches_jax():
    rng = np.random.default_rng(3)
    gt, gv = gt_batch(rng, [5, 3])
    rois = np.zeros((2, 40, 5), np.float32)
    rois[..., 1:] = random_boxes(rng, (2, 40), max_wh=60.0)
    rois[:, :6, 1:] = np.repeat(gt[:, :3, :4], 2, axis=1) + 1.0
    tgt = jax.jit(jax.vmap(lambda r, g, v: jax_proposal_target(r, g, v, num_reg_classes=5)))(
        rois, gt, gv)
    keys = jax.random.split(jax.random.PRNGKey(4), 2)
    kw = dict(batch_rois=16, fg_fraction=0.25, bg_thresh_hi=0.5, bg_thresh_lo=0.1)
    want = jax.jit(jax.vmap(lambda tg, key: jax_sample_rois_fixed(tg, key, **kw)))(tgt, keys)
    n = rois.shape[1] + gt.shape[1]
    u = [[np.asarray(jax.random.uniform(sk, (n,))) for sk in jax.random.split(key, 3)]
         for key in keys]
    got = sample_rois_fixed({k: t(v) for k, v in tgt.items()},
                            *(t([x[j] for x in u]) for j in range(3)), **kw)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), err_msg=name, **TOL)
    assert ((got["label"].numpy() > 0).sum(-1) == 4).all()


@pytest.mark.parametrize("eligible", [30, 5])
def test_ohem_select_matches_jax(eligible):
    """The top roi_per_img eligible rois by loss, ties by index; with fewer
    eligible rois than the quota, only those."""
    rng = np.random.default_rng(4)
    b, n, c = 2, 30, 5
    logits = rng.normal(0, 2, (b, n, c)).astype(np.float32)
    logits[:, 10:14] = logits[:, 9:10]                  # tied losses
    deltas = rng.normal(0, 1, (b, n, 8)).astype(np.float32)
    labels = rng.integers(-1, c, (b, n)).astype(np.float32)
    labels[:, 9:14] = 2.0
    targets = rng.normal(0, 1, (b, n, 8)).astype(np.float32)
    weights = (rng.uniform(size=(b, n, 8)) < 0.5).astype(np.float32)
    valid = np.arange(n)[None].repeat(b, 0) < eligible
    want = jax.vmap(lambda *a: jax_ohem_select(*a, roi_per_img=8))(
        logits, deltas, labels, targets, weights, valid)
    got = ohem_select(t(logits), t(deltas), t(labels), t(targets), t(weights), t(valid),
                      roi_per_img=8)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    kept = (got[0].numpy() >= 0).sum(-1)
    assert (kept == np.minimum(8, ((labels >= 0) & valid).sum(-1))).all()


@pytest.mark.parametrize("normalized", [True, False])
def test_losses_match_jax(normalized):
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, 200).astype(np.float32)
    for sigma in (1.0, 3.0):
        np.testing.assert_allclose(losses.smooth_l1(t(x), sigma).numpy(),
                                   np.asarray(jlosses.smooth_l1(x, sigma)), **TOL)
    a = 9
    cls = rng.normal(0, 1, (2, FH, FW, 2 * a)).astype(np.float32)
    lab = rng.integers(-1, 2, (2, FH, FW, a)).astype(np.float32)
    bbox, tgt = (rng.normal(0, 1, (2, FH, FW, 4 * a)).astype(np.float32) for _ in range(2))
    wgt = (rng.uniform(size=(2, FH, FW, 4 * a)) < 0.3).astype(np.float32)
    got = losses.rpn_losses(t(cls), t(bbox), t(lab), t(tgt), t(wgt), a, 64, normalized)
    want = jlosses.rpn_losses(cls, bbox, lab, tgt, wgt, a, 64, normalized)
    np.testing.assert_allclose([float(g) for g in got], [float(w) for w in want], **TOL)
    logits = rng.normal(0, 1, (2, 20, 5)).astype(np.float32)
    labels = rng.integers(-1, 5, (2, 20)).astype(np.float32)
    d8, t8 = (rng.normal(0, 1, (2, 20, 8)).astype(np.float32) for _ in range(2))
    w8 = (rng.uniform(size=(2, 20, 8)) < 0.3).astype(np.float32)
    got = losses.rcnn_losses(t(logits), t(d8), t(labels), t(t8), t(w8), 16)
    want = jlosses.rcnn_losses(logits, d8, labels, t8, w8, 16)
    np.testing.assert_allclose([float(g) for g in got], [float(w) for w in want], **TOL)
    g = losses.softmax_ce_ignore(t(logits), t(labels))
    w = jlosses.softmax_ce_ignore(logits, labels)
    for x, y in zip(g, w):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), **TOL)


def test_metrics_match_jax():
    rng = np.random.default_rng(6)
    cls = rng.normal(0, 1, (2, FH, FW, 18)).astype(np.float32)
    lab = rng.integers(-1, 2, (2, FH, FW, 9)).astype(np.float32)
    d, tg = (rng.normal(0, 1, (2, 20, 8)).astype(np.float32) for _ in range(2))
    w = (rng.uniform(size=(2, 20, 8)) < 0.3).astype(np.float32)
    logits = rng.normal(0, 1, (2, 20, 5)).astype(np.float32)
    labels = rng.integers(-1, 5, (2, 20)).astype(np.float32)
    pairs = [
        (metrics.rpn_acc(t(cls), t(lab), 9), jmetrics.rpn_acc(cls, lab, 9)),
        (metrics.rpn_log_loss(t(cls), t(lab), 9), jmetrics.rpn_log_loss(cls, lab, 9)),
        (metrics.rpn_l1_loss(t(d), t(tg), t(w), 64), jmetrics.rpn_l1_loss(d, tg, w, 64)),
        (metrics.rcnn_acc(t(logits), t(labels)), jmetrics.rcnn_acc(logits, labels)),
        (metrics.rcnn_log_loss(t(logits), t(labels)), jmetrics.rcnn_log_loss(logits, labels)),
        (metrics.rcnn_l1_loss(t(d), t(tg), t(w), 16), jmetrics.rcnn_l1_loss(d, tg, w, 16)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), **TOL)
    ours, theirs = metrics.MetricAverager(), jmetrics.MetricAverager()
    for step in range(3):
        m = {"a": torch.tensor(float(step)), "b": torch.tensor(2.0 * step)}
        ours.update(m)
        theirs.update({k: float(v) for k, v in m.items()})
    assert ours.get() == theirs.get() == {"a": 1.0, "b": 2.0}
    ours.reset()
    assert ours.get() == {}


@pytest.mark.parametrize("kw", [
    dict(base_lr=0.1, steps=[10, 20], factor=0.1, warmup=True, warmup_lr=0.01, warmup_step=5),
    dict(base_lr=2.5e-4, steps=[4, 4, 9], factor=0.5),
])
def test_warmup_multifactor_matches_jax(kw):
    ours, theirs = warmup_multifactor(**kw), jax_warmup_multifactor(**kw)
    for count in (0, 1, 3, 4, 5, 9, 10, 19, 20, 25):
        np.testing.assert_allclose(ours(count), float(theirs(count)), rtol=1e-6)


@pytest.fixture(scope="module")
def tiny():
    """The tiny LSFA (ResNet-18 with DCN, feat 64, 5 classes, float32) with
    the port's seeded init, its flax variables, and the JAX module."""
    overrides = {"network": {"add_dcn": True}, "dataset": {"NUM_CLASSES": 5}}
    jm = jax_lsfa_from_config(jax_load_config(CONFIG, overrides=overrides))
    tm = lsfa_from_config(load_config(CONFIG, overrides=overrides), device="cpu")
    init_params(tm, torch.Generator().manual_seed(0))
    v = perturb(torch_to_flax(tm.state_dict(), flax_shapes(jm)), 3)
    tm.load_state_dict(flax_to_torch(v), strict=True)
    return jm, v, tm


def test_freeze_policy_matches_jax(tiny):
    """The port's frozen names are the convert.py image of the leaves JAX's
    freeze_mask marks untrainable; make_optimizer freezes them and decays
    only tensors of more than one dimension."""
    jm, v, tm = tiny
    mask = flatten_dict(freeze_mask(v["params"]))
    frozen = {p: v for p, v in flatten_dict(v["params"]).items() if not mask[p]}
    want = set(flax_to_torch({"params": unflatten_dict(frozen)}))
    assert want == frozen_names(tm)
    assert "backbone.bn_data.bias" in want and "small_net_backbone.bn0.weight" in want
    assert "small_net_backbone.conv0.weight" not in want
    opt, sched = make_optimizer(tm, 0.01, [10])
    decay, no_decay = opt.param_groups
    names = {id(p): n for n, p in tm.named_parameters()}
    assert decay["weight_decay"] == 5e-4 and no_decay["weight_decay"] == 0.0
    assert all(p.ndim > 1 for p in decay["params"]) and all(p.ndim == 1 for p in no_decay["params"])
    assert {names[id(p)] for g in opt.param_groups for p in g["params"]} == (
        set(names.values()) - want)
    assert all(p.requires_grad == (n not in want) for n, p in tm.named_parameters())
    for p in tm.parameters():
        p.requires_grad_(True)


def test_sgd_steps_match_optax(tiny):
    """Two SGD steps with momentum, weight decay on tensors of ndim > 1,
    the frozen parameters untouched and a schedule boundary after the
    first step: torch's SGD against the JAX package's optax chain."""
    jm, v, tm = tiny
    params = jax.tree.map(jnp.asarray, v["params"])
    rng = np.random.default_rng(7)
    grads = [jax.tree.map(lambda x: jnp.asarray(rng.normal(0, 1, x.shape).astype(np.float32)),
                          params) for _ in range(2)]
    jopt = jax_make_optimizer(params, base_lr=0.01, lr_steps=[1], lr_factor=0.5)
    @jax.jit
    def update(g, state, params):
        upd, state = jopt.update(g, state, params)
        return optax.apply_updates(params, upd), state

    state = jax.jit(jopt.init)(params)
    for g in grads:
        params, state = update(g, state, params)
    want = flax_to_torch({"params": jax.tree.map(np.asarray, params)})

    model = lsfa_from_config(load_config(CONFIG, overrides={
        "network": {"add_dcn": True}, "dataset": {"NUM_CLASSES": 5}}), device="cpu")
    model.load_state_dict(tm.state_dict())
    opt, sched = make_optimizer(model, 0.01, [1], lr_factor=0.5)
    for g in grads:
        tg = flax_to_torch({"params": jax.tree.map(np.asarray, g)})
        for n, p in model.named_parameters():
            p.grad = tg[n] if p.requires_grad else None
        opt.step()
        sched.step()
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=n)


@pytest.mark.parametrize("lt", [True, False])
def test_forward_train_matches_jax(tiny, lt):
    """forward_train on converted weights: one key pair, one pair through
    the long-term aggregation, one whose old reference is the reference."""
    jm, v, tm = tiny
    if not lt:
        ov = {"network": {"add_dcn": True, "add_lt_aggregation": False},
              "dataset": {"NUM_CLASSES": 5}}
        jm = jax_lsfa_from_config(jax_load_config(CONFIG, overrides=ov))
        keep = {k: x for k, x in v["params"].items() if k not in ("flownet", "nq_net")}
        v = {"params": keep, "batch_stats": v["batch_stats"]}
        tm = lsfa_from_config(load_config(CONFIG, overrides=ov), device="cpu")
        tm.load_state_dict(flax_to_torch(v), strict=True)
    rng = np.random.default_rng(8)
    samples = [synthetic_sample(rng, (60, 90), 5, 2, eq, eq_old)
               for eq, eq_old in ((1.0, 0.0), (0.0, 0.0), (0.0, 1.0))]
    batch = collate_train_batch(samples, (H, W), max_gt=4)
    args = [batch[k] for k in ("data", "data_ref", "data_ref_old", "eq_flag", "eq_flag_old",
                               "motion_vector", "res_diff")]
    want = jax.jit(lambda *a: jm.apply(v, *a, method=jm.forward_train))(*args)
    got = tm.forward_train(*(t(a) for a in args))
    assert sorted(got) == sorted(want)
    for name in want:
        w = np.asarray(want[name])
        np.testing.assert_allclose(got[name].detach().numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


def test_forward_train_refuses_train_mode_bn():
    """forward_train refuses none of the train-mode BatchNorm variants: in
    training mode a forward moves the running statistics of exactly the
    variant's BatchNorms; in eval mode it moves none."""
    rng = np.random.default_rng(4)
    batch = collate_train_batch([synthetic_sample(rng, (60, 90), 5, 2, 0.0, 0.0)], (H, W))
    args = [t(batch[k]) for k in ("data", "data_ref", "data_ref_old", "eq_flag",
                                  "eq_flag_old", "motion_vector", "res_diff")]
    for ov, moving in (({"res_diff_bn": True}, {"rnet.bn"}),
                       ({"small_net_bn_before_fuse": True},
                        {"small_fuse.cur_feat_bn", "small_fuse.warp_conv_feat_bn"})):
        tm = lsfa_from_config(load_config(CONFIG, overrides={"network": ov}), device="cpu")
        init_params(tm, torch.Generator().manual_seed(0))
        for train in (False, True):
            before = {k: x.clone() for k, x in tm.state_dict().items()}
            tm.train(train)
            out = tm.forward_train(*args)
            assert all(bool(torch.isfinite(x).all()) for x in out.values())
            moved = {k.rsplit(".", 1)[0] for k, x in tm.state_dict().items()
                     if not torch.equal(x, before[k])}
            assert moved == (moving if train else set()), (ov, train, moved)


def test_seed_small_net_and_combine_match_jax(tiny):
    jm, v, tm = tiny
    want = flax_to_torch({"params": jckpt.seed_small_net(v["params"]),
                          "batch_stats": v["batch_stats"]})
    got = checkpoint.seed_small_net(tm.state_dict())
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    assert torch.equal(got["small_net_backbone.conv0.weight"], got["backbone.conv0.weight"])
    assert not torch.equal(got["small_net_backbone.bn0.running_mean"],
                           got["backbone.bn0.running_mean"])

    src = {"flownet": {k: np.full(x.shape, 0.5, np.float32) for k, x in
                       flatten_dict(v["params"]["flownet"], sep="/").items()}}
    src["flownet"]["not_a_layer/kernel"] = np.zeros(3, np.float32)
    jsrc = {"flownet": unflatten_dict(src["flownet"], sep="/")}
    merged, n_j = jckpt.combine_checkpoints(v["params"], jsrc)
    tsrc = {k: v_ for k, v_ in flax_to_torch({"params": jsrc}).items()}
    ours, n_t = checkpoint.combine_checkpoints(
        tm.state_dict(), {"flownet": {k.split(".", 1)[1]: x for k, x in tsrc.items()}})
    assert n_t == n_j == len(src["flownet"]) - 1
    want = flax_to_torch({"params": merged})
    for k in want:
        np.testing.assert_array_equal(ours[k].numpy(), want[k].numpy(), err_msg=k)


def test_checkpoint_round_trip(tmp_path, tiny):
    _, _, tm = tiny
    path = str(tmp_path / "ck")
    assert checkpoint.latest_step(path) is None
    opt, sched = make_optimizer(tm, 0.01, [5])
    for epoch in (1, 3, 2):
        checkpoint.save_checkpoint(path, epoch, tm, opt, sched, step=7 * epoch,
                                   rng_state=torch.Generator().manual_seed(epoch).get_state())
    assert checkpoint.latest_step(path) == 3
    state, epoch = checkpoint.load_checkpoint(path)
    assert epoch == 3 and state["epoch"] == 3 and state["step"] == 21
    assert torch.equal(state["rng_state"], torch.Generator().manual_seed(3).get_state())
    for k, x in tm.state_dict().items():
        assert torch.equal(state["model"][k], x), k
    assert checkpoint.load_checkpoint(path, 1)[0]["step"] == 7
    for p in tm.parameters():
        p.requires_grad_(True)


def test_collate_matches_jax():
    rng = np.random.default_rng(9)
    samples = [synthetic_sample(rng, hw, 31, n, eq, 0.0)
               for hw, n, eq in (((60, 90), 3, 1.0), ((48, 80), 12, 0.0))]
    for s in samples:                    # the JAX loader ships float32 frames
        for k in ("data", "data_ref", "data_ref_old"):
            s[k] = s[k].astype(np.float32)
    want = jax_collate(samples, (H, W), max_gt=10, mv_res_dtype=np.float32)
    got = collate_train_batch(samples, (H, W), max_gt=10)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    batches = synthetic_train_batches(4, (H, W), seed=1, max_gt=10)
    assert [float(b["eq_flag"][0]) for b in batches] == [1.0, 0.0, 0.0, 0.0]
    assert all(b["data"].dtype == np.uint8 and b["motion_vector"].dtype == np.float32
               and 1 <= b["gt_valid"].sum() <= 10 for b in batches)


def test_constructors_default_to_the_card():
    """lsfa_from_config and init_model build on the card when no device is
    given; without a card they raise instead of carrying on on the CPU."""
    cfg = load_config(CONFIG)
    if not torch.cuda.is_available():
        for build in (lsfa_from_config, init_model):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                build(cfg)
        return
    for model in (lsfa_from_config(cfg), init_model(cfg)):
        assert {p.device.type for p in model.parameters()} == {"cuda"}
