"""`init_model`'s warm starts in the port, against the JAX package.

network.pretrained and pretrained_flow name the reference's MXNet
``.params`` files (the ImageNet ResNet and the FlyingChairs FlowNet of
train_end2end.py:107-115); here they are written from seeded arrays with
the names JAX's ``export_mxnet_lsfa`` gives the tiny config's backbone and
FlowNet (no pretrained file is in the repository). The port's init_model
imports exactly the tensors JAX's init_model imports from the same files
(JAX's random init replaced by zeros of its shapes, which the imported
tensors do not depend on), and both seed the small net from the warm
backbone. The prefix form
(``<prefix>-<pretrained_epoch:04d>.params``), a missing file (logged and
skipped), pretrained_flow as a checkpoint directory, and
pretrained_detector (the cases of tests/test_pretrained_detector.py, on
the port's own checkpoints) follow.
"""

import os
from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch import nn

from lsfa_tpu.config import load_config as jax_load_config
from lsfa_tpu.models.lsfa import lsfa_from_config as jax_lsfa_from_config
from lsfa_tpu.train import driver as jax_driver
from lsfa_tpu.train.import_mxnet import export_mxnet_lsfa as jax_export
from lsfa_tpu_torch.config import load_config
from lsfa_tpu_torch.convert import flax_to_torch
from lsfa_tpu_torch.train.checkpoint import save_checkpoint
from lsfa_tpu_torch.eval.rfcn_tester import rfcn_from_config
from lsfa_tpu_torch.models.lsfa import lsfa_from_config
from lsfa_tpu_torch.train.driver import SHARED_STACK, init_model, is_rfcn
from lsfa_tpu_torch.train.schedule import make_optimizer
from lsfa_tpu_torch.utils.mxnet_io import save_params
from tests.test_torch_convert import to_numpy

ROOT = os.path.join(os.path.dirname(__file__), "..")
YAML = os.path.join(ROOT, "configs", "lsfa_tiny_smoke.yaml")
CONFIG = os.path.join(ROOT, "lsfa_tpu_torch", "configs", "lsfa_tiny_smoke.json")
RFCN_CONFIG = os.path.join(ROOT, "lsfa_tpu_torch", "configs", "rfcn_tiny_smoke.json")


class Lines:
    """A logger that keeps its messages."""

    def __init__(self):
        self.lines = []

    def info(self, msg):
        self.lines.append(msg)

    warning = info


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    """(backbone .params, flownet .params, {state key: file tensor}): the
    tiny config's backbone and FlowNet at seeded values (abstract init,
    no compile), the backbone file with the ImageNet file's extras
    (bn_data_gamma, fc1_*) that nothing consumes."""
    cfg = jax_load_config(YAML)
    h, w = cfg.tpu.default_bucket
    d = jnp.zeros((1, h, w, 3))
    shapes = jax.eval_shape(jax_lsfa_from_config(cfg).init, jax.random.PRNGKey(0), d, d, d,
                            jnp.ones((1,)), jnp.ones((1,)), jnp.zeros((1, h // 16, w // 16, 2)),
                            jnp.zeros((1, h // 16, w // 16, 3)))
    rng = np.random.default_rng(5)
    seeded = jax.tree.map(lambda s: rng.uniform(0.5, 1.5, s.shape).astype(np.float32),
                          {"params": shapes["params"], "batch_stats": shapes["batch_stats"]})
    tmp = tmp_path_factory.mktemp("pretrained")
    paths, want = [], {}
    for top in ("backbone", "flownet"):
        part = {col: {top: seeded[col][top]} for col in seeded if top in seeded[col]}
        flat = jax_export(part)
        if top == "backbone":
            flat.update({"arg:bn_data_gamma": np.ones(3, np.float32),
                         "arg:fc1_weight": rng.standard_normal((10, 512)).astype(np.float32),
                         "arg:fc1_bias": np.zeros(10, np.float32)})
        paths.append(str(tmp / f"{top}-0000.params"))
        save_params(paths[-1], flat)
        want.update(flax_to_torch(part))
    return paths[0], paths[1], want


class _AbstractInit:
    """A flax model whose init gives zeros of its variables' shapes: JAX's
    init_model then runs its own import and small-net seeding without
    compiling the random init (the imported tensors do not depend on it)."""

    def __init__(self, model):
        self.model = model

    def init(self, *args):
        shapes = jax.eval_shape(self.model.init, *args)
        return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)


@pytest.fixture(scope="module")
def jax_warm(pretrained):
    """JAX's init_model with pretrained and pretrained_flow set, as a
    state dict."""
    cfg = jax_load_config(YAML)
    cfg.network.pretrained, cfg.network.pretrained_flow = pretrained[:2]
    with mock.patch.object(jax_driver, "lsfa_from_config",
                           lambda c: _AbstractInit(jax_lsfa_from_config(c))):
        _, params, bs = jax_driver.init_model(cfg)
    return flax_to_torch(to_numpy({"params": params, "batch_stats": bs}))


def _check_small_net_seeded(state):
    """Every small-net parameter with a backbone twin equals it."""
    keys = [k for k in state if k.startswith("small_net_backbone.")
            and not k.endswith(("running_mean", "running_var"))]
    assert keys
    for k in keys:
        assert torch.equal(state[k], state["backbone." + k[len("small_net_backbone."):]]), k


def test_pretrained_files_import_as_jax(pretrained, jax_warm):
    cfg = load_config(CONFIG)
    cfg.network.pretrained, cfg.network.pretrained_flow = pretrained[:2]
    log = Lines()
    state = init_model(cfg, device="cpu", logger=log).state_dict()
    want = pretrained[2]
    assert set(want) <= set(state)
    for k, v in want.items():
        assert torch.equal(state[k], v), k
        assert torch.equal(state[k], jax_warm[k]), k
    _check_small_net_seeded(state)
    for k in state:       # the small net's parameters (its statistics stay at init)
        if k.startswith("small_net_backbone.") and not k.endswith(("_mean", "_var")):
            assert torch.equal(state[k], jax_warm[k]), k
    n_bb = sum(k.startswith("backbone.") for k in want)
    assert log.lines == [
        f"imported {n_bb} tensors from {pretrained[0]} (3 unused)",
        f"imported {len(want) - n_bb} tensors from {pretrained[1]} (0 unused)"]


@pytest.fixture(scope="module")
def fresh():
    """The tiny LSFA's state with no warm start (its pretrained file is not
    there)."""
    return init_model(load_config(CONFIG), device="cpu").state_dict()


def test_pretrained_prefix_and_missing_file(pretrained, fresh):
    """pretrained as a prefix reads <prefix>-<pretrained_epoch:04d>.params;
    a file that is not there is logged and skipped."""
    cfg = load_config(CONFIG)
    cfg.network.pretrained = pretrained[0][:-len("-0000.params")]
    cfg.network.pretrained_flow = pretrained[1] + ".gone.params"
    log = Lines()
    state = init_model(cfg, device="cpu", logger=log).state_dict()
    for k, v in pretrained[2].items():
        assert torch.equal(state[k], v if k.startswith("backbone.") else fresh[k]), k
    assert log.lines[1] == f"pretrained file not found, skipping: {pretrained[1]}.gone.params"
    cfg.network.pretrained_epoch = 3
    log = Lines()
    init_model(cfg, device="cpu", logger=log)
    assert log.lines[0].endswith(f"{cfg.network.pretrained}-0003.params")


def _save_model_state(path, epoch, state, cfg_path):
    """A checkpoint of this package holding `state`."""
    cfg = load_config(cfg_path)
    model = (rfcn_from_config if is_rfcn(cfg) else lsfa_from_config)(cfg, device="cpu")
    model.load_state_dict(state)
    opt, sched = make_optimizer(model, 1e-3, [100])
    save_checkpoint(path, epoch, model, opt, sched, step=0,
                    rng_state=torch.Generator().manual_seed(0).get_state())


@pytest.fixture(scope="module")
def det_ckpt(tmp_path_factory):
    """A 'trained' R-FCN tiny checkpoint: its init with every float entry
    shifted by +1."""
    state = {k: v + 1.0 for k, v in init_model(load_config(RFCN_CONFIG),
                                                device="cpu").state_dict().items()}
    path = str(tmp_path_factory.mktemp("det") / "checkpoints")
    _save_model_state(path, 2, state, RFCN_CONFIG)
    return path, state


def test_warm_start_transfers_shared_stack(det_ckpt, fresh):
    path, det = det_ckpt
    cfg = load_config(CONFIG)
    cfg.network.pretrained_detector = path
    log = Lines()
    state = init_model(cfg, device="cpu", logger=log).state_dict()
    shared = [k for k in det if k.split(".")[0] in SHARED_STACK]
    assert len(shared) == len(det)
    for k in shared:
        assert torch.equal(state[k], det[k]), k
    # the aggregation modules stay at their init
    for k in state:
        if k.startswith(("flownet.", "nq_net.", "rnet.", "small_fuse.")):
            assert torch.equal(state[k], fresh[k]), k
    # the small net is seeded from the warm backbone
    _check_small_net_seeded(state)
    assert torch.equal(state["small_net_backbone.stage1_unit1.conv1.weight"],
                       det["backbone.stage1_unit1.conv1.weight"])
    n_stats = sum(k.endswith(("running_mean", "running_var")) for k in det)
    assert log.lines[-1] == (f"warm-started {len(det) - n_stats} param + {n_stats} batch-stat "
                             f"tensors from detector checkpoint {path} (epoch 2)")


def test_warm_start_missing_overlap_raises(tmp_path):
    """A checkpoint sharing nothing with the model fails loudly."""
    path = str(tmp_path / "bogus")
    model = nn.Module()
    model.not_a_module = nn.Linear(2, 2)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    save_checkpoint(path, 1, model, opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda c: 1.0),
                    step=0, rng_state=torch.Generator().get_state())
    cfg = load_config(CONFIG)
    cfg.network.pretrained_detector = path
    with pytest.raises(ValueError, match="shares no parameter"):
        init_model(cfg, device="cpu")


def test_pretrained_flow_from_a_checkpoint_dir(det_ckpt, fresh, tmp_path):
    """pretrained_flow naming a checkpoint directory merges its flownet;
    a directory without one (the R-FCN's) raises."""
    state = {k: v + 2.0 for k, v in fresh.items()}
    path = str(tmp_path / "flow")
    _save_model_state(path, 1, state, CONFIG)
    cfg = load_config(CONFIG)
    cfg.network.pretrained_flow = path
    got = init_model(cfg, device="cpu").state_dict()
    flow = [k for k in state if k.startswith("flownet.")]
    assert flow
    for k in got:
        assert torch.equal(got[k], state[k]) == (k in flow), k
    cfg.network.pretrained_flow = det_ckpt[0]
    with pytest.raises(ValueError, match="has no 'flownet' entries"):
        init_model(cfg, device="cpu")
