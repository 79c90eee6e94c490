"""``tpu.param_dtype`` below float32 in the port, against the JAX package:
after ``init_model`` the floating parameters are stored in bfloat16 and
the BatchNorm statistics stay float32, bit for bit what JAX's
``init_model`` makes of the same variables (its cast after the small-net
seeding); a forward from those bfloat16 parameters matches JAX's; a train
step keeps them bfloat16.

Both packages start from the same seeded float32 variables (the port's
init, carried into the flax tree and perturbed as in test_torch_convert),
put in place of each package's random init. The tiny config computes in
float32, and both upcast a bfloat16 parameter to float32 exactly, so
forward_key is held at the float32 tolerance of test_torch_variants
(1e-4 relative; absolute 1e-4, or 1e-5 of the map's largest |value|).
"""

import functools
import os
from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lsfa_tpu.config import load_config as jax_load_config
from lsfa_tpu.models.lsfa import lsfa_from_config as jax_lsfa_from_config
from lsfa_tpu.train import driver as jax_driver
from lsfa_tpu_torch.config import load_config
from lsfa_tpu_torch.convert import flax_to_torch
from lsfa_tpu_torch.models.lsfa import init_params, lsfa_from_config
from lsfa_tpu_torch.train import driver
from tests.test_torch_convert import perturb
from tests.test_torch_train import flax_shapes, torch_to_flax
from tests.test_torch_variants import map_atol
from tests.test_torch_convert import two_torch_threads  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("two_torch_threads")

ROOT = os.path.join(os.path.dirname(__file__), "..")
YAML = os.path.join(ROOT, "configs", "lsfa_tiny_smoke.yaml")
CONFIG = os.path.join(ROOT, "lsfa_tpu_torch", "configs", "lsfa_tiny_smoke.json")
BF16 = {"tpu": {"param_dtype": "bfloat16"}}


class _SeededInit:
    """A flax model whose init gives the seeded variables."""

    def __init__(self, model, variables):
        self.model, self.variables = model, variables

    def init(self, *args):
        return jax.tree.map(jnp.asarray, self.variables)


@pytest.fixture(scope="module")
def both():
    """(JAX's flax module, JAX's init_model variables as numpy float32,
    the port's init_model model), both from the same seeded variables."""
    jcfg = jax_load_config(YAML, overrides=BF16)
    jm = jax_lsfa_from_config(jcfg)
    tm = lsfa_from_config(load_config(CONFIG), device="cpu")
    init_params(tm, torch.Generator().manual_seed(3))
    h, w = jcfg.tpu.default_bucket
    v = perturb(torch_to_flax(tm.state_dict(), flax_shapes(jm, h, w)), 1)
    with mock.patch.object(jax_driver, "lsfa_from_config", lambda c: _SeededInit(jm, v)):
        _, params, stats = jax_driver.init_model(jcfg)
    assert {jnp.dtype(x.dtype) for x in jax.tree.leaves(params)} == {jnp.dtype(jnp.bfloat16)}
    as_f32 = jax.tree.map(lambda x: np.asarray(x, np.float32), {"params": params,
                                                               "batch_stats": stats})

    def seeded(model, generator):
        model.load_state_dict(flax_to_torch(v), strict=True)

    with mock.patch.object(driver, "init_params", seeded):
        model = driver.init_model(load_config(CONFIG, overrides=BF16), device="cpu")
    return jm, as_f32, model


def test_init_model_casts_as_jax(both):
    _, want, model = both
    want = flax_to_torch(want)
    params = {n for n, _ in model.named_parameters()}
    state = model.state_dict()
    assert set(state) == set(want)
    for k, t in state.items():
        assert t.dtype == (torch.bfloat16 if k in params else torch.float32), k
        assert torch.equal(t.float(), want[k]), k
    assert any(k.endswith("running_var") for k in state)


def test_forward_key_from_bf16_parameters_matches_jax(both):
    jm, want_vars, model = both
    bf16 = {"params": jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), want_vars["params"]),
            "batch_stats": want_vars["batch_stats"]}
    h, w = 64, 112
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, (1, h, w, 3)).astype(np.float32)
    prev = rng.normal(0, 60, (1, h, w, 3)).astype(np.float32)
    feat = rng.normal(0, 1, (1, h // 16, w // 16, 64)).astype(np.float32)
    want = jax.jit(functools.partial(jm.apply, method=jm.forward_key))(
        bf16, data, prev, feat, jnp.zeros((1,)))
    with torch.no_grad():
        got = model.eval().forward_key(*(torch.from_numpy(a) for a in (data, prev, feat)),
                                       torch.zeros(1))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].float().numpy(), np.asarray(want[k], np.float32),
                                   rtol=1e-4, atol=map_atol(np.asarray(want[k], np.float32)),
                                   err_msg=k)


def test_a_train_step_keeps_the_parameters_bf16():
    from lsfa_tpu_torch.data.loader import synthetic_train_batches

    cfg = load_config(CONFIG, overrides=dict(BF16, TRAIN={"RPN_POST_NMS_TOP_N": 32,
                                                          "BATCH_ROIS_OHEM": 16}))
    model = driver.init_model(cfg, device="cpu")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    metrics = []
    batches = synthetic_train_batches(1, (64, 112), seed=2, max_gt=8, content_hw=(60, 100))
    cfg.tpu.max_gt_boxes = 8
    driver.train_net(cfg, batches=batches, model=model, max_steps=1,
                     metrics_hook=lambda s, m: metrics.append({k: float(v) for k, v in m.items()}))
    assert len(metrics) == 1 and all(np.isfinite(v) for v in metrics[0].values())
    moved = 0
    for n, p in model.named_parameters():
        assert p.dtype == torch.bfloat16, n
        moved += not torch.equal(p, before[n])
    assert moved > 0
    assert all(b.dtype == torch.float32 for b in model.buffers() if b.is_floating_point())


def test_param_dtype_names():
    cfg = load_config(CONFIG)
    assert driver.param_dtype(cfg) is torch.float32
    for name, dt in (("bfloat16", torch.bfloat16), ("float16", torch.float16)):
        cfg.tpu.param_dtype = name
        assert driver.param_dtype(cfg) is dt
    for name in ("int8", "nonsense"):
        cfg.tpu.param_dtype = name
        with pytest.raises(ValueError, match="param_dtype"):
            driver.param_dtype(cfg)
