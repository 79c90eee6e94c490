"""The port's entry hooks (``lsfa_tpu_torch/entry.py``) against
``__graft_entry__.py``.

- `key_step` over `_flagship(small=True)` (ResNet-18, feat 64, no DCN,
  float32) on the CPU: its outputs equal the model's own forward_key bit
  for bit, and JAX's forward_key at 64x96 from the same weights
  (flax_to_torch of the port's seeded init, perturbed as in
  test_torch_convert) within the tolerance of test_torch_variants (1e-4
  relative; absolute 1e-4, or 1e-5 of the map's largest |value|).
- `dryrun_multichip(2)`: the train step over two gloo ranks equal to the
  single process's; the evaluation sharded by video, together equal to
  the single process's; and the lanes of one lane-batched detector split
  over the ranks (4 lanes, 2 carried by each rank, the counterpart of
  JAX's lane-sharded StreamingDetector), every frame filed once and the
  merged mapping within the lanes' tolerance of the single process's
  4-lane run (the hook itself holds each rank bit for bit against its
  block run in one process).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import __graft_entry__ as jax_entry
from lsfa_tpu_torch import entry
from lsfa_tpu_torch.convert import flax_to_torch
from tests.test_torch_convert import perturb
from tests.test_torch_train import flax_shapes, torch_to_flax
from tests.test_torch_variants import map_atol
from tests.test_torch_convert import two_torch_threads  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("two_torch_threads")

H, W = 64, 96


def test_key_step_matches_jax_forward_key():
    _, jm = jax_entry._flagship(small=True)
    cfg, model = entry._flagship(small=True, device="cpu")
    assert (cfg.network.num_layer, cfg.network.DFF_FEAT_DIM, cfg.network.add_dcn,
            cfg.tpu.compute_dtype) == (18, 64, False, "float32")
    v = perturb(torch_to_flax(model.state_dict(), flax_shapes(jm, H, W)), 1)
    model.load_state_dict(flax_to_torch(v), strict=True)
    fn = entry.key_step(model)

    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, (1, H, W, 3)).astype(np.float32)
    prev = rng.normal(0, 60, (1, H, W, 3)).astype(np.float32)
    feat = rng.normal(0, 1, (1, H // 16, W // 16, 64)).astype(np.float32)
    for first in (0.0, 1.0):
        is_first = np.full((1,), first, np.float32)
        args = [torch.from_numpy(a) for a in (data, prev, feat, is_first)]
        params = {**dict(model.named_parameters()), **dict(model.named_buffers())}
        got = fn(params, *args)
        with torch.no_grad():
            own = model.forward_key(*args)
        assert sorted(got) == sorted(own)
        assert all(torch.equal(got[k], own[k]) for k in own)
        want = jax.jit(functools.partial(jm.apply, method=jm.forward_key))(
            v, data, prev, feat, jnp.asarray(is_first))
        assert sorted(got) == sorted(want)
        for k in want:
            w = np.asarray(want[k], np.float32)
            np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-4, atol=map_atol(w),
                                       err_msg=f"{k} is_first={first}")


def test_key_step_takes_the_weights_as_an_argument():
    """The same callable under other weights gives that model's outputs."""
    _, model = entry._flagship(small=True, device="cpu")
    _, other = entry._flagship(small=True, device="cpu")
    with torch.no_grad():
        for p in other.parameters():
            p.mul_(1.5)
    fn = entry.key_step(model)
    rng = np.random.default_rng(1)
    args = [torch.from_numpy(rng.integers(0, 256, (1, H, W, 3)).astype(np.float32))] * 2 + [
        torch.zeros((1, H // 16, W // 16, 64)), torch.ones((1,))]
    got = fn({**dict(other.named_parameters()), **dict(other.named_buffers())}, *args)
    with torch.no_grad():
        want = other.eval().forward_key(*args)
        mine = model.forward_key(*args)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert not torch.equal(got["rpn_fg"], mine["rpn_fg"])


def test_dryrun_multichip_ranks_agree():
    report = entry.dryrun_multichip(2)
    assert report["ok"] and report["n_processes"] == 2 and report["ranks_identical"]
    assert report["eval_equal"] and sum(report["eval_frames_by_rank"]) == report["eval_frames"]
    assert report["eval_frames"] == sum(entry.EVAL_LENGTHS) and report["eval_detections"] > 0
    assert report["eval_lanes_equal"] and report["eval_lanes"] == 4
    assert report["eval_lanes_by_rank"] == [2, 2]
    assert sum(report["eval_lane_frames_by_rank"]) == sum(entry.EVAL_LENGTHS)
    assert report["eval_lanes_max_score_diff"] <= 1e-5 and report["eval_lanes_max_box_diff"] <= 1e-5
