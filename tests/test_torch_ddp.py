"""Data parallelism (``lsfa_tpu_torch/parallel/mesh.py`` and the train
step's global-batch semantics) on the CPU.

Two gloo processes (``lsfa_tpu_torch.tools.dryrun_multihost``), each
holding one image of a global batch of 2, take 2 steps of ``train_net`` on
the tiny LSFA: the metrics and parameters are identical across the ranks
and equal the single-process step on the batch of 2 within 1e-5 relative
(``tests/test_torch_train_step.py`` holds that step against JAX's), and so
does the train-mode BatchNorm variant (``res_diff_bn``,
``small_net_bn_before_fuse``) over 2 and 4 ranks, its batch statistics the
global batch's through a differentiable all-reduce, running statistics
included (``tests/test_torch_train_bn.py`` holds its single-process step
against JAX's). Without a process group every helper is the identity.
"""

import numpy as np
import pytest
import torch

from lsfa_tpu_torch.config import load_config
from lsfa_tpu_torch.models import layers
from lsfa_tpu_torch.parallel import mesh
from lsfa_tpu_torch.tools import dryrun_multihost
from lsfa_tpu_torch.train.train_step import TrainSettings, draw_uniforms
from tests.test_torch_convert import two_torch_threads  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("two_torch_threads")


def test_two_gloo_ranks_equal_the_single_process_step():
    report, ranks, single = dryrun_multihost.run()
    assert report["ok"], report
    assert report["ranks_identical"] and len(ranks) == 2
    assert [r["world_size"] for r in ranks] == [2, 2]
    assert report["max_rel_err_losses"] <= 1e-5 and report["max_rel_err_params"] <= 1e-5
    # the steps moved the model and the losses are the global batch's
    steps = single["plain"][0]
    assert len(steps) == 2 and steps[1]["total_loss"] != steps[0]["total_loss"]
    first = ranks[0]["steps"]["plain"]
    for k in steps[0]:
        assert np.isclose(first[0][k], steps[0][k], rtol=1e-5, atol=0), k
    assert_bn_variant_equal(report, ranks, single)


def assert_bn_variant_equal(report, ranks, single):
    """The BN variant's ranks give the single process's metrics and
    parameters, and its running statistics moved by the global batch."""
    assert report["ranks_identical_bn"]
    assert report["max_rel_err_losses_bn"] <= 1e-5 and report["max_rel_err_params_bn"] <= 1e-5
    state = ranks[0]["state"]["bn"]
    stats = [k for k in state if k.startswith(("rnet.bn.", "small_fuse.cur_feat_bn."))
             and k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 4
    for k in stats:
        torch.testing.assert_close(state[k], single["bn"][1][k], rtol=1e-5, atol=1e-6)
    assert not torch.equal(state["rnet.bn.running_mean"], torch.zeros_like(
        state["rnet.bn.running_mean"]))


def test_four_gloo_ranks_equal_the_single_process_bn_step():
    report, ranks, single = dryrun_multihost.run(4, names=("bn",))
    assert report["ok"], report
    assert [r["world_size"] for r in ranks] == [4] * 4
    assert_bn_variant_equal(report, ranks, single)


def test_helpers_are_identities_without_a_process_group():
    assert not mesh.active() and mesh.rank() == 0 and mesh.world_size() == 1
    t = torch.arange(4.0)
    assert mesh.sum_over_ranks(t) is t
    model = torch.nn.Linear(2, 2)
    model(torch.ones(1, 2)).sum().backward()
    grad = model.weight.grad.clone()
    mesh.all_reduce_gradients(model)
    mesh.broadcast_parameters(model)
    mesh.barrier()
    assert torch.equal(model.weight.grad, grad)
    batch = {"data": np.arange(8).reshape(4, 2), "eq_flag": np.arange(4)}
    assert {k: v.tolist() for k, v in mesh.shard_batch(batch, 1, 2).items()} == {
        "data": [[4, 5], [6, 7]], "eq_flag": [2, 3]}
    with pytest.raises(ValueError):
        mesh.shard_batch(batch, 0, 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            mesh.initialize_distributed()


def test_each_rank_draws_its_rows_of_the_global_draw():
    cfg = load_config(None)
    s = TrainSettings.from_config(cfg)
    batch = {"data": torch.zeros(1, 64, 112, 3), "gt_boxes": torch.zeros(1, 8, 5)}
    whole = draw_uniforms(s, {"data": torch.zeros(2, 64, 112, 3)},
                          torch.Generator().manual_seed(9))
    for r in range(2):
        part = draw_uniforms(s, batch, torch.Generator().manual_seed(9), rank=r, world=2)
        for k, v in whole.items():
            assert torch.equal(part[k], v[r:r + 1]), k


def test_train_mode_batchnorm_sums_its_moments_over_ranks(monkeypatch):
    """The BatchNorm reduces [sum x, sum x^2, count] through
    `sum_over_ranks_with_grad` once per call: with two identical ranks
    (the reduction doubles every entry) the output, the running statistics
    and the gradient equal one rank's; eval mode reduces nothing."""
    x = torch.randn(2, 4, 3, 3) * 3 + 1
    outs = {}
    for world in (1, 2):
        calls = []

        def reduce(t, world=world):
            calls.append(t.shape)
            return t * world

        monkeypatch.setattr(mesh, "sum_over_ranks_with_grad", reduce)
        bn = layers.BatchNorm(4).train()
        xi = x.clone().requires_grad_(True)
        y = bn(xi)
        (y * torch.arange(y.numel()).view_as(y)).sum().backward()
        assert calls == [(9,)]
        bn.eval()(x)
        assert len(calls) == 1
        outs[world] = (y.detach(), bn.running_mean, bn.running_var, xi.grad)
    for a, b in zip(outs[1], outs[2]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
