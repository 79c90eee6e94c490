"""Tensor parallelism of the head stack (``lsfa_tpu_torch/parallel/
tensor_parallel.py``) on the CPU, against the port's replicated run and
the JAX package's tensor parallelism.

The tiny LSFA of ``tests/test_tensor_parallel.py`` (ResNet-18, feat 64, no
DCN, 5 classes, float32, 64x96) from ``dryrun_multihost.tiny_tp_job``.
One spawn of 4 gloo ranks (``dryrun_multihost.run_tp``) shards it over
the meshes (1, 4) and (2, 2): forward_key (is_first 0 and 1), forward_cur
over a batch of 2 split on "data" and the gradients of a seeded functional
of forward_key's maps equal the replicated run's within 1e-5 of each
one's largest |value| (float32, sums reassociated over the ranks), and
JAX's forward_key and forward_cur under its ``make_tp_mesh(4)`` and
``shard_params`` on 8 virtual CPU devices, from the same weights, within
``test_torch_variants.map_atol`` and rtol 1e-4. A spawn of 2 ranks streams
2 GOPs through StreamingDetector at (1, 2): the replicated detector's
detections (labels and valid rows equal, scores 1e-5, boxes
``test_torch_slice.BOX_REL``).
"""

import os
import socket
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from lsfa_tpu.config import load_config as jax_load_config
from lsfa_tpu.eval.rfcn_tester import rfcn_from_config as jax_rfcn_from_config
from lsfa_tpu.models.lsfa import lsfa_from_config as jax_lsfa_from_config
from lsfa_tpu.parallel import make_tp_mesh as jax_make_tp_mesh
from lsfa_tpu.parallel import shard_params as jax_shard_params
from lsfa_tpu.parallel import tensor_parallel_specs as jax_tensor_parallel_specs
from lsfa_tpu_torch.config import load_config
from lsfa_tpu_torch.convert import flax_to_torch
from lsfa_tpu_torch.eval.rfcn_tester import rfcn_from_config
from lsfa_tpu_torch.models.lsfa import lsfa_from_config
from lsfa_tpu_torch.parallel import make_tp_mesh, shard_params, tensor_parallel_specs
from lsfa_tpu_torch.parallel.tensor_parallel import (ColumnParallelConv, RowParallelConv,
                                                     TP_IN_MODULES, TP_OUT_MODULES)
from lsfa_tpu_torch.tools import dryrun_multihost as dry
from lsfa_tpu_torch.train.checkpoint import save_checkpoint
from tests.test_torch_convert import two_torch_threads  # noqa: F401  (a fixture)
from tests.test_torch_slice import assert_boxes_close
from tests.test_torch_train import flax_shapes, torch_to_flax
from tests.test_torch_variants import map_atol

pytestmark = pytest.mark.usefixtures("two_torch_threads")

H, W = dry.TP_HW
ROOT = os.path.join(os.path.dirname(__file__), "..")
JAX_CONFIG = os.path.join(ROOT, "configs", "lsfa_tiny_smoke.yaml")
TORCH_CONFIG = os.path.join(ROOT, "lsfa_tpu_torch", "configs", "lsfa_tiny_smoke.json")


@pytest.fixture(scope="module")
def tp4():
    """(job, the 4 ranks' outputs over (1, 4) and (2, 2), the replicated
    run's)."""
    job = dry.tiny_tp_job(((1, 4), (2, 2)))
    return job, dry.run_tp(job, 4), dry.tp_reference(job)["float32"]


@pytest.fixture
def one_rank_group():
    """A gloo process group of this process alone."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def tiny_model(job):
    return dry.tp_model(job, "float32")[1]


def converter_specs(jax_specs, shapes):
    """JAX's PartitionSpecs carried to state_dict names through the
    converter: each sharded leaf filled with its index along the sharded
    axis, every other leaf with zeros, then convert.flax_to_torch; a
    tensor whose values vary along torch axis d is Shard(d)."""
    def fill(spec, s):
        if "model" not in tuple(spec):
            return np.zeros(s.shape, np.float32)
        ax = tuple(spec).index("model")
        idx = np.arange(s.shape[ax], dtype=np.float32).reshape(
            [-1 if i == ax else 1 for i in range(len(s.shape))])
        return np.broadcast_to(idx, s.shape).copy()

    tree = jax.tree.map(fill, jax_specs, shapes, is_leaf=lambda x: isinstance(x, P))
    out = {}
    for name, t in flax_to_torch(tree).items():
        axes = [d for d in range(t.ndim) if t.shape[d] > 1
                and not torch.equal(t, t.narrow(d, 0, 1).expand_as(t))]
        assert len(axes) <= 1, name
        out[name] = Shard(axes[0]) if axes else Replicate()
    return out


@pytest.mark.parametrize("arch", ["lsfa", "rfcn", "lsfa_mobilenet"])
def test_specs_equal_jax(arch):
    """The port's specs of the tiny LSFA, the tiny R-FCN and a MobileNetV2
    LSFA equal JAX's name by name through the converter's axis map."""
    network = {"add_dcn": False}
    if arch == "lsfa_mobilenet":
        network.update(nettype="mobilenet", add_small_net=False)
    ov = {**dry.TP_OVERRIDES, "network": network}
    jcfg, cfg = jax_load_config(JAX_CONFIG, overrides=ov), load_config(TORCH_CONFIG, overrides=ov)
    if arch == "rfcn":
        jm, tm = jax_rfcn_from_config(jcfg), rfcn_from_config(cfg, device="meta")
        shapes = dict(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                     jnp.zeros((1, H, W, 3)), False))
    else:
        jm, tm = jax_lsfa_from_config(jcfg), lsfa_from_config(cfg, device="meta")
        shapes = flax_shapes(jm, H, W)
    want = converter_specs(jax_tensor_parallel_specs(shapes), shapes)
    got = tensor_parallel_specs(tm)
    assert got == want
    assert got == tensor_parallel_specs(tm.state_dict())
    sharded = {k: v for k, v in got.items() if isinstance(v, Shard)}
    assert sharded == {"feat_conv_3x3.weight": Shard(0), "feat_conv_3x3.bias": Shard(0),
                       **{f"{m}.weight": Shard(1) for m in TP_IN_MODULES}}


def test_refusals_without_a_group():
    job = dry.tiny_tp_job(((1, 1),), grad=False)
    model = tiny_model(job)
    with pytest.raises(RuntimeError, match="process group"):
        make_tp_mesh(1)
    with pytest.raises(RuntimeError, match="process group"):
        shard_params(None, model, tensor_parallel_specs(model))
    assert not any(isinstance(m, (ColumnParallelConv, RowParallelConv)) for m in model.modules())


def test_refusals_and_one_rank_mesh(one_rank_group):
    """make_tp_mesh refuses a mesh that does not cover the world;
    shard_params refuses an axis size that does not divide feat_dim // 2
    and a spec it cannot shard; a (1, 1) mesh over one gloo rank gives the
    unsharded model's maps bit for bit, and save_checkpoint refuses the
    sharded model."""
    job = dry.tiny_tp_job(((1, 1),), grad=False)
    model = tiny_model(job)
    specs = tensor_parallel_specs(model)
    with pytest.raises(ValueError, match="cover"):
        make_tp_mesh(2)
    with pytest.raises(ValueError, match="cover"):
        make_tp_mesh(1, 2)
    three = types.SimpleNamespace(mesh_dim_names=("data", "model"), size=lambda d: 3,
                                  get_group=lambda a: None, get_local_rank=lambda a: 0)
    with pytest.raises(ValueError, match=r"feat_dim // 2 = 32"):
        shard_params(three, model, specs)
    mesh = make_tp_mesh(1)
    assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (1, 1)
    assert mesh.device_type == "cpu"
    with pytest.raises(ValueError, match="backbone.conv0.weight"):
        shard_params(mesh, model, {**specs, "backbone.conv0.weight": Shard(2)})
    with pytest.raises(ValueError, match="backbone.bn_data.bias"):
        shard_params(mesh, model, {**specs, "backbone.bn_data.bias": Shard(0)})
    with pytest.raises(ValueError, match="rfcn_cls.bias"):
        shard_params(mesh, model, {**specs, "rfcn_cls.bias": Shard(0)})

    want = dry.tp_outputs(model, None, job)
    sharded = shard_params(mesh, model, specs)
    assert sharded is model
    assert type(model.feat_conv_3x3) is ColumnParallelConv
    assert all(type(getattr(model, m)) is RowParallelConv for m in TP_IN_MODULES)
    assert model.state_dict().keys() == job["state"].keys()
    got = dry.tp_outputs(model, None, job)
    for g, w in zip(got["key"] + [got["cur"]], want["key"] + [want["cur"]]):
        for k in w:
            assert torch.equal(g[k], w[k]), k
    with pytest.raises(ValueError, match="sharded already"):
        shard_params(mesh, model, specs)
    with pytest.raises(ValueError, match="tensor-parallel"):
        save_checkpoint("unused", 0, model, None, None, 0, None)


def test_meshes_match_replicated(tp4):
    """forward_key, forward_cur and the gradients under (1, 4) and (2, 2)
    against the replicated run, on every rank."""
    job, ranks, ref = tp4
    report = dry.tp_report(ranks, {"float32": ref}, job)
    assert report["ok"], report
    for k in ("1x4/float32", "2x2/float32"):
        assert report[k]["maps_rel_err"] <= dry.TP_REL
        assert report[k]["grads_rel_err"] <= dry.TP_REL
    # the data split: each (2, 2) rank ran forward_cur on its one row
    for r in ranks:
        d, _ = r["2x2/float32"]["coord"]
        assert r["2x2/float32"]["cur"]["rpn_fg"].shape[0] == 1
        assert r["1x4/float32"]["cur"]["rpn_fg"].shape[0] == 2
        assert r["1x4/float32"]["coord"][0] == 0


def test_shards_are_real(tp4):
    """Rank r's feat_conv_3x3 holds output rows [rF/n, (r+1)F/n) of the
    full weight, its heads the matching input columns and the whole bias;
    ranks that differ only on "data" hold equal shards."""
    job, ranks, _ = tp4
    full = job["state"]
    for key, n in (("1x4/float32", 4), ("2x2/float32", 2)):
        assert sorted(r[key]["coord"] for r in ranks) == sorted(
            (d, m) for d in range(4 // n) for m in range(n))
        by_model = {}
        for r in ranks:
            d, m = r[key]["coord"]
            s = r[key]["shards"]
            c = 64 // n
            assert torch.equal(s["feat_conv_3x3.weight"],
                               full["feat_conv_3x3.weight"][m * c:(m + 1) * c])
            assert torch.equal(s["feat_conv_3x3.bias"],
                               full["feat_conv_3x3.bias"][m * c:(m + 1) * c])
            for head in TP_IN_MODULES:
                w = full[f"{head}.weight"]
                assert s[f"{head}.weight"].shape == (w.shape[0], 32 // n, 1, 1)
                assert torch.equal(s[f"{head}.weight"], w[:, m * 32 // n:(m + 1) * 32 // n])
                assert torch.equal(s[f"{head}.bias"], full[f"{head}.bias"])
            by_model.setdefault(m, []).append(s)
        for shards in by_model.values():
            for s in shards[1:]:
                assert all(torch.equal(s[k], shards[0][k]) for k in s)
    assert set(ranks[0]["1x4/float32"]["shards"]) == {
        f"{m}.{p}" for m in TP_OUT_MODULES + TP_IN_MODULES for p in ("weight", "bias")}


def test_meshes_match_jax_tensor_parallel(tp4):
    """The same weights through JAX's forward_key and forward_cur under
    its make_tp_mesh(4) (2 data x 4 model) and shard_params, the batch of
    2 sharded over "data", against the port's (1, 4) ranks."""
    job, ranks, _ = tp4
    jm = jax_lsfa_from_config(jax_load_config(JAX_CONFIG, overrides=dry.TP_OVERRIDES))
    v = torch_to_flax(job["state"], flax_shapes(jm, H, W))
    mesh = jax_make_tp_mesh(n_model=4)
    assert mesh.shape == {"data": 2, "model": 4}
    v_tp = jax_shard_params(mesh, v, jax_tensor_parallel_specs(v))
    key_fn = jax.jit(lambda v, *a: jm.apply(v, *a, method=jm.forward_key))
    cur_fn = jax.jit(lambda v, *a: jm.apply(v, *a, method=jm.forward_cur))
    want = [key_fn(v_tp, *(jnp.asarray(a.numpy()) for a in args)) for args in job["key"]]
    batch = NamedSharding(mesh, P("data"))
    want.append(cur_fn(v_tp, *(jax.device_put(a.numpy(), batch) for a in job["cur"])))
    for r in ranks:
        got = r["1x4/float32"]["key"] + [r["1x4/float32"]["cur"]]
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in w:
                wk = np.asarray(w[k])
                np.testing.assert_allclose(g[k].numpy(), wk, rtol=1e-4, atol=map_atol(wk),
                                           err_msg=k)


def test_streaming_two_gops_at_1x2():
    """StreamingDetector over 2 GOPs with the model sharded over 2 ranks
    gives the replicated detector's detections."""
    job = dry.tiny_tp_job(((1, 2),), grad=False, stream_gops=2)
    job.update(key=[], cur=None)
    ranks = dry.run_tp(job, 2)
    want = [o.numpy() for o in dry.tp_reference(job)["float32"]["stream"]]
    for r in ranks:
        got = [o.numpy() for o in r["1x2/float32"]["stream"]]
        for dets, valid, wd, wv in ((got[0], got[1], want[0], want[1]),
                                    (got[2], got[3], want[2], want[3])):
            assert dets.shape == wd.shape and valid.sum() > 0
            np.testing.assert_array_equal(valid, wv)
            np.testing.assert_array_equal(dets[valid][:, 0], wd[wv][:, 0])
            np.testing.assert_allclose(dets[valid][:, 1], wd[wv][:, 1], rtol=0, atol=1e-5)
            assert_boxes_close(dets, valid, wd, wv)
