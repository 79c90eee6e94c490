"""The port's measurement tools (lsfa_tpu_torch/tools/) on the CPU.

- bench_train --tiny: its first step gives the losses of JAX's
  make_train_step on the same weights (the bench's seeded ones carried
  into the flax tree), the same batch and the same anchor draws
  (test_torch_train_step.jax_draws), at that file's tolerance (1e-4
  relative); JAX's step compiled without algsimp.
- report_mfu: the FLOPs it counts for the tiny key step (with DCN on)
  equal an analytic sum exactly: 2 x MACs over every convolution (from
  each conv module's weight and input or output shape), the deformable
  convs' matmuls, the two PSROI contractions and the NMS kernel's 16
  operations per pair; and they lie within FLOP_BAND of XLA's
  cost_analysis() flops for JAX's tiny key step (built as
  tools/report_mfu.py:129-148 builds it, with DCN on too). Measured
  ratio 1.2079 (1.3443 without DCN): XLA's count of a convolution leaves
  out the multiply-adds that fall on the zero padding, and at 64x96 the
  padding is a large share of every map (without DCN the ResNet-18
  trunk alone reads 1.347, FlowNet-S 1.369); XLA counts the deformable
  conv's bilinear sampling, which FlopCounterMode does not.
- ab_interleaved runs its arms A, B, A, B and computes each pair's B/A.
- bench_decode runs on a tiny clip where the native decoder loads.
- every tool refuses the CPU unless asked, and on --device cpu names its
  metrics cpu_smoke_*.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch import nn

from lsfa_tpu.config import get_default_config as jax_default_config
from lsfa_tpu.eval.tester import StreamingDetector as JaxStreamingDetector
from lsfa_tpu.models.lsfa import lsfa_from_config as jax_lsfa_from_config
from lsfa_tpu.train.schedule import make_optimizer as jax_make_optimizer
from lsfa_tpu.train.train_step import TrainSettings as JaxTrainSettings
from lsfa_tpu.train.train_step import make_train_step as jax_make_train_step
from lsfa_tpu_torch.bench import _build_detector, tiny_config
from lsfa_tpu_torch.data import coviar
from lsfa_tpu_torch.models.resnet import DeformConv2d
from lsfa_tpu_torch.ops import nms_cuda
from lsfa_tpu_torch.tools import (ab_interleaved, bench_decode, bench_train, profile_breakdown,
                                  profile_detection, profile_train, report_mfu)
from tests.test_torch_convert import two_torch_threads  # noqa: F401  (a fixture)
from tests.test_torch_train import flax_shapes, torch_to_flax
from tests.test_torch_train_step import NO_ALGSIMP, jax_draws

pytestmark = pytest.mark.usefixtures("two_torch_threads")

TINY = os.path.join(os.path.dirname(__file__), "..", "lsfa_tpu_torch", "configs",
                    "lsfa_tiny_smoke.json")
# the port's FLOPs of the tiny key step over XLA's cost_analysis() flops
# of JAX's, DCN on: measured 1.2079 (XLA leaves the padding's
# multiply-adds out and counts the bilinear sampling)
FLOP_BAND = (1.17, 1.25)


def tiny_jax_config(cfg):
    """JAX's default config with the port's --tiny cut (bench.tiny_config)
    and `cfg`'s DCN setting."""
    jcfg = tiny_config(jax_default_config())
    jcfg.network.add_dcn = cfg.network.add_dcn
    return jcfg


def test_bench_train_first_step_matches_jax():
    args = bench_train.parse_args(["--tiny", "--device", "cpu"])
    b = bench_train.build(args)
    cfg, model = b["cfg"], b["model"]
    h, w = cfg.tpu.default_bucket
    jcfg = tiny_jax_config(cfg)
    jm = jax_lsfa_from_config(jcfg)
    v = torch_to_flax(model.state_dict(), flax_shapes(jm, h, w))
    settings = JaxTrainSettings.from_config(jcfg)
    params = jax.tree.map(jnp.asarray, v["params"])
    stats = jax.tree.map(jnp.asarray, v["batch_stats"])
    opt = jax_make_optimizer(params, base_lr=args.lr, lr_steps=[10000])
    batch = {k: jnp.asarray(x) for k, x in bench_train.synthetic_batch(cfg, 1).items()}
    rng = jax.random.PRNGKey(1)
    step = jax_make_train_step(jm, settings, None, opt)
    call = (params, stats, opt.init(params), batch, rng)
    jmetrics = step.lower(*call).compile(compiler_options=NO_ALGSIMP)(*call)[3]
    draws = jax_draws(rng, 1, (h // 16) * (w // 16) * jcfg.network.NUM_ANCHORS)
    metrics = b["step"](b["batch"], draws)
    assert sorted(metrics) == sorted(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-4, atol=0,
                                   err_msg=k)
    assert float(jmetrics["total_loss"]) > 0 and float(jmetrics["rcnn_bbox_loss"]) > 0


def analytic_key_step_flops(det, cfg, fn):
    """2 x MACs of every convolution, deformable conv and PSROI
    contraction that one call of fn() runs, plus nms_cuda.nms_flops of
    each NMS call (its shapes from report_mfu's own record)."""
    total = [0]

    def conv(mod, args, out):
        w = mod.weight
        if isinstance(mod, nn.ConvTranspose2d):    # every input pixel meets the kernel
            x = args[0]
            total[0] += 2 * x.shape[0] * x.shape[2] * x.shape[3] * w.numel() // mod.groups
        else:
            total[0] += 2 * out.numel() * w[0].numel()

    def deform(mod, args, out):
        total[0] += 2 * out.numel() * mod.weight[0].numel()

    hooks = [m.register_forward_hook(deform if isinstance(m, DeformConv2d) else conv)
             for m in det.model.modules()
             if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, DeformConv2d))]
    with report_mfu.counting() as got:
        fn()
    for h in hooks:
        h.remove()
    fh, fw = det.feat_hw
    n, p = cfg.TEST.RPN_POST_NMS_TOP_N, 7
    for o in (cfg.dataset.NUM_CLASSES, 8):           # the class and box PSROI maps
        total[0] += 2 * (n * p * p * o * fh * fw + n * p * p * o * fh)
    nms = sum(nms_cuda.nms_flops(b, k) for b, k in got["nms_calls"])
    return total[0] + nms, got


def test_report_mfu_counts_the_key_step_exactly():
    cfg = tiny_config()
    cfg.network.add_dcn = True                       # the deformable convs' matmuls too
    cfg, det = _build_detector(cfg, "cpu")
    key_step, frames = report_mfu.programs(det, cfg, 1)["key_step"]
    assert frames == 1
    with torch.no_grad():
        want, got = analytic_key_step_flops(det, cfg, key_step)
    assert got["nms_calls"] == [(1, 128), (cfg.dataset.NUM_CLASSES - 1, 32)]
    assert got["flops"] == want
    assert got["bytes"] > 0

    # XLA's count of JAX's tiny key step (tools/report_mfu.py:129-148)
    h, w = cfg.tpu.default_bucket
    jcfg = tiny_jax_config(cfg)
    jm = jax_lsfa_from_config(jcfg)
    v = torch_to_flax(det.model.state_dict(), flax_shapes(jm, h, w))
    jdet = JaxStreamingDetector(jm, v, jcfg, (h, w), batch=1)
    key = jnp.zeros((1, h, w, 3), jnp.uint8)
    im_info = jnp.asarray([[600.0, float(w), 1.0]], jnp.float32)
    ca = jdet._key_step.lower(jdet.variables, key, jdet.data_key, jdet.feat_key,
                              jnp.ones((1,), jnp.float32), im_info).compile().cost_analysis()
    ca = ca[0] if isinstance(ca, (list, tuple)) else ca
    ratio = got["flops"] / float(ca["flops"])
    assert FLOP_BAND[0] <= ratio <= FLOP_BAND[1], ratio


def test_ab_interleaved_alternates_and_divides():
    seen = []
    fps = {"A": iter([100.0, 110.0, 90.0]), "B": iter([50.0, 121.0, 99.0])}

    def trial(arm):
        seen.append(arm)
        return next(fps[arm])

    r = ab_interleaved.interleave({"A": "A", "B": "B"}, 3, trial)
    assert seen == r["order"] == ["A", "B"] * 3
    assert r["fps_a"] == [100.0, 110.0, 90.0] and r["fps_b"] == [50.0, 121.0, 99.0]
    np.testing.assert_allclose(r["pair_ratios"], [0.5, 1.1, 1.1])
    assert r["median_b_over_a"] == pytest.approx(1.1)
    assert r["ratio_spread"] == pytest.approx([0.5, 1.1])
    assert r["median_fps_a"] == 100.0 and r["median_fps_b"] == 99.0
    with pytest.raises(SystemExit, match="--sync is not carried"):
        ab_interleaved.main(["--b=--sync", "--device", "cpu", "--cfg", TINY])


def test_bench_decode_on_a_tiny_clip():
    if not coviar.available():
        pytest.skip("native coviar plane not built (needs FFmpeg's libraries)")
    r = bench_decode.main(["--width", "128", "--height", "96", "--gops", "1",
                           "--passes", "1"])
    assert sorted(r["clips"]) == ["easy (bench clip)", "hard (texture+noise)",
                                  "synth (3-object scenes)"]
    for clip in r["clips"].values():
        assert clip["ms_per_frame"] > 0 and clip["kbit_per_frame"] > 0
        assert "demux+avcodec" in clip["stages_ms_per_frame"]


@pytest.mark.parametrize("tool, argv, metrics", [
    (profile_breakdown, ["--cfg", TINY, "--reps", "1"], "components"),
    (profile_detection, ["--cfg", TINY, "--reps", "1"], "variants"),
    (profile_train, ["--cfg", TINY, "--reps", "1", "--steps", "1", "--height", "32", "--width",
                     "48"], "phases"),
    (bench_train, ["--tiny", "--steps", "1", "--remat"], "ms_per_step"),
    (report_mfu, ["--tiny", "--trials", "1", "--skip-train", "--gops", "1"], "programs"),
])
def test_tool_on_the_cpu_names_its_metrics(tool, argv, metrics, monkeypatch):
    r = tool.main(argv + ["--device", "cpu"])
    assert r["metric"].startswith("cpu_smoke_") and "cpu_smoke_" + metrics in r
    assert metrics not in r and r["device"]["name"] == "cpu"
    if tool is report_mfu:
        rows = report_mfu.program_rows(r)
        assert all(row["mfu_pct"] is None and row["gflop"] > 0 for row in rows.values())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA card is available: pass --device cpu"):
        tool.main(argv)
