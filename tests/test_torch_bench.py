"""The port's bench (lsfa_tpu_torch/bench.py) against the JAX package.

The bench's loops run the tiny LSFA (lsfa_tpu_torch/configs/
lsfa_tiny_smoke.json, float32, 64x112) on the CPU with the bench's
seeded weights, perturbed and carried into the flax tree (the inverse of
convert.flax_to_torch, as test_torch_train_step does; rfcn_cls redrawn
at std 0.05 so that scores have no ties, as in test_torch_slice), and
the windows and frames they run are held against JAX's StreamingDetector
on the same numpy payloads: the e2e loop's windows (SyntheticPreparedVideo payloads)
and the device-only mode's windows against `process_prepared_window` /
`process_gops`, the latency mode's flags and detections against
`process_frame`. JAX's jitted steps are compiled with XLA's algsimp pass
off (tests/test_torch_eval_loops.py says why).

Tolerance, that of test_torch_slice: valid rows and labels equal, scores
within 1e-5, boxes within 1e-5 of the frame's largest coordinate
(`assert_boxes_close`). Measured: scores within 1.3e-6, boxes within
2.1e-6 of the frame's largest coordinate.

Also: each timeplex stream's detections equal a single-stream run of the
same payloads exactly; a producer's failure is raised and its thread
stopped; every flag the port does not carry is refused with its reason;
a CPU run names its metrics cpu_smoke_*.
"""

import os

import numpy as np
import pytest
import torch

from lsfa_tpu.config import load_config as jax_load_config
from lsfa_tpu.models.lsfa import lsfa_from_config as jax_lsfa_from_config
from lsfa_tpu_torch import bench
from lsfa_tpu_torch.convert import flax_to_torch
from lsfa_tpu_torch.utils import profiler
from tests.test_torch_convert import perturb
from tests.test_torch_convert import two_torch_threads  # noqa: F401  (a fixture)
from tests.test_torch_eval_loops import ExactJaxStreamingDetector
from tests.test_torch_slice import assert_boxes_close
from tests.test_torch_train import flax_shapes, torch_to_flax

pytestmark = pytest.mark.usefixtures("two_torch_threads")

ROOT = os.path.join(os.path.dirname(__file__), "..")
JAX_CONFIG = os.path.join(ROOT, "configs", "lsfa_tiny_smoke.yaml")
TINY = os.path.join(ROOT, "lsfa_tpu_torch", "configs", "lsfa_tiny_smoke.json")
H, W = 64, 112


@pytest.fixture(scope="module")
def arm():
    """The bench's E2EArm on the tiny config on the CPU (4 GOPs, windows of
    2), its weights perturbed as the flax tree the JAX side takes."""
    arm = bench.E2EArm(["--gops", "2"], cfg_path=TINY, device="cpu", stream_gops=4)
    jcfg = jax_load_config(JAX_CONFIG)
    jcfg.tpu.mv_res_dtype = "float32"          # the port's payloads are float32
    jm = jax_lsfa_from_config(jcfg)
    v = perturb(torch_to_flax(arm.det.model.state_dict(), flax_shapes(jm, H, W)), 1)
    k = v["params"]["rfcn_cls"]["kernel"]
    v["params"]["rfcn_cls"]["kernel"] = (
        np.random.default_rng(2).normal(0, 0.05, k.shape).astype(np.float32))
    arm.det.model.load_state_dict(flax_to_torch(v), strict=True)
    arm.jax = (jcfg, jm, v)
    return arm


def jax_detector(arm):
    jcfg, jm, v = arm.jax
    return ExactJaxStreamingDetector(jm, v, jcfg, (H, W))


def assert_window_close(got, want):
    """A window's (key dets, key valid, cur dets, cur valid), the port's
    against JAX's, at test_torch_slice's tolerance."""
    got = [np.asarray(x) for x in got]
    want = [np.asarray(x) for x in want]
    for di, vi in ((0, 1), (2, 3)):
        dets, valid, jd, jv = got[di], got[vi], want[di], want[vi]
        assert dets.shape == jd.shape
        np.testing.assert_array_equal(valid, jv)
        assert valid.sum() > 0
        np.testing.assert_array_equal(dets[valid][:, 0], jd[jv][:, 0])
        np.testing.assert_allclose(dets[valid][:, 1], jd[jv][:, 1], rtol=0, atol=1e-5)
        assert_boxes_close(dets, valid, jd, jv)


def test_e2e_windows_match_jax(arm):
    windows = []
    r = bench.e2e_trial(arm, collect=windows)
    assert r["fps"] > 0 and len(r["gop_ms"]) == arm.n_gops == 4
    payloads = [arm.pv.gop(g) for g in range(arm.n_gops)]
    jdet = jax_detector(arm)
    assert len(windows) == 2
    for w, start in enumerate((0, 2)):
        want = jdet.process_prepared_window(payloads[start:start + 2], first=start == 0)
        assert_window_close(windows[w], want)


def test_device_only_windows_match_jax(arm):
    windows = []
    r = bench.run_device_only(arm.cfg, arm.det, trials=1, windows=2, collect=windows)
    assert r["metric"] == "lsfa_device_inference_fps" and r["value"] > 0
    key_frames, smalls, mvs, ress, info = bench.device_only_inputs(arm.cfg)
    assert key_frames.shape == (4, 1, H, W, 3) and mvs.dtype == np.float32
    jdet = jax_detector(arm)
    for w in range(2):
        want = jdet.process_gops(key_frames, smalls, mvs, ress, info, first=w == 0)
        assert_window_close(windows[w], want)


def test_latency_flags_and_detections_match_jax(arm):
    frames = []
    r = bench.run_latency(arm, n_frames=24, collect=frames)
    assert r["metric"] == "lsfa_online_frame_latency_ms" and r["value"] > 0
    jdet = jax_detector(arm)
    flags = []
    for fid, (flag, dets, valid) in enumerate(frames):
        flags.append(jdet.key_frame_flag(fid))
        data, small, mv, res, info = arm.pv.frame(fid)
        if flags[-1] in (0, 1):
            want = jdet.process_frame(data, info, flag=flags[-1])
        else:
            want = jdet.process_frame(None, info, mv, res, flag=2, small=small)
        assert_window_close((dets, valid, dets, valid), (*want, *want))
    assert [f for f, _, _ in frames] == flags == [0] + [2] * 11 + [1] + [2] * 11


def test_timeplex_streams_equal_single_stream_runs(arm):
    got = {}
    r = bench.run_timeplex(arm, 3, trials=1, collect=got)
    assert r["metric"] == "lsfa_timeplex_e2e_fps" and r["value"] > 0
    assert sorted(got) == [0, 1, 2]
    for s in range(3):
        pv = bench.synthetic_stream(arm.cfg, 4 * 12, seed=3 + s)
        payloads = [pv.gop(g) for g in range(4)]
        arm.det.reset()
        want = [arm.det.process_prepared_window(payloads[i:i + 2], first=i == 0)
                for i in (0, 2)]
        assert len(got[s]) == 2
        for g, w in zip(got[s], want):
            assert all(torch.equal(a, b) for a, b in zip(g, w)), f"stream {s}"


@pytest.mark.parametrize("flag", sorted(bench.NOT_CARRIED))
def test_untaken_flags_are_refused_with_their_reason(flag):
    with pytest.raises(SystemExit, match=f"{flag} is not carried by the port: "
                                         f"{bench.NOT_CARRIED[flag][:20]}"):
        bench.main([flag, "--device", "cpu", "--cfg", TINY])
    with pytest.raises(SystemExit, match="is not carried"):
        bench.E2EArm([flag], cfg_path=TINY, device="cpu")


def test_cpu_run_names_its_metrics_and_no_card_fails(monkeypatch, capsys):
    r = bench.main(["--device", "cpu", "--cfg", TINY, "--trials", "1", "--stream-gops", "1",
                    "--gops", "1"])
    assert r["metric"] == "cpu_smoke_lsfa_e2e_inference_fps" and r["vs_baseline"] is None
    assert {"cpu_smoke_per_gop_ms_p50", "cpu_smoke_per_gop_ms_p99",
            "cpu_smoke_aggregate_3stream_timeplex_e2e_fps"} <= set(r)
    assert not {"per_gop_ms_p50", "aggregate_3stream_timeplex_e2e_fps"} & set(r)
    assert r["device"] == {"name": "cpu", "power_limit_w": None, "count": 0}
    assert "synthetic payloads, decode excluded" in r["unit"]
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith('{"metric": "cpu_smoke_')
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA card is available: pass --device cpu"):
        bench.main(["--cfg", TINY])
    with pytest.raises(SystemExit, match="no CUDA card"):
        profiler.tool_device("cuda")


def test_producer_failure_is_raised_and_its_thread_stopped():
    class Broken:
        _gop = -1

        def gop(self, g):
            if g == 1:
                raise OSError("decode failed at GOP 1")
            return ("payload", g)

    producer = bench._Producer(Broken(), 3, 1)
    producer.start()
    assert producer.get()[0] == ("payload", 0)
    with pytest.raises(OSError, match="GOP 1"):
        producer.get()
    producer.stop()
    assert not producer._thread.is_alive()
