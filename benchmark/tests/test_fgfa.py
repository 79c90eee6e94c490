"""FGFA's cell, `fgfa_r101.ring8`, at a tiny size on the CPU
(``data/tiny_fgfa.json``: the tiny R-FCN's widths with K = 2 and full-width
FlowNet-S and tower; ``data/tiny_ring.json``: 2 lanes, 3 frames a lane a
call, videos of 9 frames): a traced run is correct and reads every
per-layer metric of the cell that the CPU can read (the host's; the
device readers on hand-made span windows, and on the card in the `chip`
test); the check fails a program whose NMS keeps only its best box or whose
rows are one frame late, or whose neighbours' features enter unwarped, and
the reference in float8; on videos of one call each
(``data/tiny_ring_restart.json``: every call a restart, so the check meets
one whatever the window's length) it fails a program whose windows run
across the restart instead of padding; the frozen FLOPs recount; the
weighting's least bytes at known shapes."""

import importlib.util
import json
import time

import pytest
import torch

from benchmark import faults
from benchmark.control import control_readings
from benchmark.count_flops import flops_per_frame
from benchmark.harness import ROOT, load_json, run_cell
from benchmark.run import cell_spec

DATA = ROOT / "benchmark" / "tests" / "data"
CELL = "fgfa_r101.ring8"
BENCH = load_json("BENCHMARK.json")
NEW = ["fgfa_feat_device_ms_per_frame", "fgfa_flow_device_ms_per_frame",
       "fgfa_embed_device_ms_per_frame", "fgfa_weigh_roofline_pct",
       "fgfa_model_device_ms_per_frame", "fgfa_model_host_ms_per_frame"]
SEED = 2**31 + 53


def tiny():
    return tuple(json.loads((DATA / f"{n}.json").read_text())
                 for n in ("tiny_fgfa", "tiny_ring", "tiny_checks"))


def cell_metrics(group):
    return [(m["name"], m["unit"]) for m in BENCH[group] if CELL in m.get("workloads", [CELL])]


def reader(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "benchmark" / "metrics"
                                                  / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(seed, trace=False, metrics=(), mix=None):
    torch.set_num_threads(4)
    cfg, ring, checks = tiny()
    mix = mix or ring
    return run_cell(cfg, mix, checks, list(metrics), seed, 1.0, trace, "cpu", time.perf_counter())


def test_tiny_cell_is_correct_and_reads_its_metrics():
    names = cell_metrics("per_layer") + cell_metrics("end_to_end")
    assert {n for n, _ in names} >= set(NEW) | {"frames_per_s", "frame_latency_p95_ms"}
    r = run(SEED, trace=True, metrics=names)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0 and r["checks"]["frames_compared"]["value"] == 4
    got = {k: v["value"] for k, v in r["metrics"].items()}
    # on the CPU: no device trace, so the device readers (and the rates
    # that read the config's FLOPs, null in the tiny config) read nothing
    assert set(got) == {"frames_per_s", "frame_latency_p95_ms", "setup_s",
                        "host_enqueue_ms_per_frame", "detect_host_ms_per_frame",
                        "fgfa_model_host_ms_per_frame"}
    assert all(v > 0 for v in got.values())


def test_new_readers_on_a_span_window():
    cfg, _, _ = tiny()
    dev = {"model.fgfa.feat": 0.02, "model.fgfa.flow": 0.05, "model.fgfa.embed": 0.03,
           "model.fgfa.weigh": 0.004, "model.fgfa.warp": 0.001, "model.heads": 0.002,
           "model.trunk": 0.015, "stream.fgfa.ring": 0.003, "detect": 0.01}
    host = {"model.fgfa.feat": 0.004, "model.fgfa.flow": 0.003, "model.heads": 0.001,
            "model.trunk": 0.003, "stream.fgfa.process_frames": 0.05}
    window = {"cfg": cfg, "trace_frames": 10,
              "span_trace": {"device": {k: {"incl_s": v} for k, v in dev.items()}},
              "spans": {"host": {k: {"incl_s": v} for k, v in host.items()},
                        "counters": {"model.frames.fgfa": 8}}}
    assert reader(NEW[0]).read(window) == pytest.approx(2.0)
    assert reader(NEW[1]).read(window) == pytest.approx(5.0)
    assert reader(NEW[2]).read(window) == pytest.approx(3.0)
    # the six model-step spans, none inside another: model.trunk (inside
    # feat), the ring and detection are not counted
    assert reader(NEW[4]).read(window) == pytest.approx(10.7)
    assert reader(NEW[5]).read(window) == pytest.approx(1.0)
    roof = reader(NEW[3])
    frame = roof.weigh_bytes(5, 64, 4 * 8)
    assert roof.read(window) == pytest.approx(100 * 10 * frame / 3.35e12 / 0.004)
    parent = {"cfg": cfg, "trace_frames": 10, "trace": {"by_name": {}}}
    empty = {"cfg": cfg, "trace_frames": 10, "span_trace": {"device": {}, "idle": {}},
             "spans": {"host": {}, "counters": {}}}
    assert all(reader(n).read(parent) is None and reader(n).read(empty) is None for n in NEW)


def test_weigh_bytes_at_known_shapes():
    roof = reader("fgfa_weigh_roofline_pct")
    # 21 bf16 embeddings of 2048, 21 float32 features of 1024, the float32
    # sum, at each of 38 x 64 pixels
    assert roof.weigh_bytes(21, 1024, 38 * 64) == 2432 * (21 * 4096 + 21 * 4096 + 4096)
    assert roof.frame_bytes(load_json("benchmark", "configs", "fgfa_r101.json")) == 428343296
    assert roof.weigh_bytes(3, 64, 8) == 8 * (3 * 2048 * 2 + 3 * 64 * 4 + 64 * 4)


def test_flops_recounted():
    cfg = load_json("benchmark", "configs", "fgfa_r101.json")
    assert flops_per_frame(cfg) == cfg["flops_per_frame"]


def _rows_one_late(mp):
    """Each row holds the frame after the one it should: detections
    emitted K - 1 frames behind the newest."""
    from lsfa_tpu_torch.eval.fgfa_tester import FGFADetector

    orig = FGFADetector._emit
    mp.setattr(FGFADetector, "_emit",
               lambda self, centres: orig(self, range(centres.start + 1, centres.stop + 1)))


def _padding_dropped(mp):
    """Each window slot clamped into the frames since the reset, not into
    its frame's video: across a restart a window takes the other video's
    frames where it should repeat its end frame."""
    from lsfa_tpu_torch.eval.fgfa_tester import FGFADetector

    mp.setattr(FGFADetector, "window", lambda self, g: [
        min(max(g + d, 0), self.pushed - 1) for d in range(-self.k, self.k + 1)])


def _warp_skipped(mp):
    """The neighbours' features enter the aggregation unwarped."""
    from lsfa_tpu_torch.models import fgfa

    mp.setattr(fgfa, "flow_warp", lambda feat, flow: feat)


FAULTS = {"nms_keep_first": faults._nms(faults._keep_first), "rows_one_late": _rows_one_late,
          "padding_dropped": _padding_dropped, "warp_skipped": _warp_skipped}
# the fault that shows only where a window meets a restart: run on videos of
# one call each
AT_RESTARTS = ("padding_dropped",)


@pytest.mark.parametrize("fault", list(FAULTS))
def test_faults_fail(fault):
    mix = json.loads((DATA / "tiny_ring_restart.json").read_text()) if fault in AT_RESTARTS \
        else None
    with pytest.MonkeyPatch.context() as mp:
        FAULTS[fault](mp)
        r = run(SEED, mix=mix)
    assert not r["correct"], r["checks"]


def test_sound_program_passes_at_restarts():
    """The mix the restart faults run on: the sound program is correct
    there."""
    r = run(SEED, mix=json.loads((DATA / "tiny_ring_restart.json").read_text()))
    assert r["correct"], r["checks"]


def test_control_fails():
    cfg, mix, checks = tiny()
    torch.set_num_threads(4)
    got = control_readings(cfg, mix, SEED, "cpu")
    assert any(got[k] > v for k, v in checks["limits"].items()), got


@pytest.mark.chip
def test_cell_on_the_card(card):
    """The cell at its own size on the card, traced, at a short window:
    correct, and every per-layer metric of the cell reads, the weighting
    within its roofline."""
    _, cfg, mix, checks, names = cell_spec(BENCH, CELL, True)
    r = run_cell(cfg, mix, checks, names, SEED, 5.0, True, "cuda", time.perf_counter())
    assert r["correct"], r["checks"]
    got = {k: v["value"] for k, v in r["metrics"].items()}
    assert set(got) == {n for n, _ in names}
    assert 0 < got["fgfa_weigh_roofline_pct"] <= 100
