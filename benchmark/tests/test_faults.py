"""The check fails what it must fail. A whole run of each cell's harness at
a tiny size on the CPU (the look for a card skipped, everything else as on
the card): a sound run is correct; with the timed path broken underneath
(``benchmark/faults.py``: the carry left unchanged, half of the lanes left
out, an answer altered where it is produced, an NMS that keeps only its
first box, suppresses from 0.1 below its threshold or stops after one
sweep) it is not; and the control, the reference in float8 in the
program's place, is not either. The tiny configurations have limits of
their own (``data/tiny_checks.json``), set as the cells' are, from six
seeds: `det_gap` between the sound runs' readings here (up to 0.0024) and
the control's (0.0157 and more); `recall_miss` between the sound runs' 0
and the NMS faults' (0.0096 and more where they read above 0: a tiny frame
has few boxes, so lowering the threshold or stopping after one sweep
changes no judged detection on two of the six seeds, though it does on the
seed these tests run). The control and the NMS faults at the cells' own
size, against their limits, are the `chip` tests."""

import json
import sys
import time

import pytest
import torch

from benchmark.control import control_readings
from benchmark.faults import FAULTS
from benchmark.harness import FORBIDDEN, ROOT, forbidden_modules, load_json, run_cell

DATA = ROOT / "benchmark" / "tests" / "data"
CELLS = {"lsfa_r101.lanes8": ("tiny_lsfa", "tiny_lanes"),
         "rfcn_r101.frame1": ("tiny_rfcn", "tiny_frames")}


def tiny(workload):
    c, m = CELLS[workload]
    return (json.loads((DATA / f"{c}.json").read_text()),
            json.loads((DATA / f"{m}.json").read_text()),
            json.loads((DATA / "tiny_checks.json").read_text()))


def run_tiny(workload, seed=2**31 + 11):
    cfg, mix, checks = tiny(workload)
    torch.set_num_threads(4)
    return run_cell(cfg, mix, checks, [("frames_per_s", "frames/s")], seed, 1.5, False, "cpu",
                    time.perf_counter())


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_sound_run_is_correct(workload):
    r = run_tiny(workload)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert not forbidden_modules(sys.modules), FORBIDDEN


@pytest.mark.parametrize("workload,fault", sorted(FAULTS), ids=lambda x: str(x))
def test_fault_is_caught(workload, fault, monkeypatch):
    FAULTS[(workload, fault)](monkeypatch)
    r = run_tiny(workload)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_control_fails_at_tiny_size(workload):
    cfg, mix, checks = tiny(workload)
    got = control_readings(cfg, mix, 2**31 + 3, "cpu")
    assert any(got[k] > v for k, v in checks["limits"].items()), got


def cell(workload):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec = next(c for c in bench["workloads"] if c["name"] == workload)
    return (load_json("benchmark", "configs", f"{spec['config']}.json"),
            load_json("benchmark", "traffic", f"{spec['traffic']}.json"),
            load_json("benchmark", "checks", f"{workload}.json"))


@pytest.mark.chip
@pytest.mark.parametrize("workload", sorted(CELLS))
def test_control_fails_at_cell_size(workload, card):
    cfg, mix, checks = cell(workload)
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        got = control_readings(cfg, mix, seed, card)
        assert any(got[k] > v for k, v in checks["limits"].items()), got


NMS_FAULTS = sorted(k for k in FAULTS if k[1].startswith("nms_"))


@pytest.mark.chip
@pytest.mark.parametrize("workload,fault", NMS_FAULTS, ids=lambda x: str(x))
def test_nms_fault_is_caught_at_cell_size(workload, fault, card, monkeypatch):
    cfg, mix, checks = cell(workload)
    FAULTS[(workload, fault)](monkeypatch)
    r = run_cell(cfg, mix, checks, [], 2**31 + 4, 4.0, False, card, time.perf_counter())
    assert not r["correct"], r["checks"]
