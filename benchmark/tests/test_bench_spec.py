"""BENCHMARK.json against the contract's shape, and every name in it
resolving to its own files."""

import inspect
import json
import re

import pytest

from benchmark import entries, kinds
from benchmark.harness import ROOT, load_json, metric_reader

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    assert sum(c["chips"] == 4 for c in BENCH["workloads"]) <= max(1, cells // 4)


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_resolves(cell):
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] in (1, 4) and len(cell["why"]) <= 200
    cfg = load_json("benchmark", "configs", f"{cell['config']}.json")
    mix = load_json("benchmark", "traffic", f"{cell['traffic']}.json")
    checks = load_json("benchmark", "checks", f"{cell['name']}.json")
    assert (ROOT / "benchmark" / "kinds" / f"{cfg['model']}.py").is_file()
    kind = kinds.find(cfg["model"])
    for fn, args in (("program", ["cfg", "device"]), ("reference", ["cfg", "prec", "device"]),
                     ("flops_per_frame", ["net", "cfg"])):
        assert list(inspect.signature(getattr(kind, fn)).parameters) == args
    assert (ROOT / "benchmark" / "entries" / f"{mix['entry']}.py").is_file()
    driver = entries.driver(mix["entry"])
    assert all(callable(getattr(driver, fn)) for fn in (
        "build", "stage", "call", "keep", "release", "sample", "program_frames",
        "reference_frames"))
    assert checks["limits"] and all(v > 0 for v in checks["limits"].values())
    e2e = [m for m in BENCH["end_to_end"] if cell["name"] in m.get("workloads", [cell["name"]])]
    assert {m["name"] for m in e2e} > {"setup_s"}
    per = [m for m in BENCH["per_layer"] if cell["name"] in m.get("workloads", [cell["name"]])]
    assert per


# configurations run as their sources publish them
UNCUT = ("lsfa_r101", "rfcn_r101")


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    data = load_json(cfg["file"])
    assert cfg["file"].startswith("benchmark/configs/")
    assert data["source"] == cfg["source"] and data["reduced"] == cfg["reduced"]
    assert len(cfg["reduced"]) <= 16 and all(NAME.match(k) for k in cfg["reduced"])
    assert all(k in data and not k.lower().endswith(("_dim", "_rank")) for k in cfg["reduced"])
    if cfg["name"] in UNCUT:
        assert cfg["reduced"] == []
    assert data["assumed"] and data["flops_per_frame"] > 0
    assert any(c["config"] == cfg["name"] for c in BENCH["workloads"])


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert callable(metric_reader(metric["name"]))
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert metric["layer"] and "\n" not in metric["layer"]
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_setup_metric_in_every_cell():
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert "workloads" not in setup and setup["bound"] <= 0.25
