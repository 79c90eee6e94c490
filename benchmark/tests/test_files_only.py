"""A configuration of a new model kind, driven by a new entry and judged
against its kind's own reference, goes in as new files and new entries in
``BENCHMARK.json`` only. In a copy of the benchmark, a kind ``rfcn_twin``
(the ``rfcn`` kind's functions under a new name), an entry ``detect_twin``
(a subclass of the ``detect`` entry's driver), their configuration, mix
and checks (the tiny R-FCN's) and a cell, an end-to-end metric and a
per-layer metric for them are added; a traced run of the new cell from the
copy, on the CPU, is correct, reads the per-layer metric from the
program's spans, and no file the copy had before was changed."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from benchmark.harness import ROOT

DATA = ROOT / "benchmark" / "tests" / "data"
CELL = "tiny_twin.frames"

KIND = '''"""The rfcn kind under another name."""

from benchmark.kinds.rfcn import flops_per_frame, program, reference  # noqa: F401
'''

ENTRY = '''"""The detect entry under another name."""

from benchmark.entries.detect import FrameDriver


class Driver(FrameDriver):
    pass
'''

RUN = f'''
import json, sys, time
import torch
import benchmark
from benchmark.harness import load_json, run_cell
from benchmark.run import cell_spec
torch.set_num_threads(4)
bench = load_json("BENCHMARK.json")
_, cfg, mix, checks, per_layer = cell_spec(bench, "{CELL}", True)
end_to_end = cell_spec(bench, "{CELL}", False)[4]
r = run_cell(cfg, mix, checks, per_layer, 2**31 + 29, 1.5, True, "cpu", time.perf_counter())
r["end_to_end"] = [n for n, _ in end_to_end]
r["package"] = benchmark.__file__
r["loaded"] = sorted(m for m in sys.modules if m.startswith(("benchmark.kinds.",
                                                             "benchmark.entries.")))
print(json.dumps(r))
'''


def digests(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_kind_and_entry_as_files_only(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digests(tmp_path / "benchmark")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((DATA / "tiny_rfcn.json").read_text())
    mix = json.loads((DATA / "tiny_frames.json").read_text())
    cfg["model"], mix["entry"] = "rfcn_twin", "detect_twin"
    new = {"kinds/rfcn_twin.py": KIND, "entries/detect_twin.py": ENTRY,
           "configs/tiny_twin.json": json.dumps(cfg), "traffic/frames_twin.json": json.dumps(mix),
           f"checks/{CELL}.json": (DATA / "tiny_checks.json").read_text()}
    for rel, text in new.items():
        path = tmp_path / "benchmark" / rel
        assert not path.exists()
        path.write_text(text)
    added = {
        "configs": {"name": "tiny_twin", "source": cfg["source"], "reduced": cfg["reduced"],
                    "file": "benchmark/configs/tiny_twin.json", "why": "a files-only kind"},
        "workloads": {"name": CELL, "config": "tiny_twin", "traffic": "frames_twin", "chips": 1,
                      "why": "a files-only entry"},
        "end_to_end": {"name": "frames_per_s.twin", "unit": "frames/s", "better": "higher",
                       "bound": 0.25, "source": "host_clock", "workloads": [CELL]},
        "per_layer": {"name": "model_host_ms_per_frame.twin", "unit": "ms", "better": "lower",
                      "source": "program_span", "layer": "model step",
                      "moves": "frames_per_s.twin", "workloads": [CELL]}}
    grown = {k: v + [added[k]] if k in added else v for k, v in bench.items()}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(grown, indent=2))

    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", RUN], cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["package"].startswith(str(tmp_path))
    assert {"benchmark.kinds.rfcn_twin", "benchmark.entries.detect_twin"} <= set(r["loaded"])
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["end_to_end"]) == {"frames_per_s.twin", "setup_s"}
    assert r["metrics"]["model_host_ms_per_frame.twin"]["value"] > 0
    after = digests(tmp_path / "benchmark")
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == set(new)
