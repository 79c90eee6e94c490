"""What the benchmark loads: nothing of the JAX stack or the JAX package
(top-level names compared whole), and in the reference nothing of the
program either; the JAX package, the repo-level bench.py and tools/ as they
stood when the benchmark was written."""

import ast
import hashlib
import json
import subprocess
import sys

import pytest

from benchmark.harness import FORBIDDEN, ROOT, forbidden_modules

BENCH_DIR = ROOT / "benchmark"
PROGRAM = "lsfa_tpu_torch"
REFERENCE_SIDE = ["reference/model.py", "reference/detect.py", "judge.py", "weights.py",
                  "peaks.py", "count_flops.py"]


def imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", sorted(BENCH_DIR.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_forbidden_import(path):
    assert not imported_roots(path) & set(FORBIDDEN)


@pytest.mark.parametrize("rel", REFERENCE_SIDE)
def test_reference_side_imports_nothing_of_the_program(rel):
    assert PROGRAM not in imported_roots(BENCH_DIR / rel)


def test_forbidden_names_are_whole():
    assert forbidden_modules(["lsfa_tpu_torch.eval", "torch", "jaxtyping"]) == []
    assert forbidden_modules(["lsfa_tpu.ops", "jax.numpy"]) == ["jax", "lsfa_tpu"]


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, check=True, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_neither_jax_nor_the_program():
    """Each configuration's kind file builds its reference (on meta tensors)
    without loading the program."""
    roots = _loaded("import benchmark.reference.model, benchmark.reference.detect, "
                    "benchmark.judge, benchmark.weights, benchmark.count_flops\n"
                    "from benchmark import kinds\nfrom benchmark.harness import load_json\n"
                    "for c in load_json('BENCHMARK.json')['configs']:\n"
                    "    cfg = load_json(c['file'])\n"
                    "    kinds.find(cfg['model']).reference(cfg, "
                    "benchmark.reference.model.Precision(), 'meta')")
    assert not roots & (set(FORBIDDEN) | {PROGRAM})


def test_harness_loads_no_jax():
    roots = _loaded("import benchmark.run, benchmark.harness, benchmark.entries.process_gops, "
                    "benchmark.entries.detect, benchmark.control; "
                    "import lsfa_tpu_torch.eval.tester, "
                    "lsfa_tpu_torch.eval.rfcn_tester, lsfa_tpu_torch.models.lsfa")
    assert PROGRAM in roots and not roots & set(FORBIDDEN)


def _digest(paths):
    h = {}
    for p in paths:
        for f in sorted(p.rglob("*") if p.is_dir() else [p]):
            if f.is_file() and "__pycache__" not in f.parts:
                h[str(f.relative_to(ROOT))] = hashlib.sha256(f.read_bytes()).hexdigest()
    return h


FROZEN = BENCH_DIR / "tests" / "data" / "frozen_sources.json"


def test_jax_package_bench_and_tools_unchanged():
    want = json.loads(FROZEN.read_text())
    got = _digest([ROOT / "lsfa_tpu", ROOT / "bench.py", ROOT / "tools"])
    assert got == want
