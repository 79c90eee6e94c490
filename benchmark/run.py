"""Run one cell of the benchmark once, on the card, and print its result.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration, traffic mix,
checks and metrics are found by their names in ``BENCHMARK.json``. With
``--trace 0`` the result line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics and the device's busy and window
seconds. The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with a trace
``breakdown``, ``readings`` of the check that are not compared, and
``checks`` last: each number compared with its limit);
the checks also go to standard error as its last lines.

It exits non-zero and prints no result without a CUDA card (or with fewer
than the cell asks for), and when a module of the JAX stack or of the JAX
package is loaded once the window has closed. Build and kernel caches stay
inside the checkout, at fixed paths.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cell_spec(bench: dict, workload: str, trace: bool):
    """(cell, config, traffic, checks, [(metric, unit)]) of a workload."""
    from benchmark.harness import load_json

    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}: one of {sorted(cells)}")
    cell = cells[workload]
    group = bench["per_layer"] if trace else bench["end_to_end"]
    metrics = [(m["name"], m["unit"]) for m in group
               if workload in m.get("workloads", [workload])]
    return (cell, load_json("benchmark", "configs", f"{cell['config']}.json"),
            load_json("benchmark", "traffic", f"{cell['traffic']}.json"),
            load_json("benchmark", "checks", f"{workload}.json"), metrics)


def main(argv=None) -> int:
    args = parse_args(argv)
    cache = ROOT / ".bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    import torch

    from benchmark.harness import forbidden_modules, run_cell

    cell, cfg, mix, checks, metrics = cell_spec(bench, args.workload, bool(args.trace))
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(cfg, mix, checks, metrics, args.seed, args.seconds, bool(args.trace),
                      "cuda", T0)
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
