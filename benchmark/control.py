"""Readings that the limits of a cell's checks are set from, on the card:
the program's over many seeds (whole runs of the cell at a short window),
the control's (the plain reference put in the program's place in the
precision below the configuration's, bfloat16 -> float8 e4m3, judged
against the float32 reference on the same sample), and the program's with
each named fault of ``benchmark/faults.py`` planted underneath.

    python3 -m benchmark.control --workload <name> --seeds 1,2,... \
        --control-seeds 7,8,9 [--faults a,b --fault-seeds 4,5,6] --seconds 6 \
        [--out chiprun_out/control.jsonl]

One JSON line per reading on standard output (and in `--out`). Not run by
the benchmark's own runs.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from benchmark import entries, judge, kinds  # noqa: E402
from benchmark.faults import FAULTS  # noqa: E402
from benchmark.harness import run_cell, seeds  # noqa: E402
from benchmark.reference import model as ref  # noqa: E402
from benchmark.run import ROOT, cell_spec  # noqa: E402
from benchmark.weights import make_state_dict  # noqa: E402


def control_readings(cfg: dict, mix: dict, seed: int, device) -> dict:
    """The control's numbers: the reference in float8 judged by the float32
    reference, on the sample a run of `seed` would draw."""
    s = seeds(seed)
    drv = entries.driver(mix["entry"])(cfg, mix, s["inputs"], device)
    drv.kept = dict.fromkeys(range(drv.cycle))
    sample = drv.sample(np.random.default_rng(s["sample"]))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    for prec in ("float8", "float32"):
        net = kinds.find(cfg["model"]).reference(cfg, ref.Precision(prec), device)
        net.load_state_dict(make_state_dict(cfg, s["weights"], device))
        out.append(drv.reference_frames(net.eval(), sample))
        del net
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    dets = [[f["dets"] for f in item] for item in out[0]]
    return judge.readings(dets, out[1], cfg["TEST"])


def ints(text: str) -> list:
    return [int(x) for x in text.split(",") if x]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=6.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    _, cfg, mix, checks, metrics = cell_spec(bench, args.workload, False)
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def program(side, seed):
        t = time.perf_counter()
        r = run_cell(cfg, mix, checks, metrics, seed, args.seconds, False, "cuda", t)
        emit({"workload": args.workload, "side": side, "seed": seed,
              "correct": r["correct"], "checks": r["checks"], "readings": r["readings"],
              "metrics": {k: v["value"] for k, v in r["metrics"].items()},
              "seconds": time.perf_counter() - t})
        gc.collect()
        torch.cuda.empty_cache()

    for seed in ints(args.seeds):
        program("program", seed)
    for name in [x for x in args.faults.split(",") if x]:
        with pytest.MonkeyPatch.context() as mp:
            FAULTS[(args.workload, name)](mp)
            for seed in ints(args.fault_seeds):
                program(f"fault_{name}", seed)
    for seed in ints(args.control_seeds):
        t = time.perf_counter()
        got = control_readings(cfg, mix, seed, "cuda")
        emit({"workload": args.workload, "side": "control_float8", "seed": seed,
              "readings": got, "seconds": time.perf_counter() - t})
    if out:
        out.close()


if __name__ == "__main__":
    sys.exit(main())
