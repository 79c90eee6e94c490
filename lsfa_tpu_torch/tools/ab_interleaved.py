"""Interleaved A/B end-to-end benchmark of the port (drift-robust).

The counterpart of the repo-level ``tools/ab_interleaved.py``. A host's
speed drifts between runs (the same chip_smoke.py took 123-182 s on one
kind of card), so two sequential bench runs are not comparable. This
builds two configurations (``lsfa_tpu_torch.bench.E2EArm``) in one
process and runs their end-to-end trials alternately, A, B, A, B, ...:
adjacent trials see the same host, so each pair's B/A ratio holds when
absolute frames/s do not.

    python -m lsfa_tpu_torch.tools.ab_interleaved --b "--bgr8"
    python -m lsfa_tpu_torch.tools.ab_interleaved --a "--gops 2" --b "--gops 4" --pairs 6

--a/--b take the bench's arm flags (--gops N, --bgr8); --clip a clip for
both arms (default: the synthetic stream). Prints one JSON line: each
arm's trials, the order they ran in, each pair's B/A and the median B/A
with its min and max. It runs on the card; ``--device cpu`` runs it on
the CPU, and then every metric name starts with ``cpu_smoke_``.
"""

from __future__ import annotations

import argparse
import json
import shlex
import sys

import numpy as np

from lsfa_tpu_torch import bench
from lsfa_tpu_torch.utils.profiler import labelled, tool_device


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="interleaved A/B of two bench configurations")
    ap.add_argument("--a", default="", help="bench arm flags of A (default: the bench's)")
    ap.add_argument("--b", required=True, help="bench arm flags of B")
    ap.add_argument("--pairs", type=int, default=5, help="A/B trial pairs")
    ap.add_argument("--clip", default=None, help="MPEG-4 clip (default: the synthetic stream)")
    ap.add_argument("--cfg", default=None, help="JSON config of both arms (default: flagship)")
    ap.add_argument("--stream-gops", type=int, default=bench.N_GOPS)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(sys.argv[1:] if argv is None else list(argv))


def interleave(arms: dict, pairs: int, trial=None) -> dict:
    """`pairs` rounds of one trial of arm "A" then one of arm "B"
    (trial(arm) -> frames/s; default bench.e2e_trial's). Returns each
    arm's frames/s, the order run, each pair's B/A, and the median B/A
    with its spread [min, max]."""
    trial = trial or (lambda arm: bench.e2e_trial(arm)["fps"])
    fps = {"A": [], "B": []}
    order, ratios = [], []
    for k in range(pairs):
        for name in ("A", "B"):
            fps[name].append(trial(arms[name]))
            order.append(name)
        ratios.append(fps["B"][-1] / fps["A"][-1])
        print(f"pair {k}: A {fps['A'][-1]:.1f} FPS | B {fps['B'][-1]:.1f} FPS | "
              f"B/A {ratios[-1]:.3f}", file=sys.stderr, flush=True)
    return {"fps_a": fps["A"], "fps_b": fps["B"], "order": order,
            "median_fps_a": float(np.median(fps["A"])),
            "median_fps_b": float(np.median(fps["B"])),
            "pair_ratios": ratios, "median_b_over_a": float(np.median(ratios)),
            "ratio_spread": [min(ratios), max(ratios)]}


def main(argv=None) -> dict:
    """Run the A/B; print and return its JSON result."""
    args = parse_args(argv)
    device = tool_device(args.device)
    flags = {"A": shlex.split(args.a), "B": shlex.split(args.b)}
    print(f"arm A: {flags['A'] or '(defaults)'}   arm B: {flags['B']}", file=sys.stderr,
          flush=True)
    for f in flags.values():                     # refuse a bad flag before building either
        bench.arm_flags(f)
    arms = {name: bench.E2EArm(f, clip=args.clip, cfg_path=args.cfg, device=device,
                               stream_gops=args.stream_gops) for name, f in flags.items()}
    for arm in arms.values():
        arm.warmup()
    result = labelled({"metric": "ab_interleaved_fps_ratio", "arm_a": flags["A"],
                       "arm_b": flags["B"], **interleave(arms, args.pairs)},
                      device, ("fps_a", "fps_b", "median_fps_a", "median_fps_b"))
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
