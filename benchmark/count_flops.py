"""Count the model step's FLOPs per frame of a configuration, once, over the
plain float32 reference at the cell's shapes (meta tensors: nothing is
computed), and print or store them.

    python3 -m benchmark.count_flops <config> [--write]

`--write` stores the count as ``flops_per_frame`` in
``benchmark/configs/<config>.json``; a CPU test recounts it. The count is
``FlopCounterMode``'s (two per multiply-add of every convolution and
matrix product; the bilinear sampling of warps and DCN taps is not
counted) over the network's forward to its detection maps; detection
(proposals, PSROI pooling, NMS) is not counted. What a frame is, is the
kind's (``benchmark/kinds/<model>.py::flops_per_frame``): for LSFA the
mean over a GOP of one key step and KEY_FRAME_INTERVAL - 1 non-key frames.
"""

from __future__ import annotations

import argparse
import json

from torch.utils.flop_counter import FlopCounterMode

from benchmark import kinds
from benchmark.harness import ROOT, load_json
from benchmark.reference import model as ref


def count(fn) -> int:
    """The FLOPs of calling `fn`."""
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def flops_per_frame(cfg: dict) -> float:
    kind = kinds.find(cfg["model"])
    return kind.flops_per_frame(kind.reference(cfg, ref.Precision(), "meta"), cfg)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("config")
    p.add_argument("--write", action="store_true")
    args = p.parse_args(argv)
    cfg = load_json("benchmark", "configs", f"{args.config}.json")
    flops = flops_per_frame(cfg)
    print(json.dumps({"config": args.config, "flops_per_frame": flops}))
    if args.write:
        path = ROOT / "benchmark" / "configs" / f"{args.config}.json"
        cfg["flops_per_frame"] = flops
        path.write_text(json.dumps(cfg, indent=2) + "\n")


if __name__ == "__main__":
    main()
