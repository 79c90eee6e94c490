"""Count the model step's FLOPs per frame of a configuration, once, over the
plain float32 reference at the cell's shapes (meta tensors: nothing is
computed), and print or store them.

    python3 -m benchmark.count_flops <config> [--write]

`--write` stores the count as ``flops_per_frame`` in
``benchmark/configs/<config>.json``; a CPU test recounts it. The count is
``FlopCounterMode``'s (two per multiply-add of every convolution and
matrix product; the bilinear sampling of warps and DCN taps is not
counted) over the network's forward to its detection maps; detection
(proposals, PSROI pooling, NMS) is not counted. For LSFA a frame is the
mean over a GOP: one key step and KEY_FRAME_INTERVAL - 1 non-key frames.
"""

from __future__ import annotations

import argparse
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import ROOT, load_json
from benchmark.reference import model as ref


def _count(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def flops_per_frame(cfg: dict) -> float:
    net = ref.build(cfg["model"], cfg, device="meta")
    bh, bw = cfg["tpu"]["default_bucket"]
    meta = dict(device="meta")
    if cfg["model"] == "rfcn":
        return float(_count(lambda: net(torch.empty(1, bh, bw, 3, dtype=torch.uint8, **meta))))
    stride = cfg["network"]["RPN_FEAT_STRIDE"]
    fh, fw, c = bh // stride, bw // stride, cfg["network"]["DFF_FEAT_DIM"]
    n = cfg["TEST"]["KEY_FRAME_INTERVAL"] - 1
    key_in = torch.empty(1, bh * 3 // 2, bw, 1, dtype=torch.uint8, **meta)
    key = _count(lambda: net.forward_key(key_in, torch.empty(1, bh, bw, 3, **meta),
                                         torch.empty(1, fh, fw, c, **meta),
                                         torch.zeros(1, **meta)))
    cur = _count(lambda: net.forward_cur(torch.empty(n, bh // 4, bw // 4, 3, dtype=torch.uint8,
                                                     **meta),
                                         torch.empty(n, fh, fw, c, **meta),
                                         torch.empty(n, fh, fw, 2, **meta),
                                         torch.empty(n, fh, fw, 3, **meta)))
    return float(key + cur) / (n + 1)


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
