"""The single-frame R-FCN: the ResNet-101 trunk, feature conv and R-FCN
heads on every frame (``models/rfcn.py`` in the program,
``reference/model.py::RFCN`` here)."""

from __future__ import annotations

import torch

from benchmark.count_flops import count
from benchmark.kinds import program_config
from benchmark.reference import model as ref

PATHS = {"nettype": "resnet"}


def program(cfg: dict, device):
    from lsfa_tpu_torch.eval.rfcn_tester import rfcn_from_config

    pcfg = program_config(cfg)
    return rfcn_from_config(pcfg, device=device), pcfg


def reference(cfg: dict, prec: ref.Precision, device) -> ref.RFCN:
    return ref.RFCN(prec=prec, device=device, **ref.net_args(cfg, PATHS))


def flops_per_frame(net, cfg: dict) -> float:
    """One BGR frame through the network to its detection maps."""
    bh, bw = cfg["tpu"]["default_bucket"]
    return float(count(lambda: net(torch.empty(1, bh, bw, 3, dtype=torch.uint8, device="meta"))))
