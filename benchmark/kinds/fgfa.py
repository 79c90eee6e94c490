"""FGFA: the ResNet-101 trunk once a frame, FlowNet-S between each frame and
its 2K neighbours, their warped features embedded and weighted by cosine
similarity, the R-FCN heads on the sum (``models/fgfa.py`` in the
program, ``reference/fgfa.py::FGFA`` here)."""

from __future__ import annotations

import torch

from benchmark.count_flops import count
from benchmark.kinds import program_config
from benchmark.reference import fgfa as ref_fgfa
from benchmark.reference import model as ref

# the network switches the reference implements, at the values it implements
PATHS = {"nettype": "resnet", "add_dcn": False}


def program(cfg: dict, device):
    from lsfa_tpu_torch.models.fgfa import fgfa_from_config

    pcfg = program_config(cfg)
    return fgfa_from_config(pcfg, device=device), pcfg


def reference(cfg: dict, prec: ref.Precision, device) -> ref_fgfa.FGFA:
    return ref_fgfa.FGFA(prec=prec, device=device, **ref.net_args(cfg, PATHS))


def flops_per_frame(net, cfg: dict) -> float:
    """One frame: its trunk and feature conv (once a frame), then its
    window of 2K + 1 (K = TEST.KEY_FRAME_INTERVAL): 2K FlowNet-S pairs,
    2K + 1 embeddings and the heads."""
    bh, bw = cfg["tpu"]["default_bucket"]
    stride = cfg["network"]["RPN_FEAT_STRIDE"]
    fh, fw, c = bh // stride, bw // stride, cfg["network"]["DFF_FEAT_DIM"]
    s = 2 * cfg["TEST"]["KEY_FRAME_INTERVAL"]
    meta = dict(device="meta")
    feat = count(lambda: net.forward_feat(torch.empty(1, bh, bw, 3, dtype=torch.uint8, **meta)))
    window = count(lambda: net.detection_maps(net.aggregate(
        torch.empty(1, 3, bh, bw, **meta), torch.empty(1, c, fh, fw, **meta),
        torch.empty(s, 3, bh, bw, **meta), torch.empty(s, c, fh, fw, **meta))))
    return float(feat + window)
