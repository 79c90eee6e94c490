"""LSFA: ResNet-101 with DCN, FlowNet-S warp and Nq-net on key frames,
motion-vector warp, R-net and the stride-4 small net on the rest
(``models/lsfa.py`` in the program, ``reference/model.py::LSFA`` here)."""

from __future__ import annotations

import torch

from benchmark.count_flops import count
from benchmark.kinds import program_config
from benchmark.reference import model as ref

# the network switches the reference implements, at the values it implements
PATHS = {"nettype": "resnet", "rnet_num_conv": 0, "fnet_type": "None", "fuse_type": "add",
         "res_diff_bn": False, "small_net_stride": 4, "small_net_fuse_type": "add",
         "small_net_bn_before_fuse": False, "small_net_scale_before_fuse": False,
         "add_Fgfa_net": False, "add_small_net": True, "add_Nq_net": True, "add_rnet": True,
         "add_lt_aggregation": True}


def program(cfg: dict, device):
    from lsfa_tpu_torch.models.lsfa import lsfa_from_config

    pcfg = program_config(cfg)
    return lsfa_from_config(pcfg, device=device), pcfg


def reference(cfg: dict, prec: ref.Precision, device) -> ref.LSFA:
    return ref.LSFA(prec=prec, device=device, **ref.net_args(cfg, PATHS))


def flops_per_frame(net, cfg: dict) -> float:
    """The mean over a GOP: one key step (I420 key frame, the carry) and
    KEY_FRAME_INTERVAL - 1 non-key frames (1/4 BGR, motion vectors and
    residuals)."""
    bh, bw = cfg["tpu"]["default_bucket"]
    stride = cfg["network"]["RPN_FEAT_STRIDE"]
    fh, fw, c = bh // stride, bw // stride, cfg["network"]["DFF_FEAT_DIM"]
    n = cfg["TEST"]["KEY_FRAME_INTERVAL"] - 1
    meta = dict(device="meta")
    key_in = torch.empty(1, bh * 3 // 2, bw, 1, dtype=torch.uint8, **meta)
    key = count(lambda: net.forward_key(key_in, torch.empty(1, bh, bw, 3, **meta),
                                                  torch.empty(1, fh, fw, c, **meta),
                                                  torch.zeros(1, **meta)))
    cur = count(lambda: net.forward_cur(
        torch.empty(n, bh // 4, bw // 4, 3, dtype=torch.uint8, **meta),
        torch.empty(n, fh, fw, c, **meta), torch.empty(n, fh, fw, 2, **meta),
        torch.empty(n, fh, fw, 3, **meta)))
    return float(key + cur) / (n + 1)
