"""Ablate the detection stage of the port's key step to attribute its time.

The counterpart of the repo-level ``tools/profile_detection.py``: the
flagship's key forward, then cumulatively the RPN proposals (with their
NMS), the PSROI scoring and the per-class NMS with the global top-k, each
variant timed per call with CUDA events after a warm-up (median of
--reps), over the pre_nms ladder {6000, 2048, 1024} with no tier:

  fwd            forward only (the maps)
  +prop          + proposals, the RPN NMS over the top pre_nms boxes
  +psroi         + PSROI scoring
  full           + per-class NMS and top-k (the production detection)

At pre_nms 6000 the RPN NMS takes N = 6000 boxes, above
``ops.nms_cuda.FUSED_MAX_N``: the kernel's two-phase route. Prints one
JSON line. It runs on the card; ``--device cpu`` times with the host
clock, and then every metric name starts with ``cpu_smoke_``.

    python -m lsfa_tpu_torch.tools.profile_detection [--reps N] [--cfg JSON]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from lsfa_tpu_torch.bench import _build_detector, bench_config
from lsfa_tpu_torch.eval.detector import detect_batch
from lsfa_tpu_torch.ops.proposal import proposal_candidates, rpn_proposals
from lsfa_tpu_torch.ops.psroi_pool import psroi_pool
from lsfa_tpu_torch.utils.profiler import labelled, timed_ms, tool_device

PRE_NMS = (6000, 2048, 1024)
UPTO = ("prop", "psroi", "full")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="the key step's detection stage, cumulatively")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--cfg", default=None, help="JSON config (default: the flagship)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(sys.argv[1:] if argv is None else list(argv))


def key_inputs(det):
    """The key forward's seeded inputs at the detector's bucket: a BGR u8
    frame, the previous key frame preprocessed, a zero key feature, the
    stream-start flag 0, im_info (1, 3)."""
    h, w = det.image_hw
    fh, fw = det.feat_hw
    dev = det.device
    frame = torch.from_numpy(np.random.default_rng(0).integers(
        0, 255, (1, h, w, 3), dtype=np.uint8)).to(dev)
    with torch.no_grad():
        old_img = det.model.preprocess(frame)
    feat = torch.zeros((1, fh, fw, det.cfg.network.DFF_FEAT_DIM), device=dev)
    return (frame, old_img, feat, torch.zeros(1, device=dev),
            torch.tensor([[600.0, 936.0, 1.6]], device=dev))


def variant(det, pre_nms: int, upto: str):
    """fn() of the key forward and the detection up to `upto` (prop,
    psroi, full) at `pre_nms` with no tier."""
    frame, old_img, feat, first, im_info = key_inputs(det)
    kw = {**det.det_kw, "pre_nms": pre_nms, "nms_tier": 0}
    stride = kw["feat_stride"]

    def step():
        o = det.model.forward_key(frame, old_img, feat, first)
        if upto == "full":
            return detect_batch(o, det.anchors, im_info, **kw)
        rois, _, _ = rpn_proposals(o["rpn_fg"], o["rpn_deltas"], det.anchors, im_info,
                                   pre_nms_top_n=pre_nms, post_nms_top_n=kw["post_nms"],
                                   nms_thresh=kw["rpn_nms_thresh"], min_size=kw["min_size"],
                                   feat_stride=stride)
        if upto == "prop":
            return rois
        pc = psroi_pool(o["rfcn_cls_map"], rois, kw["num_classes"], spatial_scale=1.0 / stride)
        pb = psroi_pool(o["rfcn_bbox_map"], rois, 4 * kw["num_reg_classes"],
                        spatial_scale=1.0 / stride)
        return torch.softmax(pc.mean(dim=(2, 3)), dim=-1), pb.mean(dim=(2, 3))

    return step


def rpn_input(det, pre_nms: int = PRE_NMS[0]):
    """The RPN NMS input (boxes (1, N, 4), valid (1, N)) of the +prop
    variant at `pre_nms`: what the kernel gets at N = pre_nms."""
    frame, old_img, feat, first, im_info = key_inputs(det)
    kw = det.det_kw
    with torch.no_grad():
        o = det.model.forward_key(frame, old_img, feat, first)
        boxes, _, valid = proposal_candidates(o["rpn_fg"], o["rpn_deltas"], det.anchors,
                                              im_info, pre_nms, kw["min_size"])
    return boxes.contiguous(), valid


def main(argv=None) -> dict:
    """Time every variant; print and return the JSON result."""
    args = parse_args(argv)
    device = tool_device(args.device)
    cfg, det = _build_detector(bench_config(args.cfg), device)
    frame, old_img, feat, first, _ = key_inputs(det)
    times = {}
    with torch.no_grad():
        times["fwd"] = timed_ms(lambda: det.model.forward_key(frame, old_img, feat, first),
                                device, args.reps)
        for pre in PRE_NMS:
            for upto in UPTO:
                times[f"{upto}_pre{pre}"] = timed_ms(variant(det, pre, upto), device, args.reps)
    for name, ms in times.items():
        print(f"{name:16s}: {ms:8.2f} ms", file=sys.stderr, flush=True)
    h, w = det.image_hw
    result = labelled({
        "metric": "lsfa_key_detection_ms",
        "unit": (f"ms per call of the key forward and the detection up to each stage, "
                 f"{'CUDA events' if device.type == 'cuda' else 'host clock'}, median of "
                 f"{args.reps} after a warm-up ({h}x{w}, no NMS tier, seeded weights)"),
        "variants": times}, device, ("variants",))
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
