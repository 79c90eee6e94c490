"""Per-component timing of the port's LSFA inference path on one card.

The counterpart of the repo-level ``tools/profile_breakdown.py``: the
flagship at its bucket from seeded weights, each component timed alone
with CUDA events (median of --reps calls after a warm-up), to direct
kernel work: the backbone with feat_conv, FlowNet-S, the key forward
without and with detection, the non-key forward of a GOP's 11 frames;
then the detection pieces on seeded maps: RPN proposals with their NMS
(the config's pre_nms, 6000, and no tier), PSROI pooling of the class map, the 30-class
NMS of 300 boxes, the proposals at the config's tier and the detection
of 12 frames at the tier.

``--trace DIR`` profiles one GOP's work (the key forward with detection
and the 11 non-key frames with theirs) with ``torch.profiler``, writes a
Chrome trace into DIR and prints the top kernels by device time and the
device's busy share of the window. Prints one JSON line. It runs on the
card; ``--device cpu`` times with the host clock, and then every metric
name starts with ``cpu_smoke_``.

    python -m lsfa_tpu_torch.tools.profile_breakdown [--reps N] [--trace DIR]
        [--cfg JSON] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from lsfa_tpu_torch.bench import _build_detector, bench_config
from lsfa_tpu_torch.eval.detector import detect_batch, detect_from_maps
from lsfa_tpu_torch.models.rfcn import nchw, nhwc
from lsfa_tpu_torch.ops.nms import nms_fixed
from lsfa_tpu_torch.ops.proposal import rpn_proposals
from lsfa_tpu_torch.ops.psroi_pool import psroi_pool
from lsfa_tpu_torch.utils.profiler import labelled, profile_window, timed_ms, tool_device


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="per-component timing of LSFA inference")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--trace", default=None, help="write a torch.profiler trace of a GOP here")
    ap.add_argument("--cfg", default=None, help="JSON config (default: the flagship)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(sys.argv[1:] if argv is None else list(argv))


def components(det, cfg):
    """{name: fn} of the timed components on seeded inputs at the
    detector's bucket, and the GOP's work for a trace."""
    model, dev, kw = det.model, det.device, det.det_kw
    h, w = det.image_hw
    fh, fw = det.feat_hw
    n_cur = cfg.TEST.KEY_FRAME_INTERVAL - 1
    classes = cfg.dataset.NUM_CLASSES
    a = cfg.network.NUM_ANCHORS
    rnd = np.random.default_rng(0)

    def put(x):
        return torch.from_numpy(x).to(dev)

    frame = put(rnd.integers(0, 255, (1, h, w, 3), dtype=np.uint8))
    smalls = put(rnd.integers(0, 255, (n_cur, h // 4, w // 4, 3), dtype=np.uint8))
    mv = put(rnd.normal(0, 1.5, (n_cur, fh, fw, 2)).astype(np.float32))
    res = put(rnd.normal(0, 8, (n_cur, fh, fw, 3)).astype(np.float32))
    im_info = torch.tensor([[600.0, 936.0, 1.6]], device=dev)
    first = torch.zeros(1, device=dev)
    with torch.no_grad():
        old_img = model.preprocess(frame)
        feat = nhwc(model.conv_feat(nchw(old_img))).float()
    feats = feat.expand((n_cur,) + tuple(feat.shape[1:]))
    fg = put(rnd.uniform(0, 1, (1, fh, fw, a)).astype(np.float32))
    deltas = put(rnd.normal(0, 0.2, (1, fh, fw, 4 * a)).astype(np.float32))
    cls_map = put(rnd.normal(0, 1, (1, fh, fw, classes * 49)).astype(np.float32))
    bbox_map = put(rnd.normal(0, 1, (1, fh, fw, 8 * 49)).astype(np.float32))
    with torch.no_grad():
        rois = rpn_proposals(fg, deltas, det.anchors, im_info, pre_nms_top_n=kw["pre_nms"])[0]
    # sorted coordinates make x1 <= x2 and y1 <= y2
    boxes = put(rnd.uniform(0, 500, (1, 300, 4)).astype(np.float32)).sort(-1)[0]
    boxes = boxes.expand(classes - 1, 300, 4)
    scores = put(rnd.uniform(0, 1, (1, 300)).astype(np.float32)).expand(classes - 1, 300)
    maps12 = {"rpn_fg": fg.expand(12, -1, -1, -1), "rpn_deltas": deltas.expand(12, -1, -1, -1),
              "rfcn_cls_map": cls_map.expand(12, -1, -1, -1),
              "rfcn_bbox_map": bbox_map.expand(12, -1, -1, -1)}

    def gop():
        kout = model.forward_key(frame, old_img, feat, first)
        detect_from_maps(kout, det.anchors, im_info, **kw)
        cout = model.forward_cur(smalls, feats, mv, res)
        detect_batch(cout, det.anchors, im_info[0], **kw)

    return {
        "backbone_featconv": lambda: model.conv_feat(nchw(model.preprocess(frame))),
        "flownet": lambda: model.flownet(nchw(old_img), nchw(old_img)),
        "key_fwd_no_det": lambda: model.forward_key(frame, old_img, feat, first)["feat"],
        "key_fwd_det": lambda: detect_from_maps(
            model.forward_key(frame, old_img, feat, first), det.anchors, im_info, **kw),
        f"cur_fwd_no_det_x{n_cur}": lambda: model.forward_cur(smalls, feats, mv, res)["feat"],
        f"rpn_proposal_nms_pre{kw['pre_nms']}": lambda: rpn_proposals(
            fg, deltas, det.anchors, im_info, pre_nms_top_n=kw["pre_nms"]),
        "psroi_pool_cls": lambda: psroi_pool(cls_map, rois, classes),
        f"class_nms_x{classes - 1}": lambda: nms_fixed(boxes, scores, 0.3, 300),
        f"rpn_proposal_nms_tier{kw['nms_tier']}": lambda: rpn_proposals(
            fg, deltas, det.anchors, im_info, pre_nms_top_n=kw["pre_nms"],
            nms_tier=kw["nms_tier"]),
        "det_x12_tier": lambda: detect_batch(maps12, det.anchors, im_info[0], **kw),
    }, gop


def main(argv=None) -> dict:
    """Time each component; print and return the JSON result."""
    args = parse_args(argv)
    device = tool_device(args.device)
    cfg, det = _build_detector(bench_config(args.cfg), device)
    fns, gop = components(det, cfg)
    times = {}
    with torch.no_grad():
        for name, fn in fns.items():
            times[name] = timed_ms(fn, device, args.reps)
            print(f"{name:28s}: {times[name]:8.2f} ms", file=sys.stderr, flush=True)
        traced = None
        if args.trace:
            traced = profile_window(gop, device, args.trace)
            print(f"trace of one GOP: {traced}", file=sys.stderr, flush=True)
    h, w = det.image_hw
    result = labelled({
        "metric": "lsfa_component_ms",
        "unit": (f"ms per call, {'CUDA events' if device.type == 'cuda' else 'host clock'}, "
                 f"median of {args.reps} after a warm-up ({h}x{w}, "
                 f"{cfg.tpu.compute_dtype}, seeded weights and inputs)"),
        "components": times, "trace": traced}, device, ("components", "trace"))
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
