"""Achieved-vs-peak FLOP and memory-traffic accounting (MFU) of the port's
programs on one card.

The counterpart of the repo-level ``tools/report_mfu.py``. For each
program the runtime runs, the key step (``forward_key`` and the
detection of one frame), the non-key batch (``forward_cur`` and the
detection of a GOP's 11 frames), a window of G GOPs
(``StreamingDetector.process_gops``) and the train step
(``make_train_step``), it counts one call's work, times the call, and
reports achieved TFLOP/s and GB/s, their shares of the card's peaks and
the roofline side.

The count is the eager program's, with no fusion:
- FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over one call (the
  convolutions as 2 x MACs, the deformable conv's matmul, the PSROI
  contractions), plus the NMS kernel's ``nms_cuda.nms_flops`` per call
  (16 float32 operations per pair of the strict upper triangle); the
  NMS itself runs with counting off, so the count is the same on the
  card (the kernel) and on the CPU (its plain version);
- bytes: the input and output tensors of every aten op that is not a
  view, summed under a TorchDispatchMode, plus ``nms_cuda.nms_bytes``
  per NMS call.
The peaks are keyed by the card's name: the H100 SXM's dense bf16 989
TFLOP/s and 3.35 TB/s HBM3 (NVIDIA data sheet, at the 700 W limit; the
card's limit is printed beside them). The bf16 peak is the yardstick
although the frozen BatchNorm and the casts run in float32 off the
tensor cores. On another card or the CPU only absolute numbers are given.

    python -m lsfa_tpu_torch.tools.report_mfu [--out FILE] [--gops 2]
        [--trials 20] [--tiny] [--skip-train] [--device cpu]

Prints one JSON line; on ``--device cpu`` every metric name starts with
``cpu_smoke_`` and the shares are null.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from lsfa_tpu_torch.bench import _build_detector, bench_config, tiny_config
from lsfa_tpu_torch.eval.detector import detect_batch
from lsfa_tpu_torch.ops import nms, nms_cuda
from lsfa_tpu_torch.tools import bench_train
from lsfa_tpu_torch.train.train_step import draw_uniforms
from lsfa_tpu_torch.utils.profiler import (CPU_PREFIX, device_info, labelled, sync, timed_ms,
                                           tool_device)

# (dense bf16 FLOP/s, HBM bytes/s) by card name (NVIDIA data sheets)
PEAKS = {"H100 80GB HBM3": (989e12, 3.35e12)}       # H100 SXM
NOTE = ("FLOPs and bytes of the eager program (no fusion: every aten op's inputs and outputs "
        "count as traffic); the dense bf16 peak is the yardstick although the frozen "
        "BatchNorm and the casts run in float32 off the tensor cores")


def device_peaks(device):
    """(name, peak FLOP/s, peak bytes/s) of the card, (name, None, None)
    for a card not in PEAKS and for the CPU."""
    name = device_info(device)["name"]
    for key, (f, b) in PEAKS.items():
        if key in name:
            return name, f, b
    return name, None, None


class _Bytes(TorchDispatchMode):
    """Sums the bytes of every aten op's tensor inputs and outputs; a view
    (an output that aliases an input without writing it) moves none."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        rets = func._schema.returns
        if not (rets and all(r.alias_info is not None and not r.alias_info.is_write
                             for r in rets)):
            for t in tree_flatten((args, kwargs, out))[0]:
                if isinstance(t, torch.Tensor):
                    self.total += t.numel() * t.element_size()
        return out


@contextlib.contextmanager
def counting():
    """Context: count the FLOPs and bytes of what runs inside; yields a
    dict filled on exit with "flops", "bytes" and "nms_calls" [(B, N)].
    Each NMS fixpoint runs with counting off and adds the kernel's own
    analytic count."""
    got = {"nms_calls": []}
    alive = nms._alive

    def counted_alive(boxes, valid, *args, **kw):
        got["nms_calls"].append(tuple(valid.shape))
        with _disable_current_modes():
            return alive(boxes, valid, *args, **kw)

    nms._alive = counted_alive
    try:
        with FlopCounterMode(display=False) as flops, _Bytes() as moved:
            yield got
    finally:
        nms._alive = alive
    calls = got["nms_calls"]
    got["flops"] = flops.get_total_flops() + sum(nms_cuda.nms_flops(b, n) for b, n in calls)
    got["bytes"] = moved.total + sum(nms_cuda.nms_bytes(b, n) for b, n in calls)


def count(fn) -> dict:
    """`counting` over one call of fn()."""
    with counting() as got:
        fn()
    return got


def entry(name, counted, sec, peak_f, peak_b, frames=None) -> dict:
    """The row of one program: JAX's keys."""
    flops, bytes_ = counted["flops"], counted["bytes"]
    ai = flops / bytes_ if bytes_ else float("inf")
    row = {"ms": sec * 1e3, "gflop": flops / 1e9, "hbm_gb": bytes_ / 1e9,
           "achieved_tflops": flops / sec / 1e12, "achieved_hbm_gbps": bytes_ / sec / 1e9,
           "arith_intensity_flop_per_byte": ai, "nms_calls": counted["nms_calls"]}
    if frames:
        row["ms_per_frame"] = sec * 1e3 / frames
    row["mfu_pct"] = row["hbm_util_pct"] = row["roofline"] = None
    if peak_f:
        row["mfu_pct"] = 100 * flops / sec / peak_f
        row["hbm_util_pct"] = 100 * bytes_ / sec / peak_b
        row["roofline"] = ("compute-bound (ai >= ridge)" if ai >= peak_f / peak_b
                           else "memory-bound (ai < ridge)")
    print(f"{name:>18}: {row['ms']:8.2f} ms  {row['gflop']:9.2f} GFLOP  {row['hbm_gb']:7.3f} GB  "
          f"{row['achieved_tflops']:6.2f} TF/s"
          + (f"  MFU {row['mfu_pct']:5.2f}%  HBM {row['hbm_util_pct']:5.2f}%  [{row['roofline']}]"
             if peak_f else ""), file=sys.stderr, flush=True)
    return row


def programs(det, cfg, gops: int):
    """{name: (fn, frames)} of the inference programs on seeded inputs (JAX's
    report's: seed 0, im_info [600, W, 1])."""
    model, dev = det.model, det.device
    h, w = det.image_hw
    fh, fw = det.feat_hw
    n = cfg.TEST.KEY_FRAME_INTERVAL - 1
    rnd = np.random.default_rng(0)

    def put(x):
        return torch.from_numpy(x).to(dev)

    key = put(rnd.integers(0, 255, (1, h, w, 3), dtype=np.uint8))
    smalls = put(rnd.integers(0, 255, (n, h // 4, w // 4, 3), dtype=np.uint8))
    mv = put(rnd.normal(0, 1, (n, fh, fw, 2)).astype(np.float32))
    res = put(rnd.normal(0, 8, (n, fh, fw, 3)).astype(np.float32))
    im_info = torch.tensor([[600.0, float(w), 1.0]], device=dev)
    keys = put(rnd.integers(0, 255, (gops, 1, h, w, 3), dtype=np.uint8))
    g_smalls = put(rnd.integers(0, 255, (gops, n, h // 4, w // 4, 3), dtype=np.uint8))
    g_mvs = put(rnd.normal(0, 1, (gops, n, fh, fw, 2)).astype(np.float32))
    g_ress = put(rnd.normal(0, 8, (gops, n, fh, fw, 3)).astype(np.float32))
    det.reset()
    with torch.no_grad():
        feat = model.forward_key(key, det.data_key, det.feat_key,
                                 torch.ones(1, device=dev))["feat"]
    feats = feat.expand((n,) + tuple(feat.shape[1:]))

    def key_step():
        out = model.forward_key(key, det.data_key, det.feat_key, torch.ones(1, device=dev))
        return detect_batch(out, det.anchors, im_info, **det.det_kw)

    def cur_batch():
        return detect_batch(model.forward_cur(smalls, feats, mv, res), det.anchors, im_info[0],
                            **det.det_kw)

    def window():
        det.reset()
        return det.process_gops(keys, g_smalls, g_mvs, g_ress, im_info, first=True)

    return {"key_step": (key_step, 1), f"cur_batch_x{n}": (cur_batch, n),
            f"scan_window_G{gops}": (window, gops * cfg.TEST.KEY_FRAME_INTERVAL)}


def train_program(cfg, device):
    """(step fn, batch size) of the train step at batch 1 (bench_train's
    model, optimizer at lr 1e-5 and synthetic batch)."""
    args = bench_train.parse_args(["--device", str(device.type)])
    b = bench_train.build(args, cfg)
    gen = b["generator"]

    def step():
        return b["step"](b["batch"], draw_uniforms(b["settings"], b["batch"], gen))

    return step, args.batch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="FLOP and byte accounting of the port's programs")
    ap.add_argument("--out", default=None, help="also write the report (JSON) here")
    ap.add_argument("--gops", type=int, default=2)
    ap.add_argument("--trials", type=int, default=20)
    ap.add_argument("--tiny", action="store_true", help="resnet18/64ch tiny config (CPU smoke)")
    ap.add_argument("--skip-train", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(sys.argv[1:] if argv is None else list(argv))


def main(argv=None) -> dict:
    """Count, time and report every program; print and return the JSON
    result."""
    args = parse_args(argv)
    device = tool_device(args.device)
    cfg = tiny_config() if args.tiny else bench_config()
    kind, peak_f, peak_b = device_peaks(device)
    info = device_info(device)
    print(f"device: {kind} at {info['power_limit_w']} W; peak "
          f"{peak_f and peak_f / 1e12} TF/s, {peak_b and peak_b / 1e9} GB/s", file=sys.stderr,
          flush=True)
    cfg, det = _build_detector(cfg, device)
    h, w = det.image_hw
    rows = {}
    with torch.no_grad():
        for name, (fn, frames) in programs(det, cfg, args.gops).items():
            counted = count(fn)
            sec = timed_ms(fn, device, args.trials) / 1e3
            rows[name] = entry(name, counted, sec, peak_f, peak_b, frames)
    name = f"scan_window_G{args.gops}"
    rows[name]["device_fps"] = args.gops * cfg.TEST.KEY_FRAME_INTERVAL / (rows[name]["ms"] / 1e3)
    if not args.skip_train:
        step, bt = train_program(cfg, device)
        step()                                        # the optimizer's state
        counted = count(step)
        sync(device)
        k = max(5, args.trials // 2)
        t0 = time.perf_counter()
        for _ in range(k):                            # chained, as a training loop runs
            step()
        sync(device)
        sec = (time.perf_counter() - t0) / k
        rows[f"train_step_b{bt}"] = entry(f"train_step_b{bt}", counted, sec, peak_f, peak_b)
        rows[f"train_step_b{bt}"]["steps_per_s"] = 1.0 / sec
    report = labelled({
        "metric": "lsfa_mfu",
        "unit": (f"per program: ms per call "
                 f"({'CUDA events' if device.type == 'cuda' else 'host clock'}, median of "
                 f"{args.trials}; the train step chained, host clock), GFLOP and GB per call, "
                 f"shares of the peaks in percent ({h}x{w}, {cfg.tpu.compute_dtype}, windows "
                 f"of {args.gops} GOPs)"),
        "note": NOTE, "peak_tflops": peak_f and peak_f / 1e12,
        "peak_hbm_gbps": peak_b and peak_b / 1e9, "bucket": [h, w],
        "gops_per_window": args.gops, "key_interval": cfg.TEST.KEY_FRAME_INTERVAL,
        "programs": rows}, device, ("programs",))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fo:
            json.dump(report, fo, indent=1)
    print(json.dumps(report), flush=True)
    return report


def program_rows(report: dict) -> dict:
    """The programs' rows of a report, on the card or the CPU."""
    return report.get("programs", report.get(CPU_PREFIX + "programs"))


if __name__ == "__main__":
    main()
