#!/usr/bin/env python3
"""Smoke run of lsfa_tpu_torch on one NVIDIA card (sm_90a).

    python3 chip_smoke.py

Phases, each printing one line before the last:
  1. environment: torch/CUDA versions, the card's name and power limit;
  2. build: nvcc compiles the NMS fixpoint kernel from the checkout;
  3. kernel vs plain: the kernel's alive masks and converged flags equal
     the plain version's bit for bit on the four streaming shapes (1, 2048)
     t=0.7, (30, 300) t=0.3, (11, 2048) t=0.7, (330, 300) t=0.3, the RPN
     stand-in (12, 2048), suppression chains at B = 1, the odd cap 1, a
     cut valid mask, ragged N, N = 1, the two-phase N = 2049 and 8192,
     and knife-edge pairs whose float32 IoU lies within 2 ulps of t;
     checks that N <= 2048 allocates no scratch (torch.cuda memory
     statistics); median times per call of kernel and plain version, the
     bound and the share of the bound at the timed shapes;
  4. main path: the flagship LSFA (ResNet-101 with DCN, FlowNet-S, Nq-net,
     R-net, small net) at full width, random weights from a seed, bf16,
     through StreamingDetector over 3 GOPs (36 frames) of seeded I420
     payloads at the 608x1024 bucket; checks detection shapes and
     finiteness, the float32 carry, that the main path launched the
     kernel 4 times per GOP, and that the kernel's mask equals the plain
     version's on the last key frame's real RPN input;
  5. small-input reference: the tiny config in float32 on the card (with
     the kernel) against the same weights on the CPU (plain version);
  6. train path: the flagship at full width (bf16 compute, float32
     parameters), random init from a seed, through train_net over 4 seeded
     synthetic batches at 608x1024 (B = 1, one key pair, 1-10 gt boxes);
     checks finite metrics on every step, exactly one kernel launch per
     step, frozen parameters bit-unchanged and trainable ones moved, and
     the kernel's mask equal to the plain version's on the last step's
     real RPN input; prints ms per step after the first, peak memory and
     host syncs after the first step;
  7. small train step: the tiny config in float32, 2 steps on the card
     (kernel) and on the CPU (plain version) from the same weights, batches
     and uniform draws: metrics within 1e-4 relative, parameters within
     1e-5, running statistics within 1e-4 of max(1, |x|);
  8. R-FCN serving: the single-frame R-FCN of configs/rfcn_resnet101_vid.yaml
     (ResNet-101 without DCN, feat 1024, bf16) at full width, random weights
     from a seed, through RFCNDetector.detect over 12 seeded BGR u8 frames
     at 608x1024; checks (300, 6) finite detections with some valid, two
     kernel launches per frame (RPN and per-class NMS), no host sync flagged
     after the first frame, and the kernel's mask equal to the plain
     version's on the last frame's real RPN input; prints ms per frame and
     frames/s after the first;
  9. R-FCN training: the same R-FCN through train_net over 4 seeded
     synthetic batches (the checks and prints of phase 6);
 10. train-mode BatchNorm: the flagship with res_diff_bn and
     small_net_bn_before_fuse, 2 steps of train_net (the checks of phase 6,
     and the three BatchNorms' running statistics moved with their scale
     and bias unchanged), then the tiny config with both variants card vs
     CPU as in phase 7, running statistics included;
 11. per frame: the tiny float32 LSFA on the card gives through
     StreamingDetector.process_frame, frame by frame over 2 GOPs, the
     valid masks and (within 1e-4) sorted scores of
     process_prepared_window;
 12. scoring: collect_detections and vid_eval over phase 8's detections
     against seeded gt boxes (a finite mAP in [0, 1]), and the gt planted
     as detections (mAP 1.0);
 13. profiled: the R-FCN frame and train step, host enqueue against wall
     time, then their device time, kernels per call and top kernels under
     torch.profiler; torch.profiler shows that each phase 3 case's call
     runs one kernel for N <= 2048 and two above, and gives the kernel's
     device time
     at the timed shapes, also with num_sweeps = 0 (the build and one test
     sweep), which splits build from sweeps (run last: a profiled window
     slows later host launches).
Then one JSON line for the kernels and, last, the result line. Any failed
phase exits non-zero before the result line is printed.
"""

import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
GOP = 12
BUCKET = (608, 1024)
CONTENT = (600, 1000)                 # resized frame inside the bucket
# configs/rfcn_resnet101_vid.yaml as overrides (the card's machine has no
# yaml); a CPU test holds the two equal
RFCN_OVERRIDES = {
    "output_path": "./output/rfcn_tpu/imagenet_vid",
    "symbol": "rfcn_resnet101",
    "SCALES": [[600, 1000]],
    "network": {"pretrained": "resnet-101", "num_layer": 101, "add_dcn": False,
                "add_small_net": False, "add_Nq_net": False},
    "dataset": {"dataset": "ImageNetVID", "dataset_path": "./data/ILSVRC2015",
                "image_set": "DET_train_30classes+VID_train_15frames",
                "test_image_set": "VID_val_frames", "NUM_CLASSES": 31},
    "TRAIN": {"lr": 0.00025, "lr_step": "1.333", "end_epoch": 2, "ENABLE_OHEM": True,
              "BATCH_IMAGES": 1, "BATCH_ROIS": -1, "BATCH_ROIS_OHEM": 128,
              "RPN_POST_NMS_TOP_N": 300, "RPN_MIN_SIZE": 0},
    "TEST": {"NMS": 0.3, "RPN_MIN_SIZE": 0, "test_epoch": 2},
    "tpu": {"compute_dtype": "bfloat16", "default_bucket": [608, 1024],
            "image_buckets": [[608, 1024], [1024, 608], [608, 960]]},
}
BN_VARIANTS = {"res_diff_bn": True, "small_net_bn_before_fuse": True}


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def cuda_ms(fn, reps=20):
    """Median milliseconds of fn() on the card, by CUDA events, after a
    warm-up call."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def sorted_boxes(rng, n):
    """n random boxes in a 1000x600 frame, in rank order."""
    x1 = rng.uniform(0, 1000, n)
    y1 = rng.uniform(0, 600, n)
    w = rng.uniform(1, 200, n)
    h = rng.uniform(1, 200, n)
    return np.stack([x1, y1, x1 + w, y1 + h], axis=1).astype(np.float32)


def chain_boxes(n):
    """Box i suppresses box i + 1 only at thresh 0.5: a chain of n."""
    x = np.arange(n, dtype=np.float32) * 6.0
    return np.stack([x, np.zeros(n, np.float32), x + 20.0, np.full(n, 20.0, np.float32)],
                    axis=1)[None]


def float32_iou(a, b):
    """IoU of float32 boxes a and b (..., 4) in the plain version's
    operation order, with numpy's float32 arithmetic."""
    one = np.float32(1.0)
    iw = np.minimum(a[..., 2], b[..., 2]) - np.maximum(a[..., 0], b[..., 0]) + one
    ih = np.minimum(a[..., 3], b[..., 3]) - np.maximum(a[..., 1], b[..., 1]) + one
    inter = np.maximum(iw, np.float32(0)) * np.maximum(ih, np.float32(0))
    area_a = (a[..., 2] - a[..., 0] + one) * (a[..., 3] - a[..., 1] + one)
    area_b = (b[..., 2] - b[..., 0] + one) * (b[..., 3] - b[..., 1] + one)
    union = area_a + area_b - inter
    return inter / np.maximum(union, np.float32(1e-10))


def knife_edge_boxes(rng, batch: int, n: int, iou_thresh: float, ulps: int = 2):
    """(batch, n, 4) float32 rank-ordered boxes made of pairs (2k, 2k + 1)
    whose float32 IoU lies within `ulps` float32 steps of float32(thresh),
    on both sides of it and on it: integer pairs whose IoU rounds to t
    exactly, then b's right edge moved by a few float32 steps. The x
    coordinates stay below 64, where a step moves the IoU by about one of
    its own steps; pair k sits in the band y in [64 k, 64 k + 64), so no
    two pairs overlap (integer y keeps the IoU exact under that shift)."""
    t = np.float32(iou_thresh)
    want = batch * (n // 2)
    found, count = [], 0
    while count < want:
        m = 1 << 16
        xy = rng.integers(0, 8, (m, 2)).astype(np.float32)
        wh = rng.integers(8, 48, (m, 2)).astype(np.float32)
        a = np.concatenate([xy, xy + wh], axis=1)
        bb = a + rng.integers(-8, 9, (m, 4)).astype(np.float32)
        bb[:, 2:] = np.maximum(bb[:, 2:], bb[:, :2])
        on = float32_iou(a, bb) == t
        a, bb = a[on], bb[on]
        k = rng.integers(-6, 7, len(a)).astype(np.int32)
        bb[:, 2] = (bb[:, 2].view(np.int32) + k).view(np.float32)
        keep = np.abs(float32_iou(a, bb).view(np.int32) - t.view(np.int32)) <= ulps
        found.append(np.stack([a[keep], bb[keep]], axis=1))
        count += int(keep.sum())
    pairs = np.concatenate(found)[:want].reshape(batch, n // 2, 2, 4)
    band = np.float32(64.0) * np.arange(n // 2, dtype=np.float32)
    pairs[..., 1] += band[:, None]
    pairs[..., 3] += band[:, None]
    out = np.zeros((batch, n, 4), np.float32)
    out[:, :2 * (n // 2)] = pairs.reshape(batch, -1, 4)
    if n % 2:                            # a lone last box, in a band of its own
        out[:, -1] = [0.0, 64.0 * (n // 2), 16.0, 64.0 * (n // 2) + 16.0]
    return out


def kernel_cases(rng):
    """(name, boxes (B, N, 4), valid (B, N), thresh, sweeps, timed). The
    first two draw the inputs of the earlier slices' timings."""
    def stack(b, n):
        return np.stack([sorted_boxes(rng, n) for _ in range(b)])

    cut = np.ones((4, 512), bool)
    cut[:, 100:] = False
    return [
        ("rpn (12, 2048)", stack(12, 2048), rng.uniform(size=(12, 2048)) < 0.95, 0.7, 31, True),
        ("per-class (330, 300)", stack(330, 300), rng.uniform(size=(330, 300)) < 0.8, 0.3, 31,
         True),
        ("chain n=128 cap n", chain_boxes(128), np.ones((1, 128), bool), 0.5, 128, False),
        ("odd cap 1", stack(4, 256), np.ones((4, 256), bool), 0.6, 1, False),
        ("valid cut at 100", stack(4, 512), cut, 0.5, 16, False),
        ("N=300 ragged", stack(7, 300), np.ones((7, 300), bool), 0.5, 31, False),
        ("stream RPN key (1, 2048)", stack(1, 2048), rng.uniform(size=(1, 2048)) < 0.95, 0.7, 31,
         True),
        ("stream per-class key (30, 300)", stack(30, 300), rng.uniform(size=(30, 300)) < 0.8, 0.3,
         31, True),
        ("stream RPN non-key (11, 2048)", stack(11, 2048), rng.uniform(size=(11, 2048)) < 0.95,
         0.7, 31, True),
        ("chain B=1 n=2048 cap 31", chain_boxes(2048), np.ones((1, 2048), bool), 0.5, 31, False),
        ("N=1", stack(3, 1), np.ones((3, 1), bool), 0.7, 31, False),
        ("N=2049 two-phase", stack(2, 2049), np.ones((2, 2049), bool), 0.7, 31, False),
        ("N=8192 two-phase", stack(1, 8192), rng.uniform(size=(1, 8192)) < 0.9, 0.7, 31, False),
        ("knife edge t=0.7 (2, 2048)", knife_edge_boxes(rng, 2, 2048, 0.7),
         np.ones((2, 2048), bool), 0.7, 31, False),
        ("knife edge t=0.3 (30, 300)", knife_edge_boxes(rng, 30, 300, 0.3),
         np.ones((30, 300), bool), 0.3, 31, False),
        ("knife edge t=0.5 (1, 2048)", knife_edge_boxes(rng, 1, 2048, 0.5),
         np.ones((1, 2048), bool), 0.5, 31, False),
        ("knife edge t=0.6 (2, 2049)", knife_edge_boxes(rng, 2, 2049, 0.6),
         np.ones((2, 2049), bool), 0.6, 31, False),
    ]


# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores, HBM3
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
FLOPS_PER_PAIR = 16     # two extents 8, intersection 3, union and clamp 3, divide 1, compare 1


def nms_bound_ms(b, n):
    """The least time of the fixpoint on an H100: one IoU test per pair of
    the strict upper triangle at FLOPS_PER_PAIR float32 operations, against
    boxes and valid read once and alive and converged written once.
    Returns (ms, "operations" or "bytes")."""
    ops = FLOPS_PER_PAIR * b * n * (n - 1) / 2
    moved = b * n * 16 + b * n + b * n + b
    t_ops, t_bytes = ops / PEAK_F32, moved / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def device_kernels(fn, reps=1, top=0):
    """Names of the device kernels that `reps` calls of fn() ran and their
    device time per call (us), from torch.profiler; with top > 0 also the
    `top` kernel names (cut to 60 characters) that took the most device
    time, each with its share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.time_range.elapsed_us() for e in events)
    if not top:
        return [e.name for e in events], total / reps
    by_name = {}
    for e in events:
        name = e.name.removeprefix("void ")[:60]
        by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us()
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return [e.name for e in events], total / reps, [(n, us / total) for n, us in ranked]


def synth_payloads(rng, n_gops, bucket=BUCKET, content=CONTENT, scale=600 / 576):
    """Seeded stand-ins for PreparedVideo.gop tuples: I420 u8 frames and
    1/4 smalls padded with Y=16, U=V=128 past the content, MV (dx, dy)
    fields of a few cells, residuals, im_info."""
    bh, bw = bucket
    ch, cw = content
    fh, fw = bh // 16, bw // 16
    out = []
    for _ in range(n_gops):
        parts = []
        for h, w, c_h, c_w in ((bh, bw, ch, cw), (bh // 4, bw // 4, ch // 4, cw // 4)):
            y = np.full((GOP, h, w), 16, np.uint8)
            y[:, :c_h, :c_w] = rng.integers(16, 236, (GOP, c_h, c_w), dtype=np.uint8)
            uv = np.full((2, GOP, h // 2, w // 2), 128, np.uint8)
            uv[:, :, :c_h // 2, :c_w // 2] = rng.integers(
                64, 192, (2, GOP, c_h // 2, c_w // 2), dtype=np.uint8)
            planes = [y, uv[0].reshape(GOP, h // 4, w), uv[1].reshape(GOP, h // 4, w)]
            parts.append(np.concatenate(planes, axis=1)[..., None])
        mv = rng.normal(0, 2.0, (GOP, fh, fw, 2)).astype(np.float32)
        res = rng.normal(0, 10, (GOP, fh, fw, 3)).astype(np.float32)
        info = np.asarray([ch, cw, scale], np.float32)
        out.append((parts[0], parts[1], mv, res, info))
    return out


def spread_heads(model, seed):
    """Redraw the RPN score and R-FCN heads at std 0.05: at the N(0, 0.01)
    init their outputs are near-uniform, and float noise between two
    devices would reorder proposals and OHEM losses."""
    import torch

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for conv in (model.rpn_cls_score, model.rfcn_cls, model.rfcn_bbox):
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=g) * 0.05)


def calibrate_input_bn(model):
    """Set every input BN's statistics (bn_data) to a trained trunk's: those
    of the frames' raw BGR values (uniform u8, mean 127.5, std 73.9); at
    mean 0, var 1 a random trunk's features reach the hundreds and the
    losses 1e5."""
    import torch

    with torch.no_grad():
        for name, bn in model.named_modules():
            if name.endswith("bn_data"):
                bn.running_mean.fill_(127.5)
                bn.running_var.fill_(73.9 ** 2)


def train_run(cfg, model, n_steps, nms_cuda, greedy_alive, still_ok=()):
    """train_net over n_steps seeded synthetic batches at the bucket
    (B = 1), the kernel recorded. Checks finite metrics on every step, one
    kernel launch per step, frozen parameters bit-unchanged, trainable
    ones (but `still_ok`) moved, and the kernel's mask equal to the plain
    version's on the last step's real RPN input. Returns a dict of what it
    measured."""
    import torch

    from lsfa_tpu_torch.data.loader import synthetic_train_batches
    from lsfa_tpu_torch.train.driver import train_net
    from lsfa_tpu_torch.train.schedule import frozen_names

    dev = next(model.parameters()).device
    before = {k: v.clone() for k, v in model.state_dict().items()}
    batches = synthetic_train_batches(n_steps, BUCKET, seed=3,
                                      num_classes=cfg.dataset.NUM_CLASSES,
                                      max_gt=cfg.tpu.max_gt_boxes, content_hw=CONTENT)
    steps, seen = [], {}
    kernel = nms_cuda.greedy_alive_cuda

    def recorded(boxes, valid, thresh, sweeps):
        """The kernel, keeping its last input and mask (device copies)."""
        alive, conv = kernel(boxes, valid, thresh, sweeps)
        seen.update(boxes=boxes.clone(), valid=valid.clone(), thresh=thresh,
                    sweeps=sweeps, alive=alive.clone())
        return alive, conv

    def hook(step, metrics):
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        steps.append((metrics, end, nms_cuda.LAUNCHES))
        if step == 0:                    # the first step initializes cuDNN/cuBLAS
            torch.cuda.set_sync_debug_mode("warn")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    nms_cuda.greedy_alive_cuda = recorded
    nms_cuda.LAUNCHES = 0
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            train_net(cfg, batches, max_steps=len(batches), metrics_hook=hook, model=model)
    finally:
        torch.cuda.set_sync_debug_mode("default")
        nms_cuda.greedy_alive_cuda = kernel
    torch.cuda.synchronize()
    launches = nms_cuda.LAUNCHES
    check(len(steps) == n_steps, f"train_net ran {len(steps)} steps, not {n_steps}")
    check([n for _, _, n in steps] == list(range(1, n_steps + 1)),
          f"kernel launches after each step {[n for _, _, n in steps]}, not one per step")
    for i, (m, _, _) in enumerate(steps):
        bad = [k for k, v in m.items() if not bool(torch.isfinite(v))]
        check(not bad, f"train step {i}: non-finite {bad}")
    ms = [start.elapsed_time(steps[0][1])] + [
        a[1].elapsed_time(b[1]) for a, b in zip(steps, steps[1:])]
    frozen = frozen_names(model)
    state = model.state_dict()
    params = dict(model.named_parameters())
    changed = [k for k in params if k in frozen and not torch.equal(state[k], before[k])]
    check(not changed, f"frozen parameters moved: {changed[:5]}")
    still = [k for k in params if k not in frozen and torch.equal(state[k], before[k])
             and k not in still_ok]
    check(not still, f"trainable parameters did not move: {still[:5]} ({len(still)})")
    want = greedy_alive(seen["boxes"], seen["valid"], seen["thresh"], seen["sweeps"])
    check(torch.equal(seen["alive"], want), "kernel != plain on the last train step's RPN input")
    args = (seen["boxes"], seen["valid"], seen["thresh"], seen["sweeps"])
    return dict(
        launches=launches, err=float((seen["alive"].int() - want.int()).abs().max()), ms=ms,
        peak=torch.cuda.max_memory_allocated(dev),
        syncs=sum("synchroniz" in str(w.message) for w in caught),
        frozen=len(frozen), trainable=len(params) - len(frozen), before=before,
        first={k: round(float(v), 4) for k, v in steps[0][0].items()},
        last={k: round(float(v), 4) for k, v in steps[-1][0].items()},
        rpn=(tuple(seen["boxes"].shape), int(want.sum()), int(seen["valid"].sum())),
        k_ms=cuda_ms(lambda: kernel(*args)), p_ms=cuda_ms(lambda: greedy_alive(*args)))


def train_line(name, r):
    """The printed account of a train_run."""
    shape, alive, valid = r["rpn"]
    after = statistics.mean(r["ms"][1:])
    return (f"{name}: ms per step {[round(x, 2) for x in r['ms']]} (first includes warm-up), "
            f"after the first {after:.2f} ms/step; peak memory {r['peak'] / 2**30:.2f} GiB; "
            f"nms kernel launches {r['launches']} (one per step); host syncs flagged after the "
            f"first step {r['syncs']}; {r['frozen']} frozen parameters unchanged, "
            f"{r['trainable']} trainable moved; first step {r['first']}; last step {r['last']}\n"
            f"{name}: kernel mask equals plain on the last step's RPN input {shape}: {alive} "
            f"alive of {valid} valid; kernel {r['k_ms'] * 1e3:.1f} us, plain "
            f"{r['p_ms'] * 1e3:.1f} us (median of 20)")


def tiny_train_card_vs_cpu(dev, nms_cuda, network=None):
    """The tiny config in float32 (with `network` overrides), 2 steps of
    B = 2 on the card (kernel) and on the CPU (plain version) from the same
    weights, batches and uniform draws: metrics within 1e-4 relative,
    parameters within 1e-5, BatchNorm running statistics within 1e-4 of
    max(1, |value|): a batch variance is E[x^2] - E[x]^2 in float32 (as in
    flax), which magnifies the card's and the CPU's float32 differences in
    the convolutions before it by E[x^2] / Var[x] (up to ~14 in the tiny
    fusion's BatchNorms). Returns the printed summary."""
    import torch

    from lsfa_tpu_torch.config import load_config
    from lsfa_tpu_torch.data.loader import batch_to_device, synthetic_train_batches
    from lsfa_tpu_torch.models.lsfa import lsfa_from_config
    from lsfa_tpu_torch.train.driver import init_model
    from lsfa_tpu_torch.train.schedule import make_optimizer
    from lsfa_tpu_torch.train.train_step import TrainSettings, make_train_step

    tiny = load_config(None, overrides={
        "network": {"num_layer": 18, "DFF_FEAT_DIM": 64, "ANCHOR_SCALES": [1, 2, 4],
                    **(network or {})},
        "TRAIN": {"RPN_POST_NMS_TOP_N": 64, "BATCH_ROIS_OHEM": 32, "RPN_BATCH_SIZE": 64},
        "tpu": {"compute_dtype": "float32", "max_gt_boxes": 8}})
    hw = (64, 112)
    cpu_model = init_model(tiny, rng_seed=3, device="cpu")
    spread_heads(cpu_model, 4)
    gpu_model = lsfa_from_config(tiny, device=dev)
    gpu_model.load_state_dict(cpu_model.state_dict())
    small = synthetic_train_batches(2, hw, seed=5, batch_images=2, max_gt=8, content_hw=(60, 104))
    for b in small:
        b["eq_flag_old"][:] = 0.0
    settings = TrainSettings.from_config(tiny)
    rng = np.random.default_rng(6)
    k = (hw[0] // 16) * (hw[1] // 16) * settings.num_anchors
    draws = [{n: torch.from_numpy(rng.uniform(size=(2, k)).astype(np.float32))
              for n in ("rpn_fg", "rpn_bg")} for _ in small]
    results = []
    nms_cuda.LAUNCHES = 0
    for m, d in ((cpu_model, "cpu"), (gpu_model, dev)):
        opt, sched = make_optimizer(m, tiny.TRAIN.lr, [1000])
        step = make_train_step(m, settings, opt, sched)
        mets = [step(batch_to_device(b, d), {n: u.to(d) for n, u in dr.items()})
                for b, dr in zip(small, draws)]
        results.append(([{n: float(v) for n, v in x.items()} for x in mets],
                        {n: p.detach().cpu() for n, p in m.named_parameters()},
                        {n: b.cpu() for n, b in m.named_buffers() if n.endswith(("_mean", "_var"))}))
    check(nms_cuda.LAUNCHES == 2, f"tiny card steps launched the kernel {nms_cuda.LAUNCHES} times")
    (cpu_m, cpu_p, cpu_s), (gpu_m, gpu_p, gpu_s) = results
    met_err = max(abs(g[n] - c[n]) / max(abs(c[n]), 1e-12)
                  for g, c in zip(gpu_m, cpu_m) for n in c)
    par_err = max(float((gpu_p[n] - cpu_p[n]).abs().max()) for n in cpu_p)
    stat_err, stat_name = max((float(((gpu_s[n] - cpu_s[n]).abs()
                                      / cpu_s[n].abs().clamp(min=1.0)).max()), n) for n in cpu_s)
    check(met_err < 1e-4, f"tiny train metrics card vs CPU differ by {met_err:.2e} relative")
    check(par_err < 1e-5, f"tiny train parameters card vs CPU differ by {par_err:.2e}")
    check(stat_err < 1e-4, f"tiny train running statistics card vs CPU differ by {stat_err:.2e} "
                           f"({stat_name})")
    return (f"2 steps of B=2 at {hw[0]}x{hw[1]}, card (kernel, 2 launches) vs CPU (plain): "
            f"metrics max rel err {met_err:.2e}, parameters max abs err {par_err:.2e}, running "
            f"statistics max err {stat_err:.2e} of max(1, |x|) ({stat_name}); last CPU step "
            f"{({n: round(v, 4) for n, v in cpu_m[-1].items()})}")


def train_phases(dev, nms_cuda, greedy_alive):
    """Phases 6 and 7. Returns (kernel launches of the flagship train run,
    max abs error of the kernel's mask against the plain version's)."""
    from lsfa_tpu_torch.config import get_default_config
    from lsfa_tpu_torch.train.driver import init_model

    # 6. the flagship train step at full width
    cfg = get_default_config()
    model = init_model(cfg, rng_seed=0, device=dev)
    calibrate_input_bn(model)
    # the Nq-net's last bias shifts both softmax logits alike: its gradient
    # cancels analytically and may round to exactly zero
    r = train_run(cfg, model, 4, nms_cuda, greedy_alive, still_ok=("nq_net.conv3.bias",))
    print(train_line(f"train path: LSFA ResNet-101 bf16 (float32 parameters) at {BUCKET[0]}x"
                     f"{BUCKET[1]}, B=1, 4 steps of train_net", r))
    launches, err = r["launches"], r["err"]
    del model, r

    # 7. small train step: card (kernel) vs CPU (plain), float32, same draws
    print(f"small train step: tiny LSFA float32, {tiny_train_card_vs_cpu(dev, nms_cuda)}")
    return launches, err


def rfcn_serving(dev, nms_cuda, greedy_alive):
    """Phase 8. Returns (kernel launches, max abs error of the kernel's
    mask against the plain version's, the 12 frames' detections)."""
    import torch

    from lsfa_tpu_torch.config import load_config
    from lsfa_tpu_torch.eval.rfcn_tester import RFCNDetector, rfcn_from_config
    from lsfa_tpu_torch.models.lsfa import init_params
    from lsfa_tpu_torch.ops.proposal import proposal_candidates

    cfg = load_config(None, overrides=RFCN_OVERRIDES)
    model = rfcn_from_config(cfg, device=dev)
    init_params(model, torch.Generator(device=dev).manual_seed(0))
    det = RFCNDetector(model, cfg, BUCKET)
    rng = np.random.default_rng(7)
    frames = np.zeros((12, 1) + BUCKET + (3,), np.uint8)
    frames[:, :, :CONTENT[0], :CONTENT[1]] = rng.integers(0, 256, (12, 1) + CONTENT + (3,),
                                                          dtype=np.uint8)
    info = np.asarray([[CONTENT[0], CONTENT[1], 600 / 576]], np.float32)
    torch.cuda.synchronize()
    nms_cuda.LAUNCHES = 0
    outs, enqueue, wall, counts, syncs = [], [], [], [], 0
    for i, frame in enumerate(frames):
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if i > 0:                       # the first frame initializes cuDNN/cuBLAS
                torch.cuda.set_sync_debug_mode("warn")
            out = det.detect(frame, info)
            torch.cuda.set_sync_debug_mode("default")
        enqueue.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
        counts.append(nms_cuda.LAUNCHES)
        syncs += sum("synchroniz" in str(w.message) for w in caught)
        outs.append(out)
    launches = nms_cuda.LAUNCHES
    check(counts == [2 * (i + 1) for i in range(len(frames))],
          f"kernel launches after each frame {counts}, not 2 per frame")
    check(syncs == 0, f"{syncs} host syncs flagged after the first frame")
    for dets, valid in outs:
        check(tuple(dets.shape) == (300, 6) and tuple(valid.shape) == (300,),
              f"detection shapes {tuple(dets.shape)}, {tuple(valid.shape)}")
        check(bool(torch.isfinite(dets).all()), "non-finite detections")
        check(int(valid.sum()) > 0, "no valid detections")
    # the kernel on the last frame's real RPN input
    with torch.no_grad():
        out = model(torch.from_numpy(frames[-1]).to(dev))
        boxes, _, valid = proposal_candidates(
            out["rpn_fg"], out["rpn_deltas"], det.anchors, torch.from_numpy(info).to(dev),
            cfg.TEST.RPN_PRE_NMS_TOP_N, cfg.TEST.RPN_MIN_SIZE, cfg.network.RPN_FEAT_STRIDE,
            cfg.tpu.nms_tier)
        boxes = boxes.contiguous()
        got, _ = nms_cuda.greedy_alive_cuda(boxes, valid, cfg.TEST.RPN_NMS_THRESH, 31)
        want = greedy_alive(boxes, valid, cfg.TEST.RPN_NMS_THRESH, 31)
    check(torch.equal(got, want), "kernel != plain on the R-FCN frame's RPN input")
    steady = statistics.mean(wall[1:])
    print(f"R-FCN serving: ResNet-101 bf16 (no DCN) at {BUCKET[0]}x{BUCKET[1]}, 12 frames of "
          f"RFCNDetector.detect; per-frame wall ms {[round(x * 1e3, 2) for x in wall]} (first "
          f"includes warm-up); after the first {steady * 1e3:.2f} ms/frame = {1 / steady:.1f} "
          f"frames/s, of it host enqueue {statistics.mean(enqueue[1:]) * 1e3:.2f} ms/frame; "
          f"nms kernel launches {launches} (2 per frame); host syncs flagged after the "
          f"first frame {syncs}; valid detections on the last frame {int(outs[-1][1].sum())}")
    print(f"R-FCN serving: kernel mask equals plain on the last frame's RPN input "
          f"{tuple(boxes.shape)}: {int(got.sum())} alive of {int(valid.sum())} valid")
    return launches, float((got.int() - want.int()).abs().max()), outs


def rfcn_training(dev, nms_cuda, greedy_alive):
    """Phase 9. Returns (kernel launches, max abs error)."""
    from lsfa_tpu_torch.config import load_config
    from lsfa_tpu_torch.train.driver import init_model

    cfg = load_config(None, overrides=RFCN_OVERRIDES)
    model = init_model(cfg, rng_seed=0, device=dev)
    calibrate_input_bn(model)
    r = train_run(cfg, model, 4, nms_cuda, greedy_alive)
    print(train_line(f"R-FCN training: ResNet-101 bf16 (float32 parameters) at {BUCKET[0]}x"
                     f"{BUCKET[1]}, B=1, 4 steps of train_net", r))
    return r["launches"], r["err"]


def rfcn_account(dev):
    """Phase 13's account of the R-FCN paths on a fresh full-width R-FCN
    (random weights from a seed): per frame of RFCNDetector.detect, then
    per train step of make_rfcn_train_step, the host's enqueue and the wall
    time until synchronized (medians of 5 after a warm-up call), then under
    torch.profiler (3 calls) the device time, the device kernels per call
    and the five kernels that take the most device time. The device's busy
    share is the profiled device time over the unprofiled wall time."""
    import torch

    from lsfa_tpu_torch.config import load_config
    from lsfa_tpu_torch.data.loader import batch_to_device, synthetic_train_batches
    from lsfa_tpu_torch.eval.rfcn_tester import RFCNDetector
    from lsfa_tpu_torch.train.driver import init_model
    from lsfa_tpu_torch.train.schedule import make_optimizer
    from lsfa_tpu_torch.train.train_step import (
        TrainSettings, draw_uniforms, make_rfcn_train_step)

    cfg = load_config(None, overrides=RFCN_OVERRIDES)
    model = init_model(cfg, rng_seed=1, device=dev)
    calibrate_input_bn(model)
    det = RFCNDetector(model, cfg, BUCKET)
    frame = np.zeros((1,) + BUCKET + (3,), np.uint8)
    frame[:, :CONTENT[0], :CONTENT[1]] = np.random.default_rng(8).integers(
        0, 256, (1,) + CONTENT + (3,), dtype=np.uint8)
    info = np.asarray([[CONTENT[0], CONTENT[1], 600 / 576]], np.float32)
    settings = TrainSettings.from_config(cfg)
    step = make_rfcn_train_step(model, settings, *make_optimizer(
        model, base_lr=cfg.TRAIN.lr, lr_steps=[1000]))
    batch = batch_to_device(synthetic_train_batches(
        1, BUCKET, seed=5, num_classes=cfg.dataset.NUM_CLASSES, max_gt=cfg.tpu.max_gt_boxes,
        content_hw=CONTENT)[0], dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    for name, fn in (("R-FCN frame (RFCNDetector.detect)", lambda: det.detect(frame, info)),
                     ("R-FCN train step (B=1)",
                      lambda: step(batch, draw_uniforms(settings, batch, gen)))):
        fn()
        torch.cuda.synchronize()
        enqueue, wall = [], []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            enqueue.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t0)
        names, dev_us, top = device_kernels(fn, 3, top=5)
        wall_ms = statistics.median(wall) * 1e3
        print(f"profiled: {name} at {BUCKET[0]}x{BUCKET[1]}: host enqueue "
              f"{statistics.median(enqueue) * 1e3:.2f} ms, wall {wall_ms:.2f} ms (median of 5); "
              f"device {dev_us / 1e3:.2f} ms in {len(names) / 3:.0f} kernels per call (mean of "
              f"3), busy share {dev_us / 1e3 / wall_ms:.2f}; top kernels by device time "
              + "; ".join(f"{n} {share:.3f}" for n, share in top))


def bn_training(dev, nms_cuda, greedy_alive):
    """Phase 10. Returns (kernel launches, max abs error)."""
    import torch

    from lsfa_tpu_torch.config import load_config
    from lsfa_tpu_torch.train.driver import init_model

    cfg = load_config(None, overrides={"network": BN_VARIANTS})
    model = init_model(cfg, rng_seed=0, device=dev)
    calibrate_input_bn(model)
    r = train_run(cfg, model, 2, nms_cuda, greedy_alive, still_ok=("nq_net.conv3.bias",))
    state, before = model.state_dict(), r["before"]
    bns = ("rnet.bn", "small_fuse.cur_feat_bn", "small_fuse.warp_conv_feat_bn")
    for bn in bns:
        for k in ("running_mean", "running_var"):
            check(not torch.equal(state[f"{bn}.{k}"], before[f"{bn}.{k}"]), f"{bn}.{k} did not move")
        for k in ("weight", "bias"):
            check(torch.equal(state[f"{bn}.{k}"], before[f"{bn}.{k}"]), f"frozen {bn}.{k} moved")
    print(train_line(f"train BN: LSFA ResNet-101 bf16 with res_diff_bn and "
                     f"small_net_bn_before_fuse at {BUCKET[0]}x{BUCKET[1]}, B=1, 2 steps of "
                     f"train_net", r))
    print(f"train BN: running statistics of {', '.join(bns)} moved, their scale and bias "
          f"unchanged; rnet.bn running var {state['rnet.bn.running_var'].tolist()}")
    launches, err = r["launches"], r["err"]
    del model, r, state, before
    print(f"train BN small: tiny LSFA float32 with res_diff_bn and small_net_bn_before_fuse, "
          f"{tiny_train_card_vs_cpu(dev, nms_cuda, BN_VARIANTS)}")
    return launches, err


def per_frame_vs_gop(dev):
    """Phase 11: process_frame over the flags 0, 2, ..., 1, 2, ... gives
    what process_prepared_window gives on the tiny float32 LSFA."""
    import torch

    from lsfa_tpu_torch.eval.tester import StreamingDetector

    tiny, model = tiny_stream_model(dev)
    payloads = synth_payloads(np.random.default_rng(2), 2, bucket=(64, 112), content=(60, 104),
                              scale=0.5)
    kd, kv, cd, cv = StreamingDetector(model, tiny, (64, 112)).process_prepared_window(
        payloads, first=True)
    det = StreamingDetector(model, tiny, (64, 112))
    score_err, flags = 0.0, []
    for g, (frames, smalls, mv, res, info) in enumerate(payloads):
        for i in range(GOP):
            flags.append(det.key_frame_flag(det.frame_id))
            if i == 0:
                d, v = det.process_frame(frames[0:1], info)
                want_d, want_v = kd[g], kv[g]
            else:
                d, v = det.process_frame(None, info, mv[i:i + 1], res[i:i + 1],
                                         small=smalls[i:i + 1])
                want_d, want_v = cd[g, i - 1:i], cv[g, i - 1:i]
            check(torch.equal(v, want_v), f"GOP {g} frame {i}: valid masks differ per frame")
            err = float((torch.sort(d[..., 1], dim=-1)[0]
                         - torch.sort(want_d[..., 1], dim=-1)[0]).abs().max())
            score_err = max(score_err, err)
    check(score_err < 1e-4, f"per-frame vs per-GOP sorted scores differ by {score_err}")
    check(flags == [0] + [2] * (GOP - 1) + [1] + [2] * (GOP - 1), f"key flags {flags}")
    print(f"per frame: tiny LSFA float32 on the card, 2 GOPs through process_frame (flags 0, 2 x "
          f"{GOP - 1}, 1, 2 x {GOP - 1}) against process_prepared_window: valid masks equal, "
          f"sorted scores max err {score_err:.2e}")


def scoring(outs):
    """Phase 12: collect_detections and vid_eval over the R-FCN serving
    detections against seeded gt boxes; the gt planted as detections
    scores 1.0."""
    from lsfa_tpu_torch.eval.tester import collect_detections
    from lsfa_tpu_torch.eval.vid_eval import vid_eval

    rng = np.random.default_rng(11)
    annotations = {}
    for i in range(len(outs)):
        n = int(rng.integers(1, 6))
        x1 = rng.uniform(0, 700, n)
        y1 = rng.uniform(0, 400, n)
        boxes = np.stack([x1, y1, x1 + rng.uniform(30, 300, n), y1 + rng.uniform(30, 200, n)], 1)
        annotations[i] = {"labels": rng.integers(1, 31, n), "boxes": boxes.astype(np.float32)}
    detections = {i: collect_detections(d, v) for i, (d, v) in enumerate(outs)}
    ap = vid_eval(detections, annotations, 31)
    mean_ap = float(np.nanmean(ap))
    check(np.isfinite(mean_ap) and 0.0 <= mean_ap <= 1.0, f"mAP {mean_ap}")
    planted = {i: {"labels": a["labels"], "scores": np.ones(len(a["labels"])),
                   "boxes": a["boxes"]} for i, a in annotations.items()}
    planted_ap = vid_eval(planted, annotations, 31)
    check(float(np.nanmean(planted_ap)) == 1.0, f"planted gt scored {planted_ap}")
    n_det = sum(len(d["labels"]) for d in detections.values())
    print(f"scoring: vid_eval over the 12 R-FCN frames ({n_det} detections) against seeded gt "
          f"({sum(len(a['labels']) for a in annotations.values())} boxes, "
          f"{int(np.isfinite(ap).sum())} classes): mAP {mean_ap:.4f} (random weights); the gt "
          f"planted as detections: mAP {float(np.nanmean(planted_ap)):.4f}")


def tiny_stream_model(dev):
    """The tiny streaming config (float32, RPN tier off) and its LSFA on
    `dev`, weights from a seed on the CPU with the R-FCN class kernel
    spread to std 0.05."""
    import torch

    from lsfa_tpu_torch.config import load_config
    from lsfa_tpu_torch.models.lsfa import init_params, lsfa_from_config

    tiny = load_config(None, overrides={
        "network": {"num_layer": 18, "DFF_FEAT_DIM": 64, "ANCHOR_SCALES": [1, 2, 4]},
        "TEST": {"RPN_PRE_NMS_TOP_N": 256, "RPN_POST_NMS_TOP_N": 64, "max_per_image": 20},
        "tpu": {"compute_dtype": "float32", "nms_tier": 0}})
    model = lsfa_from_config(tiny, device="cpu")
    init_params(model, torch.Generator().manual_seed(3))
    with torch.no_grad():
        model.rfcn_cls.weight.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(4))
    return tiny, model.to(dev)


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA card")
    if not (REPO / "lsfa_tpu_torch" / "csrc" / "nms_sweep.cu").is_file():
        fail(f"lsfa_tpu_torch not found beside {Path(__file__).name}")
    sys.path.insert(0, str(REPO))
    from lsfa_tpu_torch.config import get_default_config, load_config
    from lsfa_tpu_torch.eval.tester import StreamingDetector
    from lsfa_tpu_torch.models.lsfa import init_params, lsfa_from_config
    from lsfa_tpu_torch.ops import nms_cuda
    from lsfa_tpu_torch.ops.nms import greedy_alive
    from lsfa_tpu_torch.ops.proposal import proposal_candidates

    dev = torch.device("cuda", 0)
    # float32 convs (the DCN offset convs) and matmuls stay full float32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # 1. environment
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"env: python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}, "
          f"cudnn.allow_tf32=False, matmul.allow_tf32=False")
    print(smi)

    # 2. build
    nms_cuda.build()
    print(f"build: nvcc {' '.join(nms_cuda.NVCC_FLAGS)} nms_sweep.cu, "
          f"{nms_cuda.BUILD_SECONDS:.2f} s (build or load of a cached build)")

    # 3. kernel vs plain, bit for bit
    rng = np.random.default_rng(0)
    max_err = 0.0
    shapes, checked = [], []
    for name, boxes, valid, thresh, sweeps, timed in kernel_cases(rng):
        b = torch.from_numpy(boxes).to(dev)
        v = torch.from_numpy(valid).to(dev)
        got, conv = nms_cuda.greedy_alive_cuda(b, v, thresh, sweeps)
        want, want_conv = greedy_alive(b, v, thresh, sweeps, with_converged=True)
        torch.cuda.synchronize()
        err = float((got.int() - want.int()).abs().max())
        max_err = max(max_err, err)
        check(torch.equal(got, want), f"kernel mask != plain mask on {name}")
        check(torch.equal(conv, want_conv), f"kernel converged != plain on {name}")
        bsz, n = valid.shape
        csize = nms_cuda.cluster_size(bsz, n, dev)
        checked.append((name, b, v, thresh, sweeps, timed))
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        nms_cuda.greedy_alive_cuda(b, v, thresh, sweeps)
        extra = torch.cuda.max_memory_allocated(dev) - before
        if n <= nms_cuda.FUSED_MAX_N:
            check(extra <= 2 * 512 + bsz * n, f"{name}: the fused path allocated {extra} bytes")
        line = (f"kernel vs plain: {name} t={thresh} sweeps={sweeps}: masks and converged equal "
                f"({int(got.sum())} alive, {int(conv.sum())}/{bsz} converged); cluster {csize}, "
                f"{extra} bytes allocated")
        if timed:
            k_ms = cuda_ms(lambda: nms_cuda.greedy_alive_cuda(b, v, thresh, sweeps))
            p_ms = cuda_ms(lambda: greedy_alive(b, v, thresh, sweeps))
            bound_ms, bound_by = nms_bound_ms(bsz, n)
            shapes.append({"shape": [bsz, n], "thresh": thresh, "us": k_ms * 1e3,
                           "plain_us": p_ms * 1e3, "bound_us": bound_ms * 1e3,
                           "bound_by": bound_by, "share_of_bound": bound_ms / k_ms,
                           "cluster": csize})
            line += (f"; kernel {k_ms * 1e3:.1f} us per call (median of 20, wrapper included), "
                     f"plain {p_ms * 1e3:.1f} us; bound {bound_ms * 1e3:.2f} us ({bound_by}), "
                     f"share {bound_ms / k_ms:.3f}")
        print(line)

    # 4. the main path at full width
    cfg = get_default_config()
    model = lsfa_from_config(cfg, device=dev)
    init_params(model, torch.Generator(device=dev).manual_seed(0))
    det = StreamingDetector(model, cfg, BUCKET)
    payloads = synth_payloads(np.random.default_rng(1), 3)
    torch.cuda.synchronize()
    nms_cuda.LAUNCHES = 0
    gop_s = []
    syncs = 0
    outs = []
    for g, p in enumerate(payloads):
        if g == len(payloads) - 1:
            last_state = det.get_state()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            out = det.process_prepared_window([p], first=(g == 0))
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        gop_s.append(time.perf_counter() - t0)
        if g > 0:                       # the warm-up GOP initializes cuDNN/cuBLAS
            syncs += sum("synchroniz" in str(w.message) for w in caught)
        outs.append(out)
    launches = nms_cuda.LAUNCHES
    check(launches == 4 * len(payloads),
          f"the main path launched the NMS kernel {launches} times, not 4 per GOP")
    for kd, kv, cd, cv in outs:
        check(tuple(kd.shape) == (1, 1, 300, 6) and tuple(cd.shape) == (1, GOP - 1, 300, 6),
              f"detection shapes {tuple(kd.shape)}, {tuple(cd.shape)}")
        check(bool(torch.isfinite(kd).all() and torch.isfinite(cd).all()), "non-finite detections")
        check(int(kv.sum()) > 0 and int(cv.sum()) > 0, "no valid detections")
    feat = det.feat_key
    check(feat.dtype == torch.float32 and tuple(feat.shape) == (1, 38, 64, 1024),
          f"carry {feat.dtype} {tuple(feat.shape)}")
    check(bool(torch.isfinite(feat).all()), "non-finite key-feature carry")
    steady = gop_s[1:]
    print(f"main path: LSFA ResNet-101 bf16 at {BUCKET[0]}x{BUCKET[1]}, 3 GOPs = "
          f"{3 * GOP} frames; per-GOP wall s {[round(s, 4) for s in gop_s]} "
          f"(first includes warm-up); after warm-up {statistics.mean(steady) * 1e3:.1f} "
          f"ms/GOP = {GOP / statistics.mean(steady):.1f} frames/s; "
          f"nms kernel launches {launches}; host syncs flagged after warm-up {syncs}; "
          f"valid detections/frame {int(outs[-1][1].sum())}, "
          f"{int(outs[-1][3].sum()) // (GOP - 1)} (key, non-key mean)")

    # the kernel on the last key frame's real RPN input
    feat_key, data_key, _ = last_state
    p = payloads[-1]
    with torch.no_grad():
        key = torch.from_numpy(p[0][0:1]).to(dev)
        kout = model.forward_key(key, data_key, feat_key, torch.zeros(1, device=dev))
        info = torch.from_numpy(p[4][None]).to(dev)
        boxes, _, valid = proposal_candidates(
            kout["rpn_fg"], kout["rpn_deltas"], det.anchors, info,
            cfg.TEST.RPN_PRE_NMS_TOP_N, cfg.TEST.RPN_MIN_SIZE,
            cfg.network.RPN_FEAT_STRIDE, cfg.tpu.nms_tier)
        boxes = boxes.contiguous()
        got, _ = nms_cuda.greedy_alive_cuda(boxes, valid, cfg.TEST.RPN_NMS_THRESH, 31)
        want = greedy_alive(boxes, valid, cfg.TEST.RPN_NMS_THRESH, 31)
    check(torch.equal(got, want), "kernel != plain on the key frame's RPN input")
    print(f"main path: kernel mask equals plain on the key frame's RPN input "
          f"{tuple(boxes.shape)}: {int(got.sum())} alive of {int(valid.sum())} valid")

    # 5. small input: card (kernel) vs CPU (plain), float32, same weights
    tiny, cpu_model = tiny_stream_model("cpu")
    gpu_model = lsfa_from_config(tiny, device=dev)
    gpu_model.load_state_dict(cpu_model.state_dict())
    small = synth_payloads(np.random.default_rng(2), 2, bucket=(64, 112), content=(60, 104),
                           scale=0.5)
    ref_det = StreamingDetector(cpu_model, tiny, (64, 112))
    card_det = StreamingDetector(gpu_model, tiny, (64, 112))
    ref = ref_det.process_prepared_window(small, first=True)
    card = [o.cpu() for o in card_det.process_prepared_window(small, first=True)]
    carry_err = float((card_det.feat_key.cpu() - ref_det.feat_key).abs().max())
    carry_tol = 1e-4 * max(1.0, float(ref_det.feat_key.abs().max()))
    check(carry_err < carry_tol, f"tiny carry card vs CPU differs by {carry_err}")
    for k in (1, 3):
        check(torch.equal(card[k], ref[k]), "tiny valid masks differ card vs CPU")
    score_err = max(float((torch.sort(c[..., 1], dim=-1)[0] - torch.sort(r[..., 1], dim=-1)[0])
                          .abs().max()) for c, r in ((card[0], ref[0]), (card[2], ref[2])))
    check(score_err < 1e-4, f"tiny sorted scores card vs CPU differ by {score_err}")
    print(f"small input: tiny LSFA float32, 2 GOPs, card vs CPU: carry max err "
          f"{carry_err:.2e}, valid masks equal, sorted scores max err {score_err:.2e}")

    train_launches, train_err = train_phases(dev, nms_cuda, greedy_alive)
    # 8-12: the single-frame R-FCN, the train-mode BatchNorms, per-frame
    # streaming and scoring
    serve_launches, serve_err, serve_outs = rfcn_serving(dev, nms_cuda, greedy_alive)
    rfcn_launches, rfcn_err = rfcn_training(dev, nms_cuda, greedy_alive)
    bn_launches, bn_err = bn_training(dev, nms_cuda, greedy_alive)
    per_frame_vs_gop(dev)
    scoring(serve_outs)
    max_err = max(max_err, train_err, serve_err, rfcn_err, bn_err)

    # 13. launches and device time by torch.profiler, last: after a profiled
    # window the host's launches stay slower, which would bias phases 3-12
    rfcn_account(dev)
    timed = iter(shapes)
    for name, b, v, thresh, sweeps, is_timed in checked:
        names, _ = device_kernels(lambda: nms_cuda.greedy_alive_cuda(b, v, thresh, sweeps))
        check(len(names) == (1 if v.shape[1] <= nms_cuda.FUSED_MAX_N else 2),
              f"{name}: one call ran the device kernels {names}")
        line = f"profiled: {name}: {len(names)} kernel launch(es) per call"
        if is_timed:
            entry = next(timed)
            _, dev_us = device_kernels(lambda: nms_cuda.greedy_alive_cuda(b, v, thresh, sweeps), 20)
            # num_sweeps = 0: the build and the one sweep that tests the exit
            _, build_us = device_kernels(lambda: nms_cuda.greedy_alive_cuda(b, v, thresh, 0), 20)
            entry.update(device_us=dev_us, device_us_sweeps0=build_us,
                         device_share_of_bound=entry["bound_us"] / dev_us)
            line += (f", {dev_us:.1f} us on the device (mean of 20), "
                     f"{entry['device_share_of_bound']:.3f} of the bound; with num_sweeps=0 "
                     f"(build and one test sweep) {build_us:.1f} us")
        print(line)

    rpn = next(s for s in shapes if s["shape"] == [12, 2048])
    print(json.dumps({"kernels": [{
        "name": "nms_sweep", "route": "cuda",
        "source": "lsfa_tpu_torch/csrc/nms_sweep.cu",
        "replaces": "lsfa_tpu/ops/pallas_nms.py:97",
        "launches": launches + train_launches + serve_launches + rfcn_launches + bn_launches,
        "max_abs_err": max_err,
        "ms": rpn["us"] / 1e3, "plain_ms": rpn["plain_us"] / 1e3,
        "bound_ms": rpn["bound_us"] / 1e3, "bound_by": rpn["bound_by"], "library_ms": None,
        "launches_by_path": {"streaming": launches, "train": train_launches,
                             "rfcn_serve": serve_launches, "rfcn_train": rfcn_launches,
                             "train_bn": bn_launches},
        "shapes": shapes}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
