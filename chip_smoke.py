#!/usr/bin/env python3
"""Smoke run of lsfa_tpu_torch on one NVIDIA card (sm_90a).

    python3 chip_smoke.py

Phases, each printing one line before the last:
  1. environment: torch/CUDA versions, the card's name and power limit;
  2. build: nvcc compiles the NMS fixpoint kernel from the checkout;
  3. kernel vs plain: the kernel's alive masks and converged flags equal
     the plain version's bit for bit on the four streaming shapes (1, 2048)
     t=0.7, (30, 300) t=0.3, (11, 2048) t=0.7, (330, 300) t=0.3, the RPN
     stand-in (12, 2048), the batched GOP's per-class (360, 300),
     suppression chains at B = 1, the odd cap 1, a cut valid mask, ragged N, N = 1, the two-phase N = 2049 and 8192,
     and knife-edge pairs whose float32 IoU lies within 2 ulps of t;
     checks that N <= 2048 allocates no scratch (torch.cuda memory
     statistics) and that a call is one kernel for N <= 2048 and two
     above (the nodes of a CUDA graph captured around it); median times per call of kernel and plain version, the
     bound and the share of the bound at the timed shapes;
  4. main path: the flagship LSFA (ResNet-101 with DCN, FlowNet-S, Nq-net,
     R-net, small net) at full width, random weights from a seed, bf16,
     through StreamingDetector over 3 GOPs (36 frames) of seeded I420
     payloads (SyntheticPreparedVideo) at the 608x1024 bucket; checks detection shapes and
     finiteness, the float32 carry, that the main path launched the
     kernel 4 times per GOP, and that the kernel's mask equals the plain
     version's on the last key frame's real RPN input;
  5. small-input reference: the tiny config in float32 on the card (with
     the kernel) against the same weights on the CPU (plain version), the
     float32 convolutions pinned by the package, not by this script;
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
 13. evaluation loop: the flagship of phase 4 through eval_videos over three
     SyntheticPreparedVideo records of 36, 36 and 30 frames (open_video
     given: the card's machine cannot load the native decoder): 102 finite
     records keyed 0..101, the schedule the loop ran (8 GOPs in windows of
     at most 2, the 30-frame video's last 6 frames through process_frame,
     the first with flag 0), 44 kernel launches reckoned again from that
     schedule, no host sync flagged inside an enqueue; prints frames/s,
     ms per GOP and per tail frame, and the PhaseTimer summary;
 14. multistream: the same records through eval_videos_timeplex(streams=3):
     the checks of phase 13, detections equal to eval_videos' (labels and
     valid rows equal, scores within 1e-6 relative, boxes within 1e-3),
     frames/s beside the sequential loop's;
 15. a producer's failure: eval_videos_timeplex over a stream whose gop
     raises on its second window raises that error, and no thread of the
     call is left alive;
 16. R-FCN loop: the full-width R-FCN of phase 8 through eval_videos_rfcn
     over one 12-frame record of BGR u8 frames: 12 finite records, 24
     kernel launches, frames/s;
 17. the data plane does not pretend: PreparedVideo("missing.mp4") raises
     the error that names the native library and the FFmpeg libraries it
     needs (where the library loads: the missing file's error);
     then vid_eval over phase 13's detections against seeded gt boxes;
 18. the float32 pin: torch.backends.cudnn.allow_tf32 is True (torch's
     default) at the start and at the end, so the float32 parity phases 5,
     7 and 10 ran against the package's own pin; a float32 Conv of the
     package on the card agrees with the float64 convolution to float32
     rounding; the cost of the pin per GOP;
 19. reference weights: the flagship LSFA and the R-FCN of
     rfcn_resnet101_vid.json at full width, seeded weights with every entry
     moved (`distinct_weights`), through export_mxnet_lsfa into .params
     files, the importer (lsfa_tpu_torch.tools.import_reference_checkpoint)
     and the launcher's checkpoint load into fresh models on the card: the
     state dicts equal bit for bit, one GOP of StreamingDetector (LSFA) and
     two frames of RFCNDetector.detect (R-FCN) give the source's detections
     (4 and 4 kernel launches), the kernel's mask equals the plain version's
     on the imported model's RPN input; an R-FCN release with only the baked
     rfcn_bbox_*_test un-bakes to within 1e-6 relative; prints the file size,
     the seconds to export, import and load, and the tensor counts;
 20. the launcher: experiments.lsfa_test.run_test with
     lsfa_resnet101_vid.json and phase 19's checkpoint over an ImageNet VID
     tree the phase writes (ImageSets list, XML annotations; two videos of
     36 and 30 frames), SyntheticPreparedVideo streams through open_video:
     a finite mAP in [0, 1], 66 records, 32 kernel launches reckoned from
     the recorded schedule, frames/s; then streams=2 with equal detections;
 21. warm starts: init_model on the flagship with network.pretrained a
     backbone-only .params at the reference's ImageNet names and
     pretrained_flow a FlowNet-only one (seeded arrays): the imported
     tensors equal the files', the small net the warm backbone's; 2 steps
     of train_net (the checks of phase 6); pretrained_detector from phase
     19's R-FCN checkpoint transfers the shared stack, and a checkpoint
     that shares nothing raises;
 22. train and test: an ImageNet tree the phase writes (DET_train_30classes,
     4 images of 375x500; VID_train_15frames, 15 frames of each of 2
     videos of 36 frames at 720x1280, one stream a frame short;
     VID_val_videos, 24 and 18 frames, one stream a frame short) through
     train.driver.load_train_roidb (68 records with the flipped copies);
     the host chain's ms per sample; one flagship step (warm-started from
     phase 21's files) through NCCL at world size 1 equal to the same step
     without a process group; then experiments.lsfa_end2end_train_test.main
     at --max-steps 4 under that process group, SyntheticVideoReader and a
     seeded image reader feeding TrainLoader's host chain and
     SyntheticPreparedVideo the evaluation: finite metrics, one kernel
     launch per step, the kernel's mask equal to the plain version's on
     the last step's RPN input, the checkpoint reloads with frozen
     parameters unchanged, run_test's mAP in [0, 1] with 24 launches
     reckoned from its schedule; prints ms per step, peak memory, the feed
     summary (loader-wait share) and run_test's frames/s;
 23. MobileNetV2 LSFA: the trunk, pixel statistics and depth that
     update_network_config derives from "mobilenetv2" (ReLU6, the 1280-ch
     head, feat 1024, FlowNet-S, Nq-net, R-net, no small net, no DCN, 31
     classes, bf16, RPN tier 2048) at full width, seeded weights, through
     eval_videos over phase 13's three records (after a first pass that
     is not timed): the checks of phase 13 (102 finite records, the
     schedule, 44 launches, no host sync inside an enqueue), frames/s and
     the PhaseTimer split; the kernel's mask equal to the plain version's
     on this model's RPN inputs at (1, 2048) and (11, 2048); 2 steps of
     train_net (the checks and prints of phase 6);
 24. Hobot LSFA: the same with the Hobot trunk (plain ReLU, 320 channels,
     PIXEL_SCALE 0.017), one GOP through StreamingDetector after a
     warm-up GOP: finite detections and carry, 4 kernel launches, ms/GOP;
 25. batched GOP: the flagship of phase 4 through the port's
     experiments.demo_batch.main over a 12-frame SyntheticVideoReader GOP
     of 960x576 frames at 608x1024: 12 frames of finite detections, 2
     kernel launches at (12, 2048) t=0.7 and (360, 300) t=0.3, masks equal
     to the plain version's on those inputs, ms per GOP (median of 5);
     frame 0's feature and maps within 2^-7 of each one's largest value of
     forward_key's with is_first=1 on the same frame (the same fresh bf16
     feature, its heads run at batch 12 and 1); then the kernel's and the
     plain version's time and the bound at (360, 300) on that input, and
     the script's seconds so far;
 26. every variant tiny: fgfa, fnet_conv2, fnet_res, fuse_concat,
     small_addv2, small_concat, small_concatv1, small_concatv2, mobilenet
     and mobilenet_hobot (ResNet-18 with DCN or the MobileNet trunk, feat
     64, float32), the same seeded weights on the card and on the CPU
     through forward_key, forward_cur and forward_batch_gop, and the
     ResNet-18 trunk with the non-local block: each output within 1e-4 of
     max(1, its largest |value|), under the package's float32 pin;
 27. profiled: the R-FCN frame and train step, host enqueue against wall
     time, then their device time, kernels per call and top kernels under
     torch.profiler; torch.profiler's count of kernels in each phase 3
     case's call equals the captured graph's, and it gives the kernel's
     device time at the timed shapes, also with num_sweeps = 0 (the build
     and one test sweep), which splits build from sweeps (run last: a
     profiled window slows later host launches). Where the profiler
     records no device event, these device times read "not measured".
 28. the demo: experiments.demo.main with the flagship of phase 4 over 24
     frames of a 720x1280 SyntheticVideoReader stream: 24 PNGs, each read
     back (`read_png`, zlib, no PIL) at 720x1280x3, the frame lines with
     flags 0, 2 to frame 11 and 1 at frame 12, 2 kernel launches per
     frame; frames/s and ms per PNG written; then run_test with
     vis_frames=4 over a 14-frame video writes 4 PNGs;
 29. learn->detect: tools.overfit_smoke.main() at its defaults (the tiny
     LSFA, 80 steps) on the card returns 0 with AP[class 3] > 0.49; the
     loss at steps 0, 20, 40, 60 and 79, ms per step, the top-3 detections;
 30. FlowNet-S pretraining: tools.pretrain_flow.main at feat_dim 1024 and
     batch 4 over 960x576 and 576x960 clips of the hard profile rendered
     in memory (RenderedSynthDataset, no encoding), 40 steps: finite losses,
     photo_first and photo_final, ms per step, peak memory; the
     checkpoint warm-starts the flagship through init_model's
     pretrained_flow with its FlowNet tensors bit-equal; a tiny step card
     against CPU from the same weights and pairs within 1e-5 of
     max(1, |x|);
 31. the train-mode BatchNorms through the all-reduce path: a flagship step
     with res_diff_bn and small_net_bn_before_fuse under NCCL at world size
     1 (3 all-reduces of the moments) equals the step without a process
     group (metrics 1e-5, parameters 1e-6, running statistics 1e-4 of
     max(1, |x|));
 32. bf16 parameter storage: the flagship with tpu.param_dtype bfloat16,
     its parameter GiB against float32's, one GOP of finite detections and
     one train_net step that leaves the parameters bfloat16;
 33. JPEG-frame evaluation: eval_videos over a record with a pattern and
     no video_path, 14 frames of 720x1280 from a seeded read_image: the
     per-frame path, zero MV and residual grids, 2 launches per frame,
     frames/s;
 34. the synthetic ablation ladder's two card rungs at the flagship recipe
     (bf16, 960x576 and 576x960, hard profile) through
     tools.train_synth_full.main over clips rendered in memory
     (RenderedSynthDataset: the card cannot encode, so no codec MVs or
     residuals): the rfcn rung (R-FCN ResNet-101 with DCN) 30 steps over 4
     clips of 36 frames with its evaluation over 2 val clips, then the
     oracle rung warm-started from its checkpoint (its detection stack
     bit-equal to the checkpoint's after init_model), then
     tools.eval_rung.main for each rung over 2 fresh clips and
     render_ablation: finite
     metrics on every logged step, JAX's report keys, a non-key sample's
     MVs nonzero (the oracle flow on the fast path), the kernel's masks
     equal to the plain version's on the last train step's and the first
     evaluation's RPN inputs, launches from the schedule (1 per step, 2 per
     R-FCN frame, 4 per GOP); steps/s, loader-wait share, ms per step with
     the batch ready, peak memory, eval frames/s, mAP;
 35. the entry hooks: lsfa_tpu_torch.entry.entry()'s fn(*args) equal to
     the flagship's forward_key on the same inputs bit for bit, its ms per
     call.
 36. the measurement tools, each once through its main(argv) at few
     trials (TOOLS_SMOKE): lsfa_tpu_torch.bench (the headline: e2e over
     4 synthetic GOPs with per-GOP p50/p99 and the 3-stream timeplex
     aggregate; --device-only; --latency), tools.profile_detection,
     profile_breakdown, profile_train, bench_train (LSFA and R-FCN),
     report_mfu, ab_interleaved and bench_decode (host-only: without the
     native decoder it raises, naming the library): every JSON result
     well formed (finite positive values, the card's name and power
     limit), the kernel's launches equal to each tool's schedule (4 per
     GOP, 2 per frame, 1 per train step, 2 per detection at pre_nms
     6000), the bench loop's windows equal to process_prepared_window on
     the same payloads, the kernel's masks equal to the plain version's
     on the bench's key and non-key RPN inputs and on profile_detection's
     N = 6000 input (the two-phase route: 2 kernels per call, its time
     beside the bound), every report_mfu share <= 105% and its FLOP
     counts at the tiny config equal to the CPU's, ab_interleaved's trial
     order A, B, A, B. Its profiled part (the kernel's device time at
     N = 6000, the profilers' --trace windows) runs after phase 27.
`python3 chip_smoke.py --ladder STEPS --out DIR` runs phase 34 alone with
a real step budget (`long_ladder`); `python3 chip_smoke.py --tools` runs
phase 36 alone (`tools_only`).
Then the script's seconds, one JSON line for the kernels and, last, the
result line. Any failed phase exits non-zero before the result line is
printed.
"""

import contextlib
import json
import logging
import re
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
T0 = time.perf_counter()                # the script's start
GOP = 12
BUCKET = (608, 1024)
CONTENT = (600, 1000)                 # resized frame inside the bucket
# the published configs through their JSON twins (the card's machine has
# no yaml); a CPU test holds each twin equal to its YAML file
LSFA_CONFIG = REPO / "lsfa_tpu_torch" / "configs" / "lsfa_resnet101_vid.json"
RFCN_CONFIG = REPO / "lsfa_tpu_torch" / "configs" / "rfcn_resnet101_vid.json"
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
        ("batched-GOP per-class (360, 300)", stack(360, 300),
         rng.uniform(size=(360, 300)) < 0.8, 0.3, 31, True),
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


NOT_TRACED = "device time not measured: torch.profiler recorded no device event in 3 windows"


def device_kernels(fn, reps=1, top=0):
    """Names of the device kernels that `reps` calls of fn() ran and their
    device time per call (us), from torch.profiler; with top > 0 also the
    `top` kernel names (cut to 60 characters) that took the most device
    time, each with its share. A trace that holds no device event at all is
    taken again, up to three times; if all three hold none, the names are
    [] and the time is None (not measured): CUPTI's tracing is a
    measurement here, never a check (launches per call come from
    `graph_kernels`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):       # a window now and then comes back without its device events
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            break
    total = sum(e.time_range.elapsed_us() for e in events)
    per_call = total / reps if events else None
    if not top:
        return [e.name for e in events], per_call
    by_name = {}
    for e in events:
        name = e.name.removeprefix("void ")[:60]
        by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us()
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return [e.name for e in events], per_call, [(n, us / total) for n, us in ranked]


def graph_kernels(fn):
    """(kernel nodes, all nodes) of a CUDA graph captured around one call
    of fn(): the kernels that one call launches, counted without a
    profiler. The graph is read through the driver API (cuGraphGetNodes,
    cuGraphNodeGetType)."""
    import ctypes

    import torch

    cuda = ctypes.CDLL("libcuda.so.1")
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    err = cuda.cuGraphGetNodes(raw, None, ctypes.byref(count))
    nodes = (ctypes.c_void_p * count.value)()
    if err == 0:
        err = cuda.cuGraphGetNodes(raw, nodes, ctypes.byref(count))
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        err = err or cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        kinds.append(kind.value)
    graph.reset()
    check(err == 0, f"reading the captured graph failed with CUDA driver error {err}")
    return kinds.count(0), len(kinds)        # 0: CU_GRAPH_NODE_TYPE_KERNEL


def rpn_masks(out, anchors, info, cfg, nms_cuda, greedy_alive):
    """The kernel's and the plain version's alive masks on the RPN input
    that one frame's head outputs `out` give. Returns (kernel's, plain
    version's, boxes, valid)."""
    import torch

    from lsfa_tpu_torch.ops.proposal import proposal_candidates

    with torch.no_grad():
        boxes, _, valid = proposal_candidates(
            out["rpn_fg"], out["rpn_deltas"], anchors, info, cfg.TEST.RPN_PRE_NMS_TOP_N,
            cfg.TEST.RPN_MIN_SIZE, cfg.network.RPN_FEAT_STRIDE, cfg.tpu.nms_tier)
        boxes = boxes.contiguous()
        got, _ = nms_cuda.greedy_alive_cuda(boxes, valid, cfg.TEST.RPN_NMS_THRESH, 31)
        want = greedy_alive(boxes, valid, cfg.TEST.RPN_NMS_THRESH, 31)
    return got, want, boxes, valid


def key_rpn_masks(det, state, payload, first, nms_cuda, greedy_alive):
    """`rpn_masks` on the key frame of GOP `payload`, run by the
    StreamingDetector `det` from the stream state `state` that preceded it
    (first: the GOP starts the stream)."""
    import torch

    feat_key, data_key, _ = state
    dev = det.device
    with torch.no_grad():
        out = det.model.forward_key(torch.from_numpy(payload[0][0:1]).to(dev), data_key,
                                    feat_key, torch.full((1,), float(first), device=dev))
    return rpn_masks(out, det.anchors, torch.from_numpy(payload[4][None]).to(dev), det.cfg,
                     nms_cuda, greedy_alive)


def frame_rpn_masks(det, cfg, frame, info, nms_cuda, greedy_alive):
    """`rpn_masks` on one BGR frame (1, H, W, 3) of the RFCNDetector `det`."""
    import torch

    with torch.no_grad():
        out = det.model(torch.from_numpy(frame).to(det.device))
    return rpn_masks(out, det.anchors, torch.from_numpy(info).to(det.device), cfg, nms_cuda,
                     greedy_alive)


def synth_gops(cfg, n_gops, seed, bucket=BUCKET, content=CONTENT, scale=600 / 576):
    """n_gops seeded stand-ins for PreparedVideo.gop tuples from the port's
    SyntheticPreparedVideo: I420 u8 key frames and 1/4 smalls padded with
    Y=16, U=V=128 past the content, MV (dx, dy) fields of a few cells,
    residuals, im_info."""
    from lsfa_tpu_torch.data.loader import SyntheticPreparedVideo

    pv = SyntheticPreparedVideo("smoke", cfg, bucket, num_frames=n_gops * GOP, seed=seed,
                                content_hw=content, im_scale=scale)
    return [pv.gop(g) for g in range(n_gops)]


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
            train_net(cfg, batches=batches, max_steps=len(batches), metrics_hook=hook, model=model)
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

    cfg = load_config(str(RFCN_CONFIG))
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
    got, want, boxes, valid = frame_rpn_masks(det, cfg, frames[-1], info, nms_cuda, greedy_alive)
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

    cfg = load_config(str(RFCN_CONFIG))
    model = init_model(cfg, rng_seed=0, device=dev)
    calibrate_input_bn(model)
    r = train_run(cfg, model, 4, nms_cuda, greedy_alive)
    print(train_line(f"R-FCN training: ResNet-101 bf16 (float32 parameters) at {BUCKET[0]}x"
                     f"{BUCKET[1]}, B=1, 4 steps of train_net", r))
    return r["launches"], r["err"]


def rfcn_account(dev):
    """Phase 22's account of the R-FCN paths on a fresh full-width R-FCN
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

    cfg = load_config(str(RFCN_CONFIG))
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
        line = (f"profiled: {name} at {BUCKET[0]}x{BUCKET[1]}: host enqueue "
                f"{statistics.median(enqueue) * 1e3:.2f} ms, wall {wall_ms:.2f} ms (median of 5); ")
        if dev_us is None:
            line += NOT_TRACED
        else:
            line += (f"device {dev_us / 1e3:.2f} ms in {len(names) / 3:.0f} kernels per call "
                     f"(mean of 3), busy share {dev_us / 1e3 / wall_ms:.2f}; top kernels by "
                     f"device time " + "; ".join(f"{n} {share:.3f}" for n, share in top))
        print(line)


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
    payloads = synth_gops(tiny, 2, 2, bucket=(64, 112), content=(60, 104), scale=0.5)
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


def scoring(name, detections):
    """vid_eval over a detections mapping {frame index -> collect_detections
    dict} against seeded gt boxes (a finite mAP in [0, 1]); the gt planted
    as detections scores 1.0."""
    from lsfa_tpu_torch.eval.vid_eval import vid_eval

    rng = np.random.default_rng(11)
    annotations = {}
    for i in range(len(detections)):
        n = int(rng.integers(1, 6))
        x1 = rng.uniform(0, 700, n)
        y1 = rng.uniform(0, 400, n)
        boxes = np.stack([x1, y1, x1 + rng.uniform(30, 300, n), y1 + rng.uniform(30, 200, n)], 1)
        annotations[i] = {"labels": rng.integers(1, 31, n), "boxes": boxes.astype(np.float32)}
    ap = vid_eval(detections, annotations, 31)
    mean_ap = float(np.nanmean(ap))
    check(np.isfinite(mean_ap) and 0.0 <= mean_ap <= 1.0, f"mAP {mean_ap}")
    planted = {i: {"labels": a["labels"], "scores": np.ones(len(a["labels"])),
                   "boxes": a["boxes"]} for i, a in annotations.items()}
    planted_ap = vid_eval(planted, annotations, 31)
    check(float(np.nanmean(planted_ap)) == 1.0, f"planted gt scored {planted_ap}")
    n_det = sum(len(d["labels"]) for d in detections.values())
    print(f"scoring: vid_eval over {name} ({n_det} detections) against seeded gt "
          f"({sum(len(a['labels']) for a in annotations.values())} boxes, "
          f"{int(np.isfinite(ap).sum())} classes): mAP {mean_ap:.4f} (random weights); the gt "
          f"planted as detections: mAP {float(np.nanmean(planted_ap)):.4f}")


class Lines:
    """A logger that keeps what the evaluation loops report."""

    def __init__(self):
        self.lines = []

    def info(self, msg):
        self.lines.append(msg)

    warning = info


@contextlib.contextmanager
def recorded_schedule(calls):
    """Context: StreamingDetector.process_prepared_window and process_frame
    record each call into `calls` as a dict (kind "window" with its GOP
    count and first flag, or "frame" with its flag; the host's clock at
    the call's start, its enqueue seconds, and the host syncs flagged
    inside it, which are counted from the second call on: the first call
    of a shape may initialize cuDNN)."""
    import torch

    from lsfa_tpu_torch.eval.tester import StreamingDetector

    def wrap(fn, describe):
        def call(self, *args, **kw):
            entry = describe(*args, **kw)
            entry["t0"] = time.perf_counter()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                if calls:
                    torch.cuda.set_sync_debug_mode("warn")
                try:
                    out = fn(self, *args, **kw)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            entry["enqueue"] = time.perf_counter() - entry["t0"]
            entry["syncs"] = sum("synchroniz" in str(w.message) for w in caught)
            calls.append(entry)
            return out
        return call

    window, frame = StreamingDetector.process_prepared_window, StreamingDetector.process_frame
    StreamingDetector.process_prepared_window = wrap(
        window, lambda payloads, first=False: {"kind": "window", "gops": len(payloads),
                                               "first": first})
    StreamingDetector.process_frame = wrap(
        frame, lambda *a, flag=None, **kw: {"kind": "frame", "flag": flag})
    try:
        yield
    finally:
        StreamingDetector.process_prepared_window = window
        StreamingDetector.process_frame = frame


EVAL_LENGTHS = {"synthetic-0": 36, "synthetic-1": 36, "synthetic-2": 30}


def eval_records(lengths):
    """Video records of 960x576 sources (600x1000 inside the 608x1024
    bucket) for synthetic streams, and the open_video that serves them."""
    from lsfa_tpu_torch.data.loader import SyntheticPreparedVideo

    roidb = [{"vid_path": name, "video_path": name, "frame_seg_len": n, "height": 576,
              "width": 960} for name, n in lengths.items()]

    def open_video(path, *args, **kw):
        return SyntheticPreparedVideo(path, *args, num_frames=lengths[path],
                                      content_hw=CONTENT, im_scale=600 / 576, **kw)

    return roidb, open_video


def write_vid_tree(dataset_path, lengths, height, width, seed=0):
    """An ImageNet VID layout under dataset_path for the videos `lengths`
    {name: frames}: ImageSets/VID_val_videos.txt with one line per video
    ("val/<name> 1 0 <frames>") and an XML annotation per frame of the
    given size with 1-3 seeded boxes of the first classes. Returns the
    test image set's name."""
    rng = np.random.default_rng(seed)
    sets = Path(dataset_path) / "ImageSets"
    sets.mkdir(parents=True, exist_ok=True)
    (sets / "VID_val_videos.txt").write_text(
        "".join(f"val/{name} 1 0 {n}\n" for name, n in lengths.items()))
    wnids = ("n02691156", "n02419796", "n02131653", "n02834778", "n01503061")
    for name, n in lengths.items():
        folder = Path(dataset_path) / "Annotations" / "VID" / "val" / name
        folder.mkdir(parents=True, exist_ok=True)
        for fid in range(n):
            objs = ""
            for _ in range(int(rng.integers(1, 4))):
                x1, y1 = rng.uniform(0, width * 0.6), rng.uniform(0, height * 0.6)
                x2 = x1 + rng.uniform(8, width * 0.4)
                y2 = y1 + rng.uniform(8, height * 0.4)
                objs += (f"<object><name>{wnids[int(rng.integers(len(wnids)))]}</name><bndbox>"
                         f"<xmin>{x1:.1f}</xmin><ymin>{y1:.1f}</ymin><xmax>{x2:.1f}</xmax>"
                         f"<ymax>{y2:.1f}</ymax></bndbox></object>")
            (folder / f"{fid:06d}.xml").write_text(
                f"<annotation><size><width>{width}</width><height>{height}</height></size>"
                f"{objs}</annotation>")
    return "VID_val_videos"


def check_detections(name, detections, n_frames):
    check(sorted(detections) == list(range(n_frames)),
          f"{name}: {len(detections)} detection records, not keyed 0..{n_frames - 1}")
    for d in detections.values():
        check(bool(np.isfinite(d["scores"]).all() and np.isfinite(d["boxes"]).all()),
              f"{name}: non-finite detections")
    check(sum(len(d["labels"]) for d in detections.values()) > 0, f"{name}: no valid rows")


def same_detections(name, got, want):
    """Checks two detections mappings equal: the same frames, labels and
    valid rows, scores within 1e-6 relative, boxes within 1e-3 (+1e-5
    relative). Returns the largest score and box differences."""
    check(sorted(got) == sorted(want), f"{name}: frames {len(got)} against {len(want)}")
    worst = {"scores": 0.0, "boxes": 0.0}
    for k in want:
        check(np.array_equal(got[k]["labels"], want[k]["labels"]),
              f"{name}: labels or valid rows of frame {k} differ")
        for f, tol in (("scores", dict(rtol=1e-6, atol=0.0)), ("boxes", dict(rtol=1e-5, atol=1e-3))):
            check(np.allclose(got[k][f], want[k][f], **tol),
                  f"{name}: {f} of frame {k} differ by {np.abs(got[k][f] - want[k][f]).max()}")
            if len(want[k][f]):
                worst[f] = max(worst[f], float(np.abs(got[k][f] - want[k][f]).max()))
    return worst


def lsfa_loop(name, loop, model, cfg, nms_cuda, desc="LSFA ResNet-101 bf16", **kw):
    """One LSFA evaluation loop over the three synthetic records, its
    schedule recorded. Checks 102 finite records, the schedule (8 GOPs in
    windows of at most 2, then the 30-frame video's last 6 frames one by
    one, the first of them with flag 0), the kernel's launches (4 per GOP,
    2 per frame, reckoned from the calls the loop made), and no host sync
    inside an enqueue. Returns (detections, launches, the printed line's
    numbers)."""
    import torch

    roidb, open_video = eval_records(EVAL_LENGTHS)
    n_frames = sum(EVAL_LENGTHS.values())
    log, calls = Lines(), []
    torch.cuda.synchronize()
    nms_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    with recorded_schedule(calls):
        detections = loop(model, cfg, roidb, logger=log, open_video=open_video, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = nms_cuda.LAUNCHES
    check_detections(name, detections, n_frames)
    windows = [c for c in calls if c["kind"] == "window"]
    frames = [c for c in calls if c["kind"] == "frame"]
    check(sorted(c["gops"] for c in windows) == [1, 1, 2, 2, 2] and
          sum(c["first"] for c in windows) == 3,
          f"{name}: windows {[(c['gops'], c['first']) for c in windows]}")
    check([c["flag"] for c in frames] == [0, 2, 2, 2, 2, 2] and calls[-6:] == frames,
          f"{name}: per-frame flags {[c['flag'] for c in frames]}, not the tail's 0, 2 x 5 last")
    tail = sorted(k for k in detections)[-6:]
    check(tail == list(range(n_frames - 6, n_frames)), f"{name}: tail keys {tail}")
    reckoned = 4 * sum(c["gops"] for c in windows) + 2 * len(frames)
    check(launches == reckoned == 44,
          f"{name}: {launches} kernel launches, {reckoned} reckoned from the schedule, not 44")
    syncs = sum(c["syncs"] for c in calls)
    check(syncs == 0, f"{name}: {syncs} host syncs flagged inside an enqueue")
    gop_ms = (frames[0]["t0"] - windows[0]["t0"]) * 1e3 / sum(c["gops"] for c in windows)
    # the tail: the key frame, the first non-key frame (new shapes to
    # cuDNN), then four steady non-key frames up to the loop's end
    stamps = [c["t0"] for c in frames] + [t0 + seconds]
    frame_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    print(f"{name}: {desc} at {BUCKET[0]}x{BUCKET[1]}, 3 synthetic videos of 36, 36 "
          f"and 30 frames: {n_frames} records in {seconds:.3f} s = {n_frames / seconds:.1f} "
          f"frames/s; {sum(c['gops'] for c in windows)} GOPs in {len(windows)} windows at "
          f"{gop_ms:.1f} ms/GOP = {gop_ms / GOP:.2f} ms/frame (enqueue per window ms "
          f"{[round(c['enqueue'] * 1e3, 1) for c in windows]}), then 6 tail frames one by one, "
          f"flags 0, 2 x 5, at ms {[round(x, 1) for x in frame_ms]} (the last four mean "
          f"{statistics.mean(frame_ms[2:]):.2f} ms/frame); nms kernel launches {launches} "
          f"(4 x 8 GOPs + 2 x 6 frames); host syncs flagged inside an enqueue {syncs}; "
          f"{log.lines[-1]}")
    return detections, launches, n_frames / seconds


def eval_phases(dev, model, cfg, nms_cuda):
    """Phases 13-17: eval_videos and eval_videos_timeplex on the flagship,
    a producer's failure, eval_videos_rfcn on the full-width R-FCN, and
    the data plane without its library. Returns (eval_videos' detections,
    launches of the three loops)."""
    import threading

    import torch

    from lsfa_tpu_torch.config import load_config
    from lsfa_tpu_torch.data import coviar
    from lsfa_tpu_torch.data.loader import PreparedVideo, SyntheticPreparedVideo
    from lsfa_tpu_torch.eval.driver import eval_videos, eval_videos_rfcn, eval_videos_timeplex
    from lsfa_tpu_torch.eval.rfcn_tester import rfcn_from_config
    from lsfa_tpu_torch.models.lsfa import init_params

    # 13. the sequential loop
    seq, seq_launches, seq_fps = lsfa_loop("eval_videos", eval_videos, model, cfg, nms_cuda)

    # 14. three streams in turn through the one detector
    tp, tp_launches, tp_fps = lsfa_loop("eval_videos_timeplex(streams=3)", eval_videos_timeplex,
                                        model, cfg, nms_cuda, streams=3)
    worst = same_detections("timeplex", tp, seq)
    print(f"eval_videos_timeplex(streams=3): detections equal eval_videos' (labels and valid "
          f"rows equal; max abs difference scores {worst['scores']:.2e}, boxes "
          f"{worst['boxes']:.2e}); {tp_fps:.1f} frames/s against {seq_fps:.1f} sequential")

    # 15. a producer's failure surfaces, and no producer outlives the call
    class FailingVideo(SyntheticPreparedVideo):
        def gop(self, gop_idx):
            if gop_idx >= 2:                 # the second window of two GOPs
                raise RuntimeError("planted decode failure")
            return super().gop(gop_idx)

    roidb, _ = eval_records(EVAL_LENGTHS)
    before = set(threading.enumerate())
    raised = None
    try:
        eval_videos_timeplex(
            model, cfg, roidb, streams=3, logger=Lines(),
            open_video=lambda path, *a, **kw: FailingVideo(
                path, *a, num_frames=EVAL_LENGTHS[path], content_hw=CONTENT, **kw))
    except RuntimeError as e:
        raised = str(e)
    check(raised == "planted decode failure",
          f"eval_videos_timeplex did not raise the producer's error (got {raised!r})")
    left = [t.name for t in set(threading.enumerate()) - before if t.is_alive()]
    check(not left, f"threads left alive after the producer's failure: {left}")
    torch.cuda.synchronize()
    print("producer failure: eval_videos_timeplex raised the planted error of a stream's second "
          "window; no thread of the call is left alive")

    # 16. the R-FCN loop at full width
    rcfg = load_config(str(RFCN_CONFIG))
    rfcn = rfcn_from_config(rcfg, device=dev)
    init_params(rfcn, torch.Generator(device=dev).manual_seed(0))
    roidb, open_video = eval_records({"synthetic-rfcn": 12})
    log = Lines()
    eval_videos_rfcn(rfcn, rcfg, roidb, logger=Lines(), open_video=open_video, max_frames=2)
    torch.cuda.synchronize()
    nms_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    dets = eval_videos_rfcn(rfcn, rcfg, roidb, logger=log, open_video=open_video)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    rfcn_launches = nms_cuda.LAUNCHES
    check_detections("eval_videos_rfcn", dets, 12)
    check(rfcn_launches == 24, f"eval_videos_rfcn: {rfcn_launches} kernel launches, not 2 x 12")
    print(f"eval_videos_rfcn: R-FCN ResNet-101 bf16 at {BUCKET[0]}x{BUCKET[1]}, one synthetic "
          f"video of 12 BGR frames (after a 2-frame warm-up call): 12 records in {seconds:.3f} s "
          f"= {12 / seconds:.1f} frames/s ({seconds / 12 * 1e3:.2f} ms/frame); nms kernel "
          f"launches {rfcn_launches} (2 per frame); {log.lines[-1]}")
    del rfcn

    # 17. the data plane does not pretend
    try:
        got = PreparedVideo("missing.mp4", cfg, BUCKET)
        fail(f"PreparedVideo('missing.mp4') returned {got!r}")
    except (RuntimeError, OSError) as e:
        if coviar.available():
            check(isinstance(e, OSError) and "missing.mp4" in str(e), f"PreparedVideo raised {e!r}")
        else:
            check(str(e) == coviar.MISSING and "libcoviar_tpu.so" in str(e)
                  and "libavcodec" in str(e), f"PreparedVideo raised {e!r}")
        print(f"data plane: coviar.available() is {coviar.available()}; "
              f"PreparedVideo('missing.mp4') raised {type(e).__name__}: {e}")
    return seq, {"eval_videos": seq_launches, "eval_timeplex": tp_launches,
                 "eval_rfcn": rfcn_launches}


def cur_rpn_masks(det, payload, nms_cuda, greedy_alive):
    """`rpn_masks` on the non-key frames of GOP `payload` (n, 2048), from
    the key feature `det` holds: the GOP's own once `det` has run it."""
    import torch

    dev = det.device
    _, smalls, mv, res, info = payload
    n = smalls.shape[0] - 1
    with torch.no_grad():
        out = det.model.forward_cur(torch.from_numpy(smalls[1:]).to(dev),
                                    det.feat_key.expand(n, -1, -1, -1),
                                    torch.from_numpy(mv[1:]).float().to(dev),
                                    torch.from_numpy(res[1:]).float().to(dev))
    return rpn_masks(out, det.anchors, torch.from_numpy(info[None]).to(dev).expand(n, 3),
                     det.cfg, nms_cuda, greedy_alive)


def mobile_config(pretrained):
    """The default config with the trunk, depth and pixel statistics that
    update_network_config derives from `pretrained`, no small net (the
    MobileNet trunks have none) and no DCN (ResNet units only): DFF_FEAT_DIM
    1024, FlowNet-S, Nq-net, R-net, 31 classes, bf16, the 608x1024 bucket,
    RPN tier 2048."""
    from lsfa_tpu_torch.config import get_default_config, update_network_config

    cfg = get_default_config()
    cfg.network.pretrained = pretrained
    update_network_config(cfg)
    cfg.network.add_small_net = False
    cfg.network.add_dcn = False
    return cfg


def mobilenet_phase(dev, nms_cuda, greedy_alive):
    """Phase 23: MobileNetV2 LSFA at full width through eval_videos (the
    checks of phase 13), the kernel's mask on this model's RPN inputs at
    (1, 2048) and (11, 2048), and 2 steps of train_net (the checks of
    phase 6). Returns (launches by path, max abs error of the masks)."""
    import torch

    from lsfa_tpu_torch.eval.driver import eval_videos
    from lsfa_tpu_torch.eval.tester import StreamingDetector
    from lsfa_tpu_torch.models.lsfa import init_params, lsfa_from_config

    cfg = mobile_config("mobilenetv2")
    n = cfg.network
    check(n.nettype == "mobilenet" and list(n.PIXEL_MEANS) == [103.94, 116.78, 123.68]
          and n.PIXEL_SCALE == 1.0, f"mobilenetv2 config: {n.nettype} {n.PIXEL_MEANS} "
          f"{n.PIXEL_SCALE}")
    model = lsfa_from_config(cfg, device=dev)
    init_params(model, torch.Generator(device=dev).manual_seed(0))
    check(type(model.backbone).__name__ == "MobileNetV2Backbone"
          and model.feat_conv_3x3.weight.shape[1] == 1280, "not the MobileNetV2 trunk")
    desc = "LSFA MobileNetV2 (1280-ch head, feat 1024) bf16"
    # a first pass over the records, not timed: cuDNN picks this trunk's
    # algorithms at each new shape (the flagship's loop of phase 13 runs
    # after phases 4-12 have done so)
    roidb, open_video = eval_records(EVAL_LENGTHS)
    eval_videos(model, cfg, roidb, logger=Lines(), open_video=open_video)
    _, eval_launches, _ = lsfa_loop("mobilenet eval_videos", eval_videos, model, cfg, nms_cuda,
                                    desc=desc)

    det = StreamingDetector(model, cfg, BUCKET)
    payloads = synth_gops(cfg, 2, 7)
    det.process_prepared_window(payloads[:1], first=True)
    key = key_rpn_masks(det, det.get_state(), payloads[1], False, nms_cuda, greedy_alive)
    det.process_prepared_window(payloads[1:])              # its key feature, for the non-key
    cur = cur_rpn_masks(det, payloads[1], nms_cuda, greedy_alive)
    err = 0.0
    for name, (got, want, boxes, valid), shape in (("key", key, (1, 2048)),
                                                   ("non-key", cur, (GOP - 1, 2048))):
        check(tuple(boxes.shape[:2]) == shape, f"mobilenet {name} RPN input {tuple(boxes.shape)}")
        check(torch.equal(got, want), f"mobilenet: kernel != plain on the {name} RPN input")
        err = max(err, float((got.int() - want.int()).abs().max()))
        print(f"mobilenet: kernel mask equals plain on the {name} frames' RPN input "
              f"{tuple(boxes.shape)}: {int(got.sum())} alive of {int(valid.sum())} valid")

    r = train_run(cfg, model, 2, nms_cuda, greedy_alive, still_ok=("nq_net.conv3.bias",))
    print(train_line(f"mobilenet train path: {desc} (float32 parameters) at {BUCKET[0]}x"
                     f"{BUCKET[1]}, B=1, 2 steps of train_net", r))
    return {"mobilenet_eval": eval_launches, "mobilenet_train": r["launches"]}, max(err, r["err"])


def hobot_phase(dev, nms_cuda):
    """Phase 24: the Hobot MobileNetV2 LSFA at full width, one GOP through
    StreamingDetector (after a warm-up GOP): finite detections, 4 kernel
    launches. Returns the launches."""
    import torch

    from lsfa_tpu_torch.eval.tester import StreamingDetector
    from lsfa_tpu_torch.models.lsfa import init_params, lsfa_from_config

    cfg = mobile_config("mobilenetv2_hobot")
    check(cfg.network.nettype == "mobilenet_hobot" and cfg.network.PIXEL_SCALE == 0.017,
          f"hobot config: {cfg.network.nettype} {cfg.network.PIXEL_SCALE}")
    model = lsfa_from_config(cfg, device=dev)
    init_params(model, torch.Generator(device=dev).manual_seed(0))
    check(type(model.backbone).__name__ == "MobileNetV2HobotBackbone"
          and model.feat_conv_3x3.weight.shape[1] == 320, "not the Hobot trunk")
    det = StreamingDetector(model, cfg, BUCKET)
    payload = synth_gops(cfg, 1, 8)
    det.process_prepared_window(payload, first=True)
    torch.cuda.synchronize()
    nms_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    kd, kv, cd, cv = det.process_prepared_window(payload, first=True)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = nms_cuda.LAUNCHES
    check(launches == 4, f"hobot: {launches} kernel launches in one GOP, not 4")
    check(tuple(kd.shape) == (1, 1, 300, 6) and tuple(cd.shape) == (1, GOP - 1, 300, 6),
          f"hobot detection shapes {tuple(kd.shape)}, {tuple(cd.shape)}")
    check(bool(torch.isfinite(kd).all() and torch.isfinite(cd).all()
               and torch.isfinite(det.feat_key).all()), "hobot: non-finite detections or carry")
    print(f"hobot: LSFA Hobot MobileNetV2 (320-ch trunk, PIXEL_SCALE 0.017, feat 1024) bf16 at "
          f"{BUCKET[0]}x{BUCKET[1]}, one GOP through StreamingDetector after a warm-up GOP: "
          f"{ms:.1f} ms/GOP = {GOP / ms * 1e3:.1f} frames/s; nms kernel launches {launches}; "
          f"valid detections {int(kv.sum())} (key), {int(cv.sum()) // (GOP - 1)} (non-key mean)")
    return launches


def batch_gop_phase(dev, model, cfg, nms_cuda, greedy_alive):
    """Phase 25: the flagship's batched-GOP graph through the port's
    demo_batch.main over a 12-frame SyntheticVideoReader GOP of 960x576
    frames: 12 frames of finite detections, 2 kernel launches at
    (12, 2048) t=0.7 and (360, 300) t=0.3 with masks equal to the plain
    version's on those inputs; ms per GOP; frame 0's maps against
    forward_key with is_first=1 on the same frame. Returns (launches, max
    abs error of the masks, the kernel's inputs at (360, 300))."""
    import torch

    from lsfa_tpu_torch.data.loader import SyntheticVideoReader
    from lsfa_tpu_torch.experiments import demo_batch

    reader = SyntheticVideoReader("synthetic-gop", 576, 960, num_frames=GOP)
    batch, info = demo_batch.prepare_gop(demo_batch.gop_frames(reader, 0), cfg, BUCKET)
    demo_batch.detect_gop(model, cfg, batch, info)           # warm-up: cuDNN picks
    kernel, seen = nms_cuda.greedy_alive_cuda, []

    def recorded(boxes, valid, thresh, sweeps):
        alive, conv = kernel(boxes, valid, thresh, sweeps)
        seen.append((boxes.clone(), valid.clone(), thresh, sweeps, alive.clone()))
        return alive, conv

    torch.cuda.synchronize()
    nms_cuda.LAUNCHES = 0
    nms_cuda.greedy_alive_cuda = recorded
    try:
        dets, valid = demo_batch.main(["--cfg", str(LSFA_CONFIG), "--video", "synthetic-gop"],
                                      open_video=lambda path: reader, model=model)
        torch.cuda.synchronize()
    finally:
        nms_cuda.greedy_alive_cuda = kernel
    launches = nms_cuda.LAUNCHES
    check(launches == 2, f"batched GOP: {launches} kernel launches, not 2")
    shapes = [(tuple(b.shape[:2]), t) for b, _, t, _, _ in seen]
    check(shapes == [((GOP, 2048), 0.7), ((GOP * 30, 300), 0.3)],
          f"batched GOP: kernel calls at {shapes}")
    err = 0.0
    for boxes, ok, thresh, sweeps, alive in seen:
        want = greedy_alive(boxes, ok, thresh, sweeps)
        check(torch.equal(alive, want), f"batched GOP: kernel != plain at {tuple(boxes.shape)}")
        err = max(err, float((alive.int() - want.int()).abs().max()))
    check(tuple(dets.shape) == (GOP, 300, 6) and bool(torch.isfinite(dets).all()),
          f"batched GOP detections {tuple(dets.shape)}")
    check(bool(valid.any(dim=1).all()), "batched GOP: a frame without valid detections")
    ms = cuda_ms(lambda: demo_batch.detect_gop(model, cfg, batch, info), reps=5)

    x = torch.from_numpy(batch).to(dev)
    fh, fw = BUCKET[0] // 16, BUCKET[1] // 16
    with torch.no_grad():
        gop_out = model.forward_batch_gop(x[:1], x[1:])
        key_out = model.forward_key(x[:1], torch.zeros((1,) + BUCKET + (3,), device=dev),
                                    torch.zeros((1, fh, fw, cfg.network.DFF_FEAT_DIM),
                                                device=dev), torch.ones(1, device=dev))
    errs = {}
    for k in ("feat", "rpn_fg", "rpn_deltas", "rfcn_cls_map", "rfcn_bbox_map"):
        a, b = gop_out[k][0].float(), key_out[k][0].float()
        errs[k] = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
    worst = max(errs.values())
    # both are the fresh bf16 key feature and its heads, at batch 12 and 1:
    # held to 2^-7 of each map's largest value (bf16 keeps 8 bits)
    check(worst <= 2 ** -7, f"batched GOP frame 0 vs forward_key: {errs}")
    print(f"batched GOP: LSFA ResNet-101 bf16 at {BUCKET[0]}x{BUCKET[1]}, demo_batch.main over a "
          f"12-frame SyntheticVideoReader GOP of 960x576: {GOP} frames of detections, valid "
          f"{valid.sum(dim=1).tolist()}; nms kernel launches {launches} at {shapes}, masks equal "
          f"plain; {ms:.1f} ms/GOP (forward_batch_gop and detection, median of 5) = "
          f"{GOP / ms * 1e3:.1f} frames/s; frame 0 against forward_key(is_first=1): max err of "
          f"the map's largest |value| {({k: f'{e:.1e}' for k, e in errs.items()})}")
    return launches, err, seen[1]


PHASE26_VARIANTS = {
    "fgfa": {"add_Nq_net": False, "add_Fgfa_net": True},
    "fnet_conv2": {"fnet_type": "conv#2"},
    "fnet_res": {"fnet_type": "res"},
    "fuse_concat": {"fuse_type": "concat"},
    "small_addv2": {"small_net_fuse_type": "addv2"},
    "small_concat": {"small_net_fuse_type": "concat"},
    "small_concatv1": {"small_net_fuse_type": "concatv1"},
    "small_concatv2": {"small_net_fuse_type": "concatv2"},
    "mobilenet": {"nettype": "mobilenet", "add_small_net": False,
                  "PIXEL_MEANS": [103.94, 116.78, 123.68]},
    "mobilenet_hobot": {"nettype": "mobilenet_hobot", "add_small_net": False,
                        "PIXEL_MEANS": [103.94, 116.78, 123.68], "PIXEL_SCALE": 0.017},
}


def variants_card_vs_cpu(dev):
    """Phase 26: every variant of the model family at tiny depth (ResNet-18
    with DCN or a MobileNet trunk, feat 64, float32), the same seeded
    weights on the card and on the CPU, through forward_key, forward_cur
    and forward_batch_gop on the same seeded inputs; and the non-local
    block inside the ResNet-18 trunk. Each output within 1e-4 of max(1,
    its largest |value| on the CPU), under the package's float32 pin."""
    import torch

    from lsfa_tpu_torch.config import load_config
    from lsfa_tpu_torch.models.lsfa import init_params, lsfa_from_config
    from lsfa_tpu_torch.models.resnet import ResNetBackbone

    h, w = 64, 112
    fh, fw = h // 16, w // 16
    rng = np.random.default_rng(26)
    data = rng.integers(0, 256, (1, h, w, 3), dtype=np.uint8)
    prev = rng.normal(0, 60, (1, h, w, 3)).astype(np.float32)
    feat = rng.normal(0, 1, (1, fh, fw, 64)).astype(np.float32)
    small = rng.integers(0, 256, (2, h // 4, w // 4, 3), dtype=np.uint8)
    mv = rng.normal(0, 1.5, (2, fh, fw, 2)).astype(np.float32)
    res = rng.normal(0, 20, (2, fh, fw, 3)).astype(np.float32)
    others = rng.integers(0, 256, (2, h, w, 3), dtype=np.uint8)

    def graphs(m, d):
        def t(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(d)

        with torch.no_grad():
            return {"forward_key": m.forward_key(t(data), t(prev), t(feat),
                                                 torch.zeros(1, device=d)),
                    "forward_cur": m.forward_cur(t(small), t(np.repeat(feat, 2, 0)), t(mv),
                                                 t(res)),
                    "forward_batch_gop": m.forward_batch_gop(t(data), t(others))}

    def rel_err(got, want):
        return float((got.cpu().float() - want.float()).abs().max()) / max(
            1.0, float(want.float().abs().max()))

    worst = {}
    for name, network in PHASE26_VARIANTS.items():
        tiny = load_config(None, overrides={
            "network": {"num_layer": 18, "DFF_FEAT_DIM": 64, "ANCHOR_SCALES": [1, 2, 4],
                        **network},
            "tpu": {"compute_dtype": "float32"}})
        cpu_model = lsfa_from_config(tiny, device="cpu").eval()
        init_params(cpu_model, torch.Generator().manual_seed(3))
        gpu_model = lsfa_from_config(tiny, device=dev).eval()
        gpu_model.load_state_dict(cpu_model.state_dict())
        ref, card = graphs(cpu_model, "cpu"), graphs(gpu_model, dev)
        worst[name] = max(rel_err(card[g][k], ref[g][k]) for g in ref for k in ref[g])
        check(worst[name] < 1e-4, f"variant {name}: card vs CPU differ by {worst[name]:.2e}")
    cpu_trunk = ResNetBackbone(18, non_local=True).eval()
    init_params(cpu_trunk, torch.Generator().manual_seed(5))
    gpu_trunk = ResNetBackbone(18, non_local=True, device=dev).eval()
    gpu_trunk.load_state_dict(cpu_trunk.state_dict())
    x = torch.from_numpy(prev).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        ref, card = cpu_trunk(x), gpu_trunk(x.to(dev))
    worst["non_local"] = max(rel_err(c, r) for c, r in zip(card, ref))
    check(worst["non_local"] < 1e-4, f"non_local trunk: card vs CPU differ by {worst['non_local']}")
    print(f"variants: tiny float32 LSFA variants card vs CPU through forward_key, forward_cur and "
          f"forward_batch_gop, and the ResNet-18 trunk with the non-local block: max err of "
          f"max(1, |value|) {({k: f'{e:.1e}' for k, e in worst.items()})}")


def float32_pin(dev, det, payloads):
    """Phase 18, the package's float32 pin: under torch's default flag a
    float32 Conv of the package on the card agrees with the float64
    convolution to float32 rounding (2e-5 of the largest output), where
    the same call without the pin is printed beside it; the cost of
    entering the pin on this host, and how often a flagship GOP enters it."""
    import torch
    import torch.nn.functional as F

    from lsfa_tpu_torch.models import layers

    g = torch.Generator(device=dev).manual_seed(5)
    conv = layers.Conv(256, 256, 3, dtype=torch.float32, device=dev)
    with torch.no_grad():
        conv.weight.normal_(0, 0.05, generator=g)
        conv.bias.zero_()
        x = torch.randn(1, 256, 38, 64, device=dev, generator=g)
        exact = F.conv2d(x.double(), conv.weight.double(), None, padding=1)
        pinned_err = float((conv(x) - exact).abs().max())
        default_err = float((F.conv2d(x, conv.weight, None, padding=1) - exact).abs().max())
    top = float(exact.abs().max())
    check(pinned_err <= 2e-5 * top,
          f"the package's float32 Conv is {pinned_err:.2e} from float64 (outputs up to {top:.1f})")
    entered = [0]
    pin = layers.full_float32

    def counting():
        entered[0] += 1
        return pin()

    layers.full_float32 = counting
    try:
        det.process_prepared_window(payloads[:1])
    finally:
        layers.full_float32 = pin
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(1000):
        with pin():
            pass
    each = (time.perf_counter() - t0) / 1000
    print(f"float32 pin: a float32 3x3 Conv(256, 256) at 38x64 under torch's default flag is "
          f"{pinned_err:.2e} from the float64 convolution (max abs, outputs up to {top:.1f}; "
          f"limit 2e-5 of that); the same call without the pin is {default_err:.2e} from it; "
          f"entering the pin costs {each * 1e6:.2f} us on this "
          f"host (mean of 1000), a flagship GOP enters it {entered[0]} times = "
          f"{entered[0] * each * 1e3:.3f} ms per GOP")


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


def distinct_weights(model, seed):
    """Move every entry of the model's state by seeded noise of a tenth of
    its mean magnitude (0.01 where it is all zero): BatchNorm statistics,
    the zero-initialized offset convs and biases included, so that a map
    that swaps or drops tensors shows. The small net is then seeded from
    the backbone again, as the importer seeds it."""
    import torch

    from lsfa_tpu_torch.train.checkpoint import seed_small_net

    g = torch.Generator(device=next(model.parameters()).device).manual_seed(seed)
    with torch.no_grad():
        for t in model.state_dict().values():
            scale = float(t.abs().mean()) or 0.01
            t.add_((torch.rand(t.shape, generator=g, device=t.device) - 0.5) * 0.2 * scale)
    model.load_state_dict(seed_small_net(model.state_dict()))


def reference_roundtrip(dev, nms_cuda, greedy_alive, tmp):
    """Phase 19: the flagship LSFA and the R-FCN at full width, from a seed
    with `distinct_weights`, through export_mxnet_lsfa into a .params
    file, the importer (tools.import_reference_checkpoint) and the
    launcher's checkpoint load (experiments.lsfa_test.load_model) into a
    fresh model on the card: the state dicts equal bit for bit, the
    detections of one GOP (LSFA) or two frames (R-FCN) equal the
    source's, and the kernel's mask equals the plain version's on the
    imported model's RPN input; then an R-FCN release with only the baked
    rfcn_bbox_*_test un-bakes to within 1e-6 relative of the live
    weights. Returns ({path: kernel launches}, max abs error of the
    masks, {"LSFA"/"R-FCN": checkpoint directory})."""
    import torch

    from lsfa_tpu_torch.config import load_config
    from lsfa_tpu_torch.eval.rfcn_tester import RFCNDetector
    from lsfa_tpu_torch.eval.tester import StreamingDetector
    from lsfa_tpu_torch.experiments.lsfa_test import load_model
    from lsfa_tpu_torch.tools import import_reference_checkpoint
    from lsfa_tpu_torch.train.driver import init_model
    from lsfa_tpu_torch.train.import_mxnet import export_mxnet_lsfa, import_mxnet_lsfa

    launches, err, ckpts = {}, 0.0, {}
    rng = np.random.default_rng(13)
    frames = np.zeros((2, 1) + BUCKET + (3,), np.uint8)
    frames[:, :, :CONTENT[0], :CONTENT[1]] = rng.integers(0, 256, (2, 1) + CONTENT + (3,),
                                                          dtype=np.uint8)
    info = np.asarray([[CONTENT[0], CONTENT[1], 600 / 576]], np.float32)
    for name, cfg_file, strict in (("LSFA", LSFA_CONFIG, "backbone,flownet"),
                                   ("R-FCN", RFCN_CONFIG, "backbone")):
        cfg = load_config(str(cfg_file))
        source = init_model(cfg, rng_seed=11, device=dev)
        distinct_weights(source, 12)
        path = tmp / f"{cfg.symbol}-0000.params"
        t0 = time.perf_counter()
        flat = export_mxnet_lsfa(source.state_dict(), str(path))
        export_s = time.perf_counter() - t0
        ckpts[name] = str(tmp / f"{cfg.symbol}_ckpt")
        t0 = time.perf_counter()
        import_reference_checkpoint.main(["--cfg", str(cfg_file), "--params", str(path),
                                          "--out", ckpts[name], "--strict", strict,
                                          "--device", str(dev)])
        tool_s = time.perf_counter() - t0
        cfg.TEST.test_epoch = 0        # the importer writes epoch 0
        t0 = time.perf_counter()
        loaded = load_model(cfg, ckpts[name], logger=Lines(), device=dev)
        load_s = time.perf_counter() - t0
        want, got = source.state_dict(), loaded.state_dict()
        check(got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want),
              f"{name}: the imported state dict differs from the source's")
        torch.cuda.synchronize()
        if name == "LSFA":
            payload = synth_gops(cfg, 1, 14, bucket=BUCKET, content=CONTENT)[0]
            ref_out = StreamingDetector(source, cfg, BUCKET).process_prepared_window(
                [payload], first=True)
            det = StreamingDetector(loaded, cfg, BUCKET)
            state0 = det.get_state()
            nms_cuda.LAUNCHES = 0
            out = det.process_prepared_window([payload], first=True)
            torch.cuda.synchronize()
            key, n_want = "roundtrip_lsfa", 4
            launches[key] = nms_cuda.LAUNCHES
            same = all(torch.equal(a, b) for a, b in zip(out, ref_out))
            got_m, want_m, boxes, valid = key_rpn_masks(det, state0, payload, True, nms_cuda,
                                                        greedy_alive)
            ran = f"1 GOP of StreamingDetector ({int(out[1].sum())} valid key-frame detections)"
        else:
            ref = RFCNDetector(source, cfg, BUCKET)
            ref_out = [ref.detect(f, info) for f in frames]
            det = RFCNDetector(loaded, cfg, BUCKET)
            nms_cuda.LAUNCHES = 0
            out = [det.detect(f, info) for f in frames]
            torch.cuda.synchronize()
            key, n_want = "roundtrip_rfcn", 2 * len(frames)
            launches[key] = nms_cuda.LAUNCHES
            same = all(torch.equal(a, b) for o, r in zip(out, ref_out) for a, b in zip(o, r))
            got_m, want_m, boxes, valid = frame_rpn_masks(det, cfg, frames[-1], info, nms_cuda,
                                                          greedy_alive)
            ran = (f"{len(frames)} frames of RFCNDetector.detect ({int(out[-1][1].sum())} valid "
                   f"detections on the last)")
        check(launches[key] == n_want, f"{name}: {launches[key]} kernel launches, not {n_want}")
        check(same, f"{name}: the imported model's detections differ from the source's")
        check(torch.equal(got_m, want_m), f"{name}: kernel != plain on the imported model's RPN "
                                          f"input")
        err = max(err, float((got_m.int() - want_m.int()).abs().max()))
        print(f"reference weights: {name} ({cfg_file.name}) at full width, seeded: "
              f"export_mxnet_lsfa wrote {len(flat)} tensors "
              f"({path.stat().st_size / 2**30:.3f} GiB) "
              f"in {export_s:.2f} s; import_reference_checkpoint read, mapped and wrote epoch 0 in "
              f"{tool_s:.2f} s; load_model (init_model + the checkpoint) {load_s:.2f} s; "
              f"{len(want)} state entries equal bit for bit; {ran} equal to the source's, "
              f"{launches[key]} kernel launches; kernel mask equals plain on the RPN input "
              f"{tuple(boxes.shape)}: {int(got_m.sum())} alive of {int(valid.sum())} valid")
        if name == "R-FCN":
            baked = dict(flat)
            w, b = baked.pop("arg:rfcn_bbox_weight"), baked.pop("arg:rfcn_bbox_bias")
            rep = b.shape[0] // 4
            stds = np.tile(np.asarray(cfg.TRAIN.BBOX_STDS, np.float32), rep)
            means = np.tile(np.asarray(cfg.TRAIN.BBOX_MEANS, np.float32), rep)
            baked["arg:rfcn_bbox_weight_test"] = w * stds[:, None, None, None]
            baked["arg:rfcn_bbox_bias_test"] = b * stds + means
            state, report = import_mxnet_lsfa(loaded.state_dict(), baked,
                                              tuple(cfg.TRAIN.BBOX_MEANS),
                                              tuple(cfg.TRAIN.BBOX_STDS))
            check(not report["unused"] and "rfcn_bbox.weight" in report["imported"],
                  f"baked release: report {report['unused']}")
            rel = 0.0
            for k, live in (("rfcn_bbox.weight", w), ("rfcn_bbox.bias", b)):
                got_k = state[k].numpy()
                check(np.allclose(got_k, live, rtol=1e-6, atol=0.0),
                      f"baked release: {k} un-baked off by {np.abs(got_k - live).max()}")
                rel = max(rel, float((np.abs(got_k - live) / np.abs(live)).max()))
            print(f"reference weights: an R-FCN release with only rfcn_bbox_*_test (baked with "
                  f"BBOX_STDS {list(cfg.TRAIN.BBOX_STDS)}): un-baked rfcn_bbox within {rel:.2e} "
                  f"relative of the live weights (limit 1e-6)")
        del source, loaded, det, flat
    return launches, err, ckpts


def launcher_phase(dev, nms_cuda, tmp, ckpt):
    """Phase 20: experiments.lsfa_test.run_test with the flagship's JSON
    config and phase 19's LSFA checkpoint over an ImageNet VID tree of two
    videos of 36 and 30 frames (960x576, seeded annotations), the streams
    given by SyntheticPreparedVideo through open_video: a finite mAP in
    [0, 1], 66 records, the kernel's launches equal to the count reckoned
    from the recorded schedule (4 per GOP, 2 per tail frame); then the same
    with streams=2, whose detections equal the sequential run's. Returns
    {path: kernel launches}."""
    import pickle

    import torch

    from lsfa_tpu_torch.config import load_config
    from lsfa_tpu_torch.data.loader import SyntheticPreparedVideo
    from lsfa_tpu_torch.experiments.lsfa_test import run_test

    lengths = {"smoke_a": 36, "smoke_b": 30}
    dataset_path = tmp / "ILSVRC2015"
    image_set = write_vid_tree(dataset_path, lengths, 576, 960, seed=15)
    streams_of = {str(dataset_path / "Data" / "VID" / "mpeg4_snippets" / "val" / f"{n}.mp4"): k
                  for n, k in lengths.items()}

    def open_video(path, *args, **kw):
        return SyntheticPreparedVideo(path, *args, num_frames=streams_of[path],
                                      content_hw=CONTENT, im_scale=600 / 576, **kw)

    n_frames = sum(lengths.values())
    launches, dets = {}, {}
    for streams, key in ((0, "launcher"), (2, "launcher_streams2")):
        cfg = load_config(str(LSFA_CONFIG), overrides={
            "output_path": str(tmp / f"out_{key}"),
            "dataset": {"root_path": str(tmp), "dataset_path": str(dataset_path),
                        "test_image_set": image_set},
            "TEST": {"test_epoch": 0}})
        calls = []
        torch.cuda.synchronize()
        nms_cuda.LAUNCHES = 0
        t0 = time.perf_counter()
        with recorded_schedule(calls):
            mean_ap, ap = run_test(cfg, ckpt_dir=ckpt, streams=streams, open_video=open_video,
                                   device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        launches[key] = nms_cuda.LAUNCHES
        out_dir = Path(cfg.output_path) / cfg.symbol / cfg.dataset.test_image_set
        with open(out_dir / "detections.pkl", "rb") as f:
            dets[key] = pickle.load(f)
        check_detections(key, dets[key], n_frames)
        check(np.isfinite(mean_ap) and 0.0 <= mean_ap <= 1.0, f"{key}: mAP {mean_ap}")
        windows = [c for c in calls if c["kind"] == "window"]
        frames = [c for c in calls if c["kind"] == "frame"]
        check(sorted(c["gops"] for c in windows) == [1, 2, 2]
              and [c["flag"] for c in frames] == [0, 2, 2, 2, 2, 2],
              f"{key}: windows {[c['gops'] for c in windows]}, frame flags "
              f"{[c['flag'] for c in frames]}")
        reckoned = 4 * sum(c["gops"] for c in windows) + 2 * len(frames)
        check(launches[key] == reckoned == 32,
              f"{key}: {launches[key]} kernel launches, {reckoned} reckoned from the schedule")
        loop_s = t1 - calls[0]["t0"]
        print(f"launcher: run_test({LSFA_CONFIG.name}, phase 19's checkpoint, streams={streams}) "
              f"over 2 videos of 36 and 30 frames: {len(dets[key])} records, mAP@0.5 "
              f"{mean_ap:.4f} over {int(np.isfinite(ap).sum())} classes with gt (seeded weights); "
              f"{t1 - t0:.2f} s in all, of it the loop {loop_s:.3f} s = {n_frames / loop_s:.1f} "
              f"frames/s; nms kernel launches {launches[key]} (4 x 5 GOPs + 2 x 6 tail frames)")
    worst = same_detections("launcher streams=2", dets["launcher_streams2"], dets["launcher"])
    print(f"launcher: streams=2 detections equal the sequential run's (max abs difference "
          f"scores {worst['scores']:.2e}, boxes {worst['boxes']:.2e})")
    return launches


def imagenet_resnet_params(rng, units=(3, 4, 23, 3)):
    """A stand-in for the reference's ImageNet ResNet file
    (resnet-101-0000.params for the default units): its names and shapes,
    written out from the architecture (bn_data with the gamma of
    fix_gamma, the stem, four stages of `units` bottleneck units with a
    projection in each first unit, bn1 and the classifier fc1), seeded
    values: convs at variance 1/fan-in, BatchNorms near identity,
    bn_data's statistics those of the frames' pixels."""
    arrays = {}

    def conv(name, o, i, k):
        arrays[f"arg:{name}_weight"] = (rng.standard_normal((o, i, k, k))
                                        / np.sqrt(i * k * k)).astype(np.float32)

    def bn(name, c, mean=0.0, var=1.0):
        arrays[f"arg:{name}_gamma"] = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
        arrays[f"arg:{name}_beta"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
        arrays[f"aux:{name}_moving_mean"] = (mean + 0.1 * rng.standard_normal(c)).astype(
            np.float32)
        arrays[f"aux:{name}_moving_var"] = (var * rng.uniform(0.8, 1.2, c)).astype(np.float32)

    bn("bn_data", 3, mean=127.5, var=73.9 ** 2)
    conv("conv0", 64, 3, 7)
    bn("bn0", 64)
    cin = 64
    for s, (n, f) in enumerate(zip(units, (256, 512, 1024, 2048)), start=1):
        for u in range(1, n + 1):
            p, mid = f"stage{s}_unit{u}", f // 4
            bn(f"{p}_bn1", cin)
            conv(f"{p}_conv1", mid, cin, 1)
            bn(f"{p}_bn2", mid)
            conv(f"{p}_conv2", mid, mid, 3)
            bn(f"{p}_bn3", mid)
            conv(f"{p}_conv3", f, mid, 1)
            if u == 1:
                conv(f"{p}_sc", f, cin, 1)
            cin = f
    bn("bn1", 2048)
    arrays["arg:fc1_weight"] = (0.01 * rng.standard_normal((1000, 2048))).astype(np.float32)
    arrays["arg:fc1_bias"] = np.zeros(1000, np.float32)
    return arrays


def flownet_s_params(rng, feat_dim=1024):
    """A stand-in for the reference's FlyingChairs FlowNet-S file: the
    names and shapes of get_flownet (resnet_v1_101_flownet_rfcn.py:150-207)
    written out, the scale map with feat_dim outputs, seeded values at
    variance 1/fan-in, the scale map's bias near 1."""
    arrays = {}
    convs = [("flow_conv1", 64, 6, 7), ("conv2", 128, 64, 5), ("conv3", 256, 128, 5),
             ("conv3_1", 256, 256, 3), ("conv4", 512, 256, 3), ("conv4_1", 512, 512, 3),
             ("conv5", 512, 512, 3), ("conv5_1", 512, 512, 3), ("conv6", 1024, 512, 3),
             ("conv6_1", 1024, 1024, 3), ("Convolution1", 2, 1024, 3),
             ("Convolution2", 2, 1026, 3), ("Convolution3", 2, 770, 3),
             ("Convolution4", 2, 386, 3), ("Convolution5", 2, 194, 3),
             ("Convolution5_scale", feat_dim, 194, 1)]
    for name, o, i, k in convs:
        arrays[f"arg:{name}_weight"] = (rng.standard_normal((o, i, k, k))
                                        / np.sqrt(i * k * k)).astype(np.float32)
        arrays[f"arg:{name}_bias"] = (0.01 * rng.standard_normal(o)
                                      + (name == "Convolution5_scale")).astype(np.float32)
    # Deconvolution weights are (in, out, 4, 4)
    for name, i, o in (("deconv5", 1024, 512), ("deconv4", 1026, 256), ("deconv3", 770, 128),
                       ("deconv2", 386, 64), ("upsample_flow6to5", 2, 2),
                       ("upsample_flow5to4", 2, 2), ("upsample_flow4to3", 2, 2),
                       ("upsample_flow3to2", 2, 2)):
        arrays[f"arg:{name}_weight"] = (rng.standard_normal((i, o, 4, 4))
                                        / np.sqrt(i * 16)).astype(np.float32)
        arrays[f"arg:{name}_bias"] = (0.01 * rng.standard_normal(o)).astype(np.float32)
    return arrays


def warm_start_phase(dev, cfg, nms_cuda, greedy_alive, tmp, rfcn_ckpt):
    """Phase 21: init_model on `cfg` (the flagship's defaults) with
    network.pretrained set to a backbone-only .params
    (`imagenet_resnet_params`, as a <prefix>-<epoch> name) and
    pretrained_flow to a FlowNet-only one
    (`flownet_s_params`): the imported tensors equal the files' before
    step 1, the small net equals the warm backbone; then train_net takes 2
    steps at the bucket (the checks of phase 6). Then pretrained_detector
    set to phase 19's R-FCN checkpoint: the shared stack transfers; and a
    checkpoint that shares nothing raises. Returns (kernel launches, max
    abs error of the masks)."""
    import torch
    from torch import nn

    from lsfa_tpu_torch.models.resnet import RESNET_UNITS
    from lsfa_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
    from lsfa_tpu_torch.train.driver import init_model
    from lsfa_tpu_torch.train.import_mxnet import torch_to_mx_name
    from lsfa_tpu_torch.utils.mxnet_io import save_params

    rng = np.random.default_rng(16)
    det_cfg = cfg.copy()
    resnet = f"resnet-{cfg.network.num_layer}"
    backbone = imagenet_resnet_params(rng, RESNET_UNITS[cfg.network.num_layer])
    flownet = flownet_s_params(rng, cfg.network.DFF_FEAT_DIM)
    save_params(str(tmp / f"{resnet}-0000.params"), backbone)
    save_params(str(tmp / "flownet-0000.params"), flownet)
    cfg.network.pretrained = str(tmp / resnet)
    cfg.network.pretrained_flow = str(tmp / "flownet-0000.params")
    log = Lines()
    t0 = time.perf_counter()
    model = init_model(cfg, rng_seed=0, device=dev, logger=log)
    init_s = time.perf_counter() - t0
    state = model.state_dict()
    files = {**backbone, **flownet}
    matched = 0
    for key, t in state.items():
        mapped = torch_to_mx_name(key)
        name = mapped and ("aux:" if key.endswith(("_mean", "_var")) else "arg:") + mapped[0]
        if name in files:
            check(torch.equal(t.cpu(), torch.from_numpy(files[name])),
                  f"warm start: {key} differs from the file's {name}")
            matched += 1
    unused = ("arg:bn_data_gamma", "arg:fc1_weight", "arg:fc1_bias")
    check(matched == len(files) - len(unused), f"warm start: {matched} of {len(files)} tensors")
    check(log.lines[-2:] == [
        f"imported {len(backbone) - 3} tensors from {cfg.network.pretrained}-0000.params "
        f"(3 unused)",
        f"imported {len(flownet)} tensors from {cfg.network.pretrained_flow} (0 unused)"],
        f"warm start log {log.lines}")
    small = [k for k in state if k.startswith("small_net_backbone.")
             and not k.endswith(("_mean", "_var"))]
    check(small and all(torch.equal(state[k], state["backbone." + k[19:]]) for k in small),
          "warm start: the small net is not the warm backbone's")
    print(f"warm start: init_model (flagship) with pretrained={resnet} "
          f"({resnet}-0000.params: {len(backbone)} tensors at the reference's ImageNet names) "
          f"and pretrained_flow=flownet-0000.params ({len(flownet)} tensors) in {init_s:.2f} s: "
          f"{matched} tensors equal the files' (bn_data_gamma, fc1_* unused), {len(small)} "
          f"small-net parameters equal the warm backbone's")
    # the FlowNet's biases come from the file at 1e-2: a flow bias's update
    # in two steps can round away (phase 6 starts them at 0)
    flow_biases = tuple(k for k, p in model.named_parameters()
                        if k.startswith("flownet.") and p.ndim == 1)
    r = train_run(cfg, model, 2, nms_cuda, greedy_alive,
                  still_ok=("nq_net.conv3.bias",) + flow_biases)
    print(train_line(f"warm start: LSFA ResNet-101 bf16 warm-started at {BUCKET[0]}x{BUCKET[1]}, "
                     f"B=1, 2 steps of train_net", r))
    launches, err = r["launches"], r["err"]
    del model, r, state

    det_cfg.network.pretrained_detector = rfcn_ckpt
    log = Lines()
    warm = init_model(det_cfg, rng_seed=1, device=dev, logger=log).state_dict()
    det_state, _ = load_checkpoint(rfcn_ckpt)
    check(all(torch.equal(warm[k].cpu(), v) for k, v in det_state["model"].items()),
          "pretrained_detector: the R-FCN's stack did not transfer")
    bogus = tmp / "bogus"
    dummy = nn.Module()
    dummy.not_a_module = nn.Linear(2, 2)
    opt = torch.optim.SGD(dummy.parameters(), lr=0.1)
    save_checkpoint(str(bogus), 1, dummy, opt,
                    torch.optim.lr_scheduler.LambdaLR(opt, lambda c: 1.0), step=0,
                    rng_state=torch.Generator().get_state())
    det_cfg.network.pretrained_detector = str(bogus)
    try:
        init_model(det_cfg, device=dev)
        fail("pretrained_detector sharing nothing did not raise")
    except ValueError as e:
        check("shares no parameter" in str(e), f"pretrained_detector raised {e!r}")
    print(f"warm start: pretrained_detector=phase 19's R-FCN checkpoint: {log.lines[-1]}; all "
          f"{len(det_state['model'])} R-FCN entries equal; a checkpoint sharing nothing raised "
          f"ValueError")
    return launches, err


TRAIN_HW = (720, 1280)                  # the train and val videos' frames
DET_HW = (375, 500)                     # the DET images'
TRAIN_CONTENT = (562, 1000)             # 720x1280 resized (562.5 rounds half to even)


def xml_annotation(rng, height, width, wnids):
    """An ImageNet VID/DET annotation of the given size with 1-3 seeded
    boxes of the classes `wnids`."""
    objs = ""
    for _ in range(int(rng.integers(1, 4))):
        x1, y1 = rng.uniform(0, width * 0.6), rng.uniform(0, height * 0.6)
        x2, y2 = x1 + rng.uniform(8, width * 0.4), y1 + rng.uniform(8, height * 0.4)
        objs += (f"<object><name>{wnids[int(rng.integers(len(wnids)))]}</name><bndbox>"
                 f"<xmin>{x1:.1f}</xmin><ymin>{y1:.1f}</ymin><xmax>{x2:.1f}</xmax>"
                 f"<ymax>{y2:.1f}</ymax></bndbox></object>")
    return (f"<annotation><size><width>{width}</width><height>{height}</height></size>"
            f"{objs}</annotation>")


def write_train_tree(dataset_path, det_images, videos, seed=0, det_hw=DET_HW,
                     video_hw=TRAIN_HW):
    """The training image sets under dataset_path: DET_train_30classes with
    `det_images` records of det_hw and VID_train_15frames with 15 evenly
    spaced frames of each video {name: frames} at video_hw (the last frame
    among them), XML annotations with seeded boxes."""
    rng = np.random.default_rng(seed)
    wnids = ("n02691156", "n02419796", "n02131653", "n02834778", "n01503061")
    root = Path(dataset_path)
    (root / "ImageSets").mkdir(parents=True, exist_ok=True)
    det_lines = []
    for i in range(det_images):
        name = f"train/det_{i:04d}"
        det_lines.append(f"{name} {i + 1}\n")
        path = root / "Annotations" / "DET" / f"{name}.xml"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(xml_annotation(rng, *det_hw, wnids))
    (root / "ImageSets" / "DET_train_30classes.txt").write_text("".join(det_lines))
    vid_lines = []
    for name, n in videos.items():
        folder = root / "Annotations" / "VID" / "train" / name
        folder.mkdir(parents=True, exist_ok=True)
        for k, fid in enumerate(np.linspace(0, n - 1, 15).round().astype(int)):
            vid_lines.append(f"train/{name} {k + 1} {fid} {n}\n")
            (folder / f"{fid:06d}.xml").write_text(xml_annotation(rng, *video_hw, wnids))
    (root / "ImageSets" / "VID_train_15frames.txt").write_text("".join(vid_lines))


def seeded_image(path, det_hw=DET_HW, video_hw=TRAIN_HW):
    """read_image's stand-in (the card's machine has no PIL): a seeded BGR
    float32 image at det_hw for a DET path, else at video_hw."""
    import zlib

    hw = det_hw if "/DET/" in str(path) else video_hw
    rng = np.random.default_rng(zlib.crc32(str(path).encode()))
    return rng.integers(0, 256, hw + (3,), dtype=np.uint8).astype(np.float32)


@contextlib.contextmanager
def env_vars(**values):
    import os

    old = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def one_step(cfg, model, state, batch, draws):
    """One LSFA train step from `state` on a device batch with given
    draws, under whatever process group is active. Returns (metrics as
    floats, the parameters after it)."""
    import torch

    from lsfa_tpu_torch.train.schedule import make_optimizer
    from lsfa_tpu_torch.train.train_step import TrainSettings, make_train_step

    model.load_state_dict(state)
    t = cfg.TRAIN
    opt, sched = make_optimizer(model, t.lr, [1000], momentum=t.momentum, wd=t.wd)
    metrics = make_train_step(model, TrainSettings.from_config(cfg), opt, sched)(batch, draws)
    torch.cuda.synchronize()
    return ({k: float(v) for k, v in metrics.items()},
            {k: p.detach().clone() for k, p in model.named_parameters()})


def train_test_phase(dev, nms_cuda, greedy_alive, tmp):
    """Phase 22: the train+test launcher over a DET+VID tree (see the
    module docstring). Returns ({path: kernel launches}, max abs error of
    the kernel's mask against the plain version's)."""
    import logging
    import socket

    import torch

    from lsfa_tpu_torch.config import load_config
    from lsfa_tpu_torch.data.loader import (
        SyntheticPreparedVideo, SyntheticVideoReader, TrainLoader, batch_to_device,
        load_pair_sample)
    from lsfa_tpu_torch.experiments import lsfa_end2end_train_test as launcher
    from lsfa_tpu_torch.models.lsfa import lsfa_from_config
    from lsfa_tpu_torch.parallel import mesh
    from lsfa_tpu_torch.train import driver
    from lsfa_tpu_torch.train.checkpoint import load_checkpoint
    from lsfa_tpu_torch.train.schedule import frozen_names
    from lsfa_tpu_torch.train.train_step import TrainSettings, draw_uniforms

    dataset_path = tmp / "ILSVRC2015_train"
    train_videos = {"vid_a": 36, "vid_b": 36}
    write_train_tree(dataset_path, 4, train_videos, seed=22)
    val_lengths = {"val_a": 24, "val_b": 18}
    image_set = write_vid_tree(dataset_path, val_lengths, *TRAIN_HW, seed=23)
    # vid_b's stream ends a frame before its annotation, as val_b's does:
    # its last frame takes read_image in the train feed and in run_test
    frames_of = {"vid_a": 36, "vid_b": 35, "val_a": 24, "val_b": 17}

    def stream(path):
        return frames_of[Path(path).stem]

    def open_video(path):
        return SyntheticVideoReader(path, *TRAIN_HW, num_frames=stream(path))

    def open_eval_video(path, *args, **kw):
        return SyntheticPreparedVideo(path, *args, num_frames=stream(path),
                                      content_hw=TRAIN_CONTENT, im_scale=1000 / 1280, **kw)

    twin = json.loads(LSFA_CONFIG.read_text())
    twin["output_path"] = str(tmp / "out_train_test")
    twin["dataset"].update(root_path=str(tmp / "root_train_test"),
                           dataset_path=str(dataset_path), test_image_set=image_set)
    # phase 21's seeded ImageNet ResNet-101 and FlowNet-S files: a trainer
    # starts from them, and a random trunk's losses reach 1e5
    twin["network"].update(pretrained=str(tmp / "resnet-101"),
                           pretrained_flow=str(tmp / "flownet-0000.params"))
    twin["TEST"]["test_epoch"] = 0
    cfg_path = tmp / "lsfa_train_test.json"
    cfg_path.write_text(json.dumps(twin))
    cfg = load_config(str(cfg_path))

    t0 = time.perf_counter()
    roidb = driver.load_train_roidb(cfg)
    roidb_s = time.perf_counter() - t0
    n_det = sum("pattern" not in r for r in roidb)
    check(len(roidb) == 2 * (4 + 30) and n_det == 8 and sum(r["flipped"] for r in roidb) == 34,
          f"load_train_roidb: {len(roidb)} records, {n_det} DET")

    # the host chain per sample (a video frame mid-GOP, a DET image)
    mid = next(r for r in roidb if r.get("frame_seg_id", 0) % GOP == 5 and not r["flipped"])
    det_rec = next(r for r in roidb if "pattern" not in r)
    chain_ms = {}
    for name, rec in (("video", mid), ("DET", det_rec)):
        t0 = time.perf_counter()
        for k in range(3):
            load_pair_sample(rec, cfg, np.random.default_rng(k), open_video=open_video,
                             read_image=seeded_image)
        chain_ms[name] = (time.perf_counter() - t0) / 3 * 1e3

    # a step through the distributed path at world size 1 against the same
    # step without a process group: same state, batch and draws
    model = driver.init_model(cfg, 0, dev)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    loader = TrainLoader(roidb, cfg, 1, num_workers=1, open_video=open_video,
                         read_image=seeded_image)
    batch = batch_to_device(next(iter(loader)), dev)
    draws = draw_uniforms(TrainSettings.from_config(cfg), batch,
                          torch.Generator(device=dev).manual_seed(5))
    nms_cuda.LAUNCHES = 0
    plain = [one_step(cfg, model, state, batch, draws) for _ in range(2)]
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=port, WORLD_SIZE=1, RANK=0, LOCAL_RANK=0)
    with env_vars(**env):
        check(mesh.initialize_distributed() == torch.device("cuda", 0), "rank's device")
        try:
            check(torch.distributed.get_backend() == "nccl" and mesh.world_size() == 1,
                  f"process group {torch.distributed.get_backend()}, world {mesh.world_size()}")
            dist_m, dist_p = one_step(cfg, model, state, batch, draws)
            check_launches = nms_cuda.LAUNCHES
            (m0, p0), (_, p1) = plain
            spread = max(float((p1[k] - p0[k]).abs().max()) for k in p0)
            met_err = max(abs(dist_m[k] - m0[k]) / max(abs(m0[k]), 1e-12) for k in m0)
            par_err = max(float(((dist_p[k] - p0[k]).abs() / p0[k].abs().clamp(min=1.0)).max())
                          for k in p0)
            check(all(np.isfinite(v) for v in dist_m.values()), f"distributed step {dist_m}")
            check(met_err <= 1e-5 and par_err <= 1e-6,
                  f"the step through NCCL at world size 1 differs from the plain step: metrics "
                  f"{met_err:.2e} relative, parameters {par_err:.2e}")
            # the gradients' reduction alone (flat buffer, NCCL, copy back)
            n_grads = sum(p.grad.numel() for p in model.parameters() if p.grad is not None)
            reduce_ms = cuda_ms(lambda: mesh.all_reduce_gradients(model), reps=10)
            del model, state, plain, dist_p, batch

            # the launcher under the process group: train_net over the roidb,
            # then run_test on the model just trained
            steps, seen, last_train = [], {}, {}
            kernel, made = nms_cuda.greedy_alive_cuda, driver.make_train_step

            def recorded(boxes, valid, thresh, sweeps):
                alive, conv = kernel(boxes, valid, thresh, sweeps)
                seen.update(boxes=boxes.clone(), valid=valid.clone(), thresh=thresh,
                            sweeps=sweeps, alive=alive.clone())
                return alive, conv

            def recording(*a, **kw):
                step = made(*a, **kw)

                def run(batch, draws):
                    metrics = step(batch, draws)
                    end = torch.cuda.Event(enable_timing=True)
                    end.record()
                    steps.append((metrics, end, nms_cuda.LAUNCHES, tuple(batch["data"].shape)))
                    last_train.update(seen)
                    return metrics
                return run

            log = Lines()
            handler = logging.Handler()
            handler.emit = lambda record: log.info(record.getMessage())
            logger = logging.getLogger(f"lsfa_tpu_torch.{cfg.symbol}.{cfg.dataset.image_set}")
            logger.addHandler(handler)
            calls = []
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            nms_cuda.LAUNCHES = 0
            nms_cuda.greedy_alive_cuda, driver.make_train_step = recorded, recording
            t0 = time.perf_counter()
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            try:
                with recorded_schedule(calls):
                    mean_ap, ap = launcher.main(["--cfg", str(cfg_path), "--max-steps", "4"],
                                                open_video=open_video, read_image=seeded_image,
                                                open_eval_video=open_eval_video)
            finally:
                nms_cuda.greedy_alive_cuda, driver.make_train_step = kernel, made
                logger.removeHandler(handler)
            torch.cuda.synchronize()
            t_end = time.perf_counter()
            wall = t_end - t0
            launches = nms_cuda.LAUNCHES
            check(mesh.active(), "the launcher ended a process group it did not start")
        finally:
            torch.distributed.destroy_process_group()
    peak = torch.cuda.max_memory_allocated(dev)

    check(len(steps) == 4, f"the launcher ran {len(steps)} train steps, not 4")
    check([n for _, _, n, _ in steps] == [1, 2, 3, 4],
          f"kernel launches after each step {[n for _, _, n, _ in steps]}, not one per step")
    for i, (m, _, _, _) in enumerate(steps):
        bad = [k for k, v in m.items() if not bool(torch.isfinite(v))]
        check(not bad, f"launcher train step {i}: non-finite {bad}")
    want = greedy_alive(last_train["boxes"], last_train["valid"], last_train["thresh"],
                        last_train["sweeps"])
    check(torch.equal(last_train["alive"], want),
          "kernel != plain on the launcher's last train step's RPN input")
    err = float((last_train["alive"].int() - want.int()).abs().max())
    windows = [c for c in calls if c["kind"] == "window"]
    frames = [c for c in calls if c["kind"] == "frame"]
    check(sorted(c["gops"] for c in windows) == [1, 2] and [c["flag"] for c in frames]
          == [0, 2, 2, 2, 2, 2], f"run_test windows {[c['gops'] for c in windows]}, frame "
          f"flags {[c['flag'] for c in frames]}")
    test_launches = launches - 4
    reckoned = 4 * sum(c["gops"] for c in windows) + 2 * len(frames)
    check(test_launches == reckoned == 24,
          f"run_test: {test_launches} kernel launches, {reckoned} reckoned from the schedule")
    check(np.isfinite(mean_ap) and 0.0 <= mean_ap <= 1.0, f"launcher mAP {mean_ap}")
    summary = [line for line in log.lines if line.startswith("feed summary")]
    check(len(summary) == 1, f"feed summary lines {summary}")

    ckpt_dir = (Path(cfg.output_path) / cfg.symbol / cfg.dataset.image_set / "checkpoints"
                / cfg.TRAIN.model_prefix)
    saved, epoch = load_checkpoint(str(ckpt_dir))
    check(epoch == 1 and saved["step"] == 4, f"checkpoint epoch {epoch}, step {saved['step']}")
    reloaded = lsfa_from_config(cfg, device=dev)
    reloaded.load_state_dict(saved["model"])
    fresh = driver.init_model(cfg, 0, dev)
    frozen = frozen_names(fresh)
    init = fresh.state_dict()
    moved = [k for k in frozen if not torch.equal(saved["model"][k], init[k].cpu())]
    check(not moved, f"the launcher moved frozen parameters {moved[:5]}")
    trainable = [k for k, _ in fresh.named_parameters() if k not in frozen]
    trained = [k for k in trainable if not torch.equal(saved["model"][k], init[k].cpu())]
    # a bias whose gradient cancels (nq_net.conv3's) or is tiny may not move
    check(len(trained) >= 0.95 * len(trainable),
          f"{len(trained)} of {len(trainable)} trainable parameters moved")
    del reloaded, fresh, init

    ms = [start.elapsed_time(steps[0][1])] + [
        a[1].elapsed_time(b[1]) for a, b in zip(steps, steps[1:])]
    test_frames = sum(val_lengths.values())
    test_s = t_end - calls[0]["t0"]
    print(f"train+test launcher: load_train_roidb {len(roidb)} records ({n_det} DET, flipped "
          f"copies included) in {roidb_s:.3f} s; host chain per sample (720x1280 video frame "
          f"with its two key frames, MV and residual; 375x500 DET image) "
          f"{chain_ms['video']:.1f} / {chain_ms['DET']:.1f} ms; a step through NCCL at world "
          f"size 1 equals the plain step (metrics {met_err:.2e} relative, parameters "
          f"{par_err:.2e} of max(1, |p|); two plain steps differ by {spread:.2e}) in "
          f"{check_launches} launches; all_reduce_gradients over {n_grads} gradients "
          f"{reduce_ms:.3f} ms (median of 10)")
    print(f"train+test launcher: main(--max-steps 4) under NCCL world size 1 in {wall:.2f} s: "
          f"train steps at {[s[3][1:3] for s in steps]}, ms per step "
          f"{[round(x, 2) for x in ms]} (the first includes the warm-up and the loader's first "
          f"batch), peak memory {peak / 2**30:.2f} GiB; {summary[0]}; checkpoint epoch 1 "
          f"reloads, {len(frozen)} frozen parameters unchanged, {len(trained)} of "
          f"{len(trainable)} trainable moved; run_test on the trained model over 2 videos of 24 "
          f"and 18 frames (val_b's last past its stream, through read_image and the host "
          f"chain): mAP@0.5 {mean_ap:.4f} over {int(np.isfinite(ap).sum())} classes, "
          f"{test_frames} frames from the first window to the end in {test_s:.3f} s = "
          f"{test_frames / test_s:.1f} frames/s; nms kernel launches {launches} (4 train steps "
          f"+ 4 x 3 GOPs + 2 x 6 tail frames)")
    return {"ddp_world1_steps": check_launches, "train_test_train": 4,
            "train_test_test": test_launches}, err


def read_png(path):
    """An 8-bit RGB PNG as (H, W, 3) uint8: chunks and CRCs checked, rows
    of filter type 0 only (what utils.vis.write_png writes)."""
    import struct
    import zlib

    data = Path(path).read_bytes()
    check(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path}: not a PNG")
    pos, idat, size = 8, b"", None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        check(zlib.crc32(kind + body) & 0xFFFFFFFF == crc, f"{path}: bad CRC in {kind!r}")
        if kind == b"IHDR":
            w, h, depth, color = struct.unpack(">IIBB", body[:10])
            check((depth, color) == (8, 2), f"{path}: depth {depth}, color type {color}")
            size = (h, w)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    h, w = size
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    check(not rows[:, 0].any(), f"{path}: a row filter other than 0")
    return rows[:, 1:].reshape(h, w, 3)


def demo_phase(dev, model, nms_cuda, tmp):
    """Phase 28: the annotated demo at full width, and run_test's --vis.
    Returns {path: kernel launches}."""
    import io

    import torch

    from lsfa_tpu_torch.config import load_config
    from lsfa_tpu_torch.data.loader import SyntheticPreparedVideo, SyntheticVideoReader
    from lsfa_tpu_torch.experiments import demo
    from lsfa_tpu_torch.experiments.lsfa_test import run_test
    from lsfa_tpu_torch.utils import vis

    n = 24
    out = tmp / "demo_frames"
    written = []
    write_png = vis.write_png

    def timed_write(path, rgb):
        t0 = time.perf_counter()
        write_png(path, rgb)
        written.append(time.perf_counter() - t0)

    text = io.StringIO()
    torch.cuda.synchronize()
    nms_cuda.LAUNCHES = 0
    vis.write_png = timed_write
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(text):
            frames = demo.main(["--cfg", str(LSFA_CONFIG), "--video", str(tmp / "demo.mp4"),
                                "--out", str(out), "--max-frames", str(n)],
                               open_video=lambda p: SyntheticVideoReader(p, *TRAIN_HW,
                                                                         num_frames=n),
                               model=model)
    finally:
        vis.write_png = write_png
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"demo": nms_cuda.LAUNCHES}
    lines = [ln for ln in text.getvalue().splitlines() if ln.startswith("frame ")]
    flags = [0] + [2] * 11 + [1] + [2] * 11
    check([f for f, _ in frames] == flags and len(lines) == n
          and [ln.split()[2] for ln in lines] == [f"flag={f}" for f in flags],
          f"demo: frame lines {lines[:3]}..., flags {[f for f, _ in frames]}")
    check(launches["demo"] == 2 * n, f"demo: {launches['demo']} kernel launches, not 2 per frame")
    pngs = sorted(out.iterdir())
    check([p.name for p in pngs] == [f"{i:06d}.png" for i in range(n)], f"demo wrote {pngs[:3]}")
    for p in pngs:
        check(read_png(p).shape == TRAIN_HW + (3,), f"{p.name}: {read_png(p).shape}")
    for _, d in frames:
        check(bool(np.isfinite(d["scores"]).all() and np.isfinite(d["boxes"]).all()),
              "demo: non-finite detections")
    n_dets = [len(d["labels"]) for _, d in frames]
    print(f"demo: experiments.demo.main over {n} frames of a {TRAIN_HW[0]}x{TRAIN_HW[1]} "
          f"SyntheticVideoReader stream, the flagship of phase 4 at {BUCKET[0]}x{BUCKET[1]}: "
          f"{n} PNGs read back at {TRAIN_HW[0]}x{TRAIN_HW[1]}x3, flags 0, 2 x 11, 1, 2 x 11, "
          f"{launches['demo']} kernel launches (2 per frame); {n / wall:.2f} frames/s over "
          f"{wall:.2f} s with the host chain, drawing and writing; write_png "
          f"{statistics.median(written) * 1e3:.1f} ms per PNG (median); detections per frame "
          f"{min(n_dets)}-{max(n_dets)}")

    # run_test's --vis over a one-video tree
    dataset_path = tmp / "ILSVRC2015_vis"
    image_set = write_vid_tree(dataset_path, {"vis_a": 14}, 576, 960, seed=28)
    cfg = load_config(str(LSFA_CONFIG), overrides={
        "output_path": str(tmp / "out_vis"),
        "dataset": {"root_path": str(tmp), "dataset_path": str(dataset_path),
                    "test_image_set": image_set}})

    def open_video(path, *args, **kw):
        return SyntheticPreparedVideo(path, *args, num_frames=14, content_hw=CONTENT,
                                      im_scale=600 / 576, **kw)

    nms_cuda.LAUNCHES = 0
    run_test(cfg, vis_frames=4, open_video=open_video, model=model,
             read_image=lambda p: seeded_image(p, video_hw=(576, 960)))
    launches["launcher_vis"] = nms_cuda.LAUNCHES
    vis_dir = Path(cfg.output_path) / cfg.symbol / cfg.dataset.test_image_set / "vis"
    shots = sorted(vis_dir.iterdir())
    check(len(shots) == 4 and all(read_png(p).shape == (576, 960, 3) for p in shots),
          f"run_test(vis_frames=4) wrote {[p.name for p in shots]}")
    check(launches["launcher_vis"] == 4 + 2 * 2,
          f"run_test for --vis: {launches['launcher_vis']} kernel launches, not 4 + 2 x 2")
    print(f"demo: run_test(vis_frames=4) over a 14-frame video wrote {[p.name for p in shots]} "
          f"at 576x960x3; {launches['launcher_vis']} kernel launches (one GOP, 2 tail frames)")
    return launches


def overfit_phase(nms_cuda):
    """Phase 29: learn->detect on the card. Returns kernel launches."""
    import torch

    from lsfa_tpu_torch.tools import overfit_smoke

    report = {}
    text = []
    torch.cuda.synchronize()
    nms_cuda.LAUNCHES = 0
    rc = overfit_smoke.main(report=report, log=text.append)
    torch.cuda.synchronize()
    launches = nms_cuda.LAUNCHES
    ap = float(report["ap"][overfit_smoke.GT_CLASS - 1])
    check(rc == 0 and ap > overfit_smoke.AP_GATE,
          f"overfit_smoke on the card returned {rc}, AP[class 3] {ap}: {text}")
    hist = report["history"]
    check(len(hist) == 80 and all(np.isfinite(m["total_loss"]) for m in hist),
          f"overfit_smoke: {len(hist)} steps")
    check(launches == 80 + 2, f"overfit_smoke: {launches} kernel launches, not 80 steps + 2")
    d = report["detections"]
    top = [f"cls {d['labels'][t]} score {d['scores'][t]:.3f} box "
           f"{[round(float(x), 1) for x in d['boxes'][t]]}" for t in np.argsort(-d["scores"])[:3]]
    print(f"learn->detect: tools.overfit_smoke.main() on the card (tiny LSFA, 80 steps of "
          f"SGD 2e-3): returned {rc}, AP[class 3] {ap:.3f} (gate > {overfit_smoke.AP_GATE}); "
          f"total_loss at steps 0/20/40/60/79 "
          f"{[round(hist[i]['total_loss'], 4) for i in (0, 20, 40, 60, 79)]}; "
          f"{report['train_seconds'] / 80 * 1e3:.2f} ms per step (host clock, metrics read at "
          f"5 steps); top-3 {top}; {launches} kernel launches (80 steps + 2 in detection)")
    return launches


def pretrain_flow_phase(dev, nms_cuda, tmp):
    """Phase 30: FlowNet-S pretraining at full width, its checkpoint as
    the flagship's warm start, and a tiny step card against CPU."""
    import torch

    from lsfa_tpu_torch.config import get_default_config
    from lsfa_tpu_torch.models.flownet import FlowNetS
    from lsfa_tpu_torch.models.lsfa import init_params
    from lsfa_tpu_torch.tools import pretrain_flow
    from lsfa_tpu_torch.train.driver import init_model

    out = tmp / "flow_ckpt"
    steps, n_videos, n_frames = 40, 2, 13           # offsets reach 12 frames
    t0 = time.perf_counter()
    clips = RenderedSynthDataset()
    clips(str(tmp / "flow"), n_videos=n_videos, n_frames=n_frames, sizes=pretrain_flow.SIZES,
          profile="hard")
    opener = clips.train_reader
    report = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    nms_cuda.LAUNCHES = 0
    rc = pretrain_flow.main(["--steps", str(steps), "--batch", "4", "--feat-dim", "1024",
                             "--videos", str(n_videos), "--frames", str(n_frames),
                             "--log-every", "10", "--out", str(out), "--data", str(tmp / "flow")],
                            open_video=opener, report=report)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    wall = time.perf_counter() - t0
    check(rc == 0 and nms_cuda.LAUNCHES == 0, f"pretrain_flow: rc {rc}, {nms_cuda.LAUNCHES} "
                                              f"kernel launches")
    logged = report["logged"]
    check(all(np.isfinite(x) for _, a, b in logged for x in (a, b)), f"pretrain_flow {logged}")
    summary = json.loads((out / "flow_pretrain.json").read_text())
    saved = torch.load(out / f"{steps}.pt", map_location="cpu", weights_only=True)["model"]
    cfg = get_default_config()
    cfg.network.pretrained_flow = str(out)
    warm = init_model(cfg, 0, dev).state_dict()
    diff = [k for k in saved if not torch.equal(warm[k].cpu(), saved[k])]
    check(not diff and len(saved) > 0, f"the warm start differs from the checkpoint in {diff[:3]}")
    del warm

    # one tiny step, card against CPU, from the same weights and pairs
    cpu = FlowNetS(feat_dim=32)
    init_params(cpu, torch.Generator().manual_seed(1))
    card = FlowNetS(feat_dim=32, device=dev)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(30)
    cur = torch.from_numpy(rng.integers(0, 256, (2, 96, 128, 3)).astype(np.float32))
    old = torch.roll(cur, 3, dims=2)
    losses = [pretrain_flow.make_step(m, 1e-4, 0.01)(cur.to(d), old.to(d))
              for m, d in ((cpu, "cpu"), (card, dev))]
    err = max(abs(float(a) - float(b)) / max(1.0, abs(float(a)))
              for a, b in zip(losses[0], losses[1]))
    check(err <= 1e-5, f"pretrain_flow tiny step card vs CPU: {err:.2e}")
    print(f"flow pretraining: tools.pretrain_flow.main at feat_dim 1024, batch 4, {steps} steps "
          f"over 960x576 and 576x960 clips rendered in memory ({n_videos} x {n_frames} frames): "
          f"returned {rc}, losses finite at steps {[s for s, _, _ in logged]}, photo_first "
          f"{summary['photo_first']}, photo_final {summary['photo_final']}; "
          f"{report['seconds'] / steps * 1e3:.1f} ms per step (host clock, pairs drawn on the "
          f"host), peak {peak / 2**30:.2f} GiB, {wall:.1f} s with rendering; the checkpoint "
          f"warm-starts the flagship through init_model(pretrained_flow): {len(saved)} FlowNet "
          f"tensors bit-equal; a tiny step card vs CPU: loss and photo within {err:.2e} of "
          f"max(1, |x|); 0 kernel launches")


def bn_allreduce_phase(dev, nms_cuda):
    """Phase 31: the train-mode BatchNorms through the all-reduce path: a
    flagship step with res_diff_bn and small_net_bn_before_fuse under NCCL
    at world size 1 against the same step with no process group. Returns
    kernel launches."""
    import socket

    import torch

    from lsfa_tpu_torch.config import load_config
    from lsfa_tpu_torch.data.loader import batch_to_device, synthetic_train_batches
    from lsfa_tpu_torch.parallel import mesh
    from lsfa_tpu_torch.train.driver import init_model
    from lsfa_tpu_torch.train.train_step import TrainSettings, draw_uniforms

    cfg = load_config(None, overrides={"network": BN_VARIANTS})
    model = init_model(cfg, 0, dev)
    calibrate_input_bn(model)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    host = synthetic_train_batches(1, BUCKET, seed=31, num_classes=cfg.dataset.NUM_CLASSES,
                                   max_gt=cfg.tpu.max_gt_boxes, content_hw=CONTENT)[0]
    host["eq_flag"][:] = 0.0                 # the R-net and the small-net fusion run
    batch = batch_to_device(host, dev)
    draws = draw_uniforms(TrainSettings.from_config(cfg), batch,
                          torch.Generator(device=dev).manual_seed(31))
    reduced = []
    sums = mesh.sum_over_ranks_with_grad

    def counted(t):
        reduced.append(tuple(t.shape))
        return sums(t)

    def step():
        metrics, params = one_step(cfg, model, state, batch, draws)
        stats = {k: v.detach().clone() for k, v in model.named_buffers()
                 if k.endswith(("running_mean", "running_var"))}
        return metrics, params, stats

    nms_cuda.LAUNCHES = 0
    plain = [step() for _ in range(2)]
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=port, WORLD_SIZE=1, RANK=0, LOCAL_RANK=0)
    mesh.sum_over_ranks_with_grad = counted
    try:
        with env_vars(**env):
            mesh.initialize_distributed()
            try:
                check(torch.distributed.get_backend() == "nccl", "backend")
                dist_m, dist_p, dist_s = step()
            finally:
                torch.distributed.destroy_process_group()
    finally:
        mesh.sum_over_ranks_with_grad = sums
    launches = nms_cuda.LAUNCHES
    (m0, p0, s0), (_, p1, _) = plain
    check(len(reduced) == 3, f"the step entered the BatchNorms' all-reduce {len(reduced)} times")
    met_err = max(abs(dist_m[k] - m0[k]) / max(abs(m0[k]), 1e-12) for k in m0)
    par_err = max(float(((dist_p[k] - p0[k]).abs() / p0[k].abs().clamp(min=1.0)).max())
                  for k in p0)
    stat_err = max(float(((dist_s[k] - s0[k]).abs() / s0[k].abs().clamp(min=1.0)).max())
                   for k in s0)
    spread = max(float((p1[k] - p0[k]).abs().max()) for k in p0)
    check(all(np.isfinite(v) for v in dist_m.values()), f"BN step under NCCL {dist_m}")
    check(met_err <= 1e-5 and par_err <= 1e-6 and stat_err <= 1e-4,
          f"the BN step through NCCL differs from the plain step: metrics {met_err:.2e}, "
          f"parameters {par_err:.2e}, running statistics {stat_err:.2e}")
    check(launches == 3, f"BN all-reduce phase: {launches} kernel launches, not 3 steps")
    del model, state, plain
    print(f"BN all-reduce: the flagship with res_diff_bn and small_net_bn_before_fuse, one step "
          f"under NCCL at world size 1 (the moments of the 3 train-mode BatchNorms summed in "
          f"{len(reduced)} differentiable all-reduces, shapes {sorted(set(reduced))}) equals the "
          f"step with no process group: metrics {met_err:.2e} relative, parameters "
          f"{par_err:.2e} and running statistics {stat_err:.2e} of max(1, |x|) (two plain steps "
          f"differ by {spread:.2e}); {launches} kernel launches")
    return launches


def bf16_params_phase(dev, nms_cuda):
    """Phase 32: the flagship with tpu.param_dtype bfloat16. Returns
    {path: kernel launches}."""
    import torch

    from lsfa_tpu_torch.config import load_config
    from lsfa_tpu_torch.data.loader import synthetic_train_batches
    from lsfa_tpu_torch.eval.tester import StreamingDetector
    from lsfa_tpu_torch.train.driver import init_model, train_net

    cfg = load_config(None, overrides={"tpu": {"param_dtype": "bfloat16"}})
    model = init_model(cfg, 0, dev)
    params = list(model.parameters())
    check({p.dtype for p in params} == {torch.bfloat16}, "bf16 storage")
    check(all(b.dtype != torch.bfloat16 for b in model.buffers()), "bf16 buffers")
    gib = sum(p.numel() * p.element_size() for p in params) / 2**30
    gib32 = sum(p.numel() * 4 for p in params) / 2**30
    calibrate_input_bn(model)
    det = StreamingDetector(model, cfg, BUCKET)
    torch.cuda.synchronize()
    nms_cuda.LAUNCHES = 0
    kd, kv, cd, cv = det.process_prepared_window(synth_gops(cfg, 1, 32), first=True)
    torch.cuda.synchronize()
    launches = {"bf16_gop": nms_cuda.LAUNCHES}
    check(bool(torch.isfinite(kd).all() and torch.isfinite(cd).all()) and int(kv.sum()) > 0,
          "bf16 parameters: non-finite or no detections")
    check(launches["bf16_gop"] == 4, f"bf16 GOP: {launches['bf16_gop']} kernel launches")
    metrics = []
    batches = synthetic_train_batches(1, BUCKET, seed=32, num_classes=cfg.dataset.NUM_CLASSES,
                                      max_gt=cfg.tpu.max_gt_boxes, content_hw=CONTENT)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    nms_cuda.LAUNCHES = 0
    train_net(cfg, batches=batches, max_steps=1, model=model,
              metrics_hook=lambda s, m: metrics.append({k: float(v) for k, v in m.items()}))
    launches["bf16_train"] = nms_cuda.LAUNCHES
    check(len(metrics) == 1 and all(np.isfinite(v) for v in metrics[0].values()),
          f"bf16 train step {metrics}")
    check({p.dtype for p in model.parameters()} == {torch.bfloat16}, "bf16 after the step")
    moved = sum(not torch.equal(p, before[k]) for k, p in model.named_parameters())
    check(moved > 0 and launches["bf16_train"] == 1,
          f"bf16 step: {moved} parameters moved, {launches['bf16_train']} launches")
    print(f"bf16 parameters: the flagship with tpu.param_dtype bfloat16 holds {gib:.3f} GiB of "
          f"parameters ({gib32:.3f} GiB in float32), BatchNorm statistics float32; one GOP "
          f"through StreamingDetector: finite, {int(kv.sum())} + {int(cv.sum())} valid "
          f"detections, {launches['bf16_gop']} kernel launches; one train_net step: total_loss "
          f"{metrics[0]['total_loss']:.4f}, {moved} parameters moved, all still bfloat16, "
          f"{launches['bf16_train']} launch")
    return launches


def jpeg_eval_phase(dev, model, cfg, nms_cuda):
    """Phase 33: eval_videos over a record of JPEG frames (pattern, no
    video_path), read through a seeded read_image. Returns kernel
    launches."""
    import torch

    from lsfa_tpu_torch.data.loader import EvalLoader
    from lsfa_tpu_torch.eval.driver import eval_videos

    n = 14
    rec = {"vid_path": "jpeg_video", "frame_seg_len": n, "pattern": "jpeg_video/%06d.JPEG",
           "height": TRAIN_HW[0], "width": TRAIN_HW[1]}
    items = list(EvalLoader([rec], cfg, read_image=seeded_image))
    check(all(not i["motion_vector"].any() and not i["res_diff"].any() for i in items),
          "a JPEG record's MV or residual grid is not zero")
    calls = []
    torch.cuda.synchronize()
    nms_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    with recorded_schedule(calls):
        dets = eval_videos(model, cfg, [rec], read_image=seeded_image, logger=Lines())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = nms_cuda.LAUNCHES
    check_detections("jpeg eval", dets, n)
    check([c["kind"] for c in calls] == ["frame"] * n
          and [c["flag"] for c in calls] == [0] + [2] * 11 + [1, 2],
          f"jpeg eval schedule {[(c['kind'], c.get('flag')) for c in calls]}")
    check(launches == 2 * n, f"jpeg eval: {launches} kernel launches, not 2 per frame")
    print(f"jpeg eval: eval_videos over a record of {n} JPEG frames of {TRAIN_HW[0]}x"
          f"{TRAIN_HW[1]} (pattern, no video_path; a seeded read_image): the per-frame path, "
          f"flags 0, 2 x 11, 1, 2, zero MV and residual grids, {len(dets)} finite records, "
          f"{launches} kernel launches (2 per frame); {n / wall:.2f} frames/s with the host "
          f"chain")
    return launches


class RenderedSynthDataset:
    """data.synth.make_synth_vid_dataset's signature and returns, the clips
    rendered in memory and never encoded (nothing on the card's machine
    encodes): the same generator parameters and tag, video paths, boxes,
    classes and oracle states, the frames kept by path (`clips`). A second
    call with the same arguments returns the same clips, as the dataset's
    cache does. `train_reader` and `prepared` open them for the training
    feed and the evaluation loops. The clips have no codec MVs or
    residuals: their MVs are zero, their residuals zero."""

    def __init__(self):
        self.clips = {}                  # video path -> (N, H, W, 3) uint8 BGR frames
        self.sets = {}                   # (out_dir, tag) -> (meta, oracle states)

    def __call__(self, out_dir, n_videos=8, n_frames=60, seed=0, sizes=((960, 576), (576, 960)),
                 gop_size=12, min_objects=1, max_objects=3, split="train", profile="easy",
                 oracle=False, **knobs):
        import os

        from lsfa_tpu_torch.data.synth import _gen_params, render_video, synth_records

        params, _, min_objects, max_objects, tag = _gen_params(
            n_videos, n_frames, seed, sizes, gop_size, min_objects, max_objects, profile, split,
            knobs)
        if (out_dir, tag) not in self.sets:
            rng = np.random.default_rng(seed)
            meta, states = [], []
            for vi in range(n_videos):
                w, h = sizes[vi % len(sizes)]
                state: dict = {}
                frames, annos = render_video(w, h, n_frames, rng, min_objects, max_objects,
                                             record_state=state, **params)
                path = os.path.join(out_dir, f"{tag}_{vi:03d}.mp4")
                self.clips[path] = frames
                meta.append({"video_path": path, "w": w, "h": h, "annos": annos})
                states.append(state)
            self.sets[(out_dir, tag)] = meta, states
        meta, states = self.sets[(out_dir, tag)]
        return synth_records(meta, states if oracle else None, out_dir, tag, n_frames)

    def train_reader(self, path):
        """The training feed's reader of a clip (`open_video` of
        train_net), with the native decoder's `decode_train_sample`, so
        that load_pair_sample takes its fast path, where the oracle flow
        replaces the MV grid."""
        return RenderedTrainReader(self.clips[path])

    def prepared(self, video_path, cfg, bucket_hw, frames_mode=None, wire_fmt=None, oracle=None):
        """The evaluation loops' opener (PreparedVideo's signature)."""
        return RenderedPreparedVideo(self.clips[video_path], cfg, bucket_hw, frames_mode, oracle)


class RenderedTrainReader:
    """A video reader of frames in memory (get_num_frames, load) with the
    native decoder's decode_train_sample, computed by the host chain
    (data.image.resize, pad_to_bucket) with zero MV and residual."""

    def __init__(self, frames):
        self.frames = frames

    def get_num_frames(self):
        return len(self.frames)

    def load(self, gop, pos, representation):
        frame = self.frames[gop * GOP + pos]
        if representation == 0:
            return frame
        return np.zeros(frame.shape[:2] + (2 if representation == 1 else 3,), np.int32)

    def decode_train_sample(self, cur_id, bucket_hw, target_size, max_size, pixel_means_bgr,
                            pixel_scale=1.0, stride=16, legacy_swap=False, flip=False):
        """(data, ref, old (bh, bw, 3) uint8 resized and padded, flipped
        when `flip`; mv (fh, fw, 2) and res (fh, fw, 3) float32; im_info;
        the frame's position in its GOP), as the native call returns them:
        ref is the GOP's key frame, old the previous GOP's."""
        from lsfa_tpu_torch.data.image import pad_to_bucket, resize
        from lsfa_tpu_torch.data.loader import zero_residual_grid

        pos = cur_id % GOP
        key = cur_id - pos
        resized = {}
        for fid in (cur_id, key, max(key - GOP, 0)):
            if fid not in resized:
                im = self.frames[fid].astype(np.float32)
                im_r, scale = resize(im[:, ::-1] if flip else im, target_size, max_size)
                resized[fid] = pad_to_bucket(np.clip(np.round(im_r), 0, 255).astype(np.uint8)[None],
                                             bucket_hw)[0], im_r.shape[:2], scale
        data, (h, w), scale = resized[cur_id]
        info = np.asarray([h, w, scale], np.float32)
        fb = (bucket_hw[0] // stride, bucket_hw[1] // stride)
        return (data, resized[key][0], resized[max(key - GOP, 0)][0],
                np.zeros(fb + (2,), np.float32),
                zero_residual_grid(fb + (3,), info, pixel_means_bgr, pixel_scale, stride,
                                   legacy_swap=legacy_swap),
                info, pos)


class RenderedPreparedVideo:
    """PreparedVideo's surface (num_frames, wire_format, gop, frame) over
    frames in memory: each frame through the host chain
    (data.loader.host_payload, BGR), zero MV and residual grids; under
    `oracle` (an oracle state) the generator's flow replaces each GOP's MV
    grids (data.oracle_flow.substitute_gop_mv), as PreparedVideo does. In
    the key-only mode the non-key frames' full-size slots stay zero."""

    wire_format = "bgr8"

    def __init__(self, frames, cfg, bucket_hw, frames_mode=None, oracle=None):
        self.frames, self.cfg, self.bucket_hw = frames, cfg, tuple(bucket_hw)
        self.num_frames = len(frames)
        if frames_mode is None:
            frames_mode = 1 if cfg.TEST.KEY_FRAME_INTERVAL % GOP == 0 else 0
        self.key_only = frames_mode == 1
        self.oracle = oracle
        self._gop, self._cache = -1, None

    def gop(self, gop_idx):
        if gop_idx != self._gop:
            self._cache, self._gop = self._load_gop(gop_idx), gop_idx
        return self._cache

    def frame(self, fid):
        frames, smalls, mv, res, info = self.gop(fid // GOP)
        pos = fid % GOP
        return (frames[pos:pos + 1], smalls[pos:pos + 1], mv[pos:pos + 1], res[pos:pos + 1],
                info[None])

    def _load_gop(self, gop_idx):
        from lsfa_tpu_torch.data.loader import host_payload
        from lsfa_tpu_torch.data.oracle_flow import substitute_gop_mv

        first = gop_idx * GOP
        parts = [host_payload(self.frames[f].astype(np.float32), self.cfg, self.bucket_hw)
                 for f in range(first, min(first + GOP, self.num_frames))]
        frames, smalls, _, mv, res = (np.concatenate(p) for p in zip(*parts))
        info = parts[0][2][0]
        if self.key_only:
            frames[1:] = 0
        if self.oracle is not None:
            mv = substitute_gop_mv(mv, self.oracle, first, float(info[2]),
                                   self.cfg.network.RCNN_FEAT_STRIDE, self.frames.shape[1:3])
        return frames, smalls, mv, res, info


# the report keys of JAX's tools/train_synth_full.py and tools/eval_rung.py
# (a CPU test holds them equal to those tools' reports)
RUNG_REPORT_KEYS = ["rung", "profile", "steps", "train_wall_s", "steps_per_s", "eval_wall_s",
                    "eval_frames", "n_detections", "mAP_synth_val", "ap_per_class", "platform"]
XVAL_REPORT_KEYS = ["rung", "profile", "ckpt", "ckpt_epoch", "val_videos", "val_seed", "lt_off",
                    "eval_wall_s", "eval_frames", "n_detections", "mAP_synth_val",
                    "mAP_key_frames", "mAP_nonkey_frames", "mAP_by_offset", "ap_per_class",
                    "platform"]
FEED = re.compile(r"feed summary: (\d+) steps in ([\d.]+)s .* loader-wait ([\d.]+)s")


class FeedSummary(logging.Handler):
    """Keeps train_net's feed summaries (steps, wall s, loader-wait s)."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def emit(self, record):
        m = FEED.search(record.getMessage())
        if m:
            self.seen.append((int(m[1]), float(m[2]), float(m[3])))


def eval_schedule_launches(rung, video_roidb):
    """The kernel's launches the evaluation loop of `rung` makes over
    video_roidb: 2 per R-FCN frame; 4 per whole GOP and 2 per frame of a
    partial-GOP tail in eval_videos."""
    frames = [r["frame_seg_len"] for r in video_roidb]
    if rung == "rfcn":
        return 2 * sum(frames)
    return sum(4 * (n // GOP) + 2 * (n % GOP) for n in frames)


def ladder_rung(name, argv, tool, data, nms_cuda, dev, steps, **openers):
    """One run of train_synth_full.main or eval_rung.main (`tool`, which
    trains `steps` steps) over the rendered clips with the kernel
    recorded: the input and mask of its launch number `steps - 1` (the
    last train step's RPN) and `steps` (the evaluation's first RPN). Returns (tool's report dict, kernel launches,
    recorded launches, feed summary, peak bytes, seconds)."""
    import torch

    kernel = nms_cuda.greedy_alive_cuda
    seen = {}
    keep = {steps: "eval", **({steps - 1: "train"} if steps else {})}

    def recorded(boxes, valid, thresh, sweeps):
        n = nms_cuda.LAUNCHES
        alive, conv = kernel(boxes, valid, thresh, sweeps)
        if n in keep:
            seen[keep[n]] = (boxes.clone(), valid.clone(), thresh, sweeps, alive.clone())
        return alive, conv

    feed = FeedSummary()
    log = logging.getLogger("lsfa_tpu_torch")
    log.addHandler(feed)
    report = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    nms_cuda.LAUNCHES = 0
    nms_cuda.greedy_alive_cuda = recorded
    t0 = time.perf_counter()
    try:
        rc = tool.main(argv, make_dataset=data, report=report, **openers)
    finally:
        nms_cuda.greedy_alive_cuda = kernel
        log.removeHandler(feed)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(rc == 0, f"{name}: returned {rc}")
    return report, nms_cuda.LAUNCHES, seen, feed.seen, torch.cuda.max_memory_allocated(dev), wall


def recorded_masks_equal(name, seen, greedy_alive):
    """The kernel's recorded masks against the plain version's on the
    same inputs. Returns the largest difference."""
    err = 0.0
    for kind, (boxes, valid, thresh, sweeps, alive) in seen.items():
        want = greedy_alive(boxes, valid, thresh, sweeps)
        err = max(err, float((alive.int() - want.int()).abs().max()))
        check(bool((alive == want).all()),
              f"{name}: kernel != plain on the {kind} RPN input {tuple(boxes.shape)}")
    return err


LADDER_SMOKE = {"steps": 30, "videos": 4, "frames": 36, "val_videos": 2, "xval_videos": 2}


def ladder_phase(dev, nms_cuda, greedy_alive, tmp, art=None, steps=30, videos=4, frames=36,
                 val_videos=2, xval_videos=2):
    """Phase 34: the synthetic ablation ladder's two rungs the card can run
    at the flagship recipe, through the port's tools over clips rendered
    in memory (RenderedSynthDataset): the rfcn rung (R-FCN ResNet-101 with
    DCN) from seeded weights, then the oracle rung warm-started from its
    checkpoint (--init-from), each trained `steps` steps over `videos`
    videos of `frames` frames (960x576 and 576x960, hard profile) and
    scored on `val_videos` val videos; eval_rung over `xval_videos` fresh
    ones for each rung; render_ablation over the report directory `art`
    (default: under tmp). Returns ({path: kernel launches}, max abs error of the masks,
    {rung: measurements})."""
    import torch

    from lsfa_tpu_torch.data.loader import load_pair_sample
    from lsfa_tpu_torch.tools import eval_rung, render_ablation, train_synth_full
    from lsfa_tpu_torch.train.checkpoint import load_checkpoint
    from lsfa_tpu_torch.train.driver import SHARED_STACK, init_model

    data = RenderedSynthDataset()
    art = Path(art) if art else tmp / "ablation"
    art.mkdir(parents=True, exist_ok=True)
    log_every = 1 if steps <= 100 else 10
    common = ["--profile", "hard", "--steps", str(steps), "--videos", str(videos), "--frames",
              str(frames), "--val-videos", str(val_videos), "--log-every", str(log_every),
              "--data", str(tmp / "ladder_data")]
    openers = {"open_video": data.train_reader, "open_eval_video": data.prepared}
    launches, err, measured = {}, 0.0, {}
    ckpts = {}
    for rung in ("rfcn", "oracle"):
        out = tmp / rung
        argv = common + ["--rung", rung, "--out", str(out)]
        if rung == "oracle":
            argv += ["--init-from", str(ckpts["rfcn"])]
            # the warm start: the rfcn checkpoint's detection stack, bit for bit
            cfg, _ = train_synth_full.rung_cfg("oracle")
            cfg.network.pretrained_detector = str(ckpts["rfcn"])
            warm = init_model(cfg, 0, dev, logger=Lines()).state_dict()
            src, _ = load_checkpoint(str(ckpts["rfcn"]))
            shared = [k for k in src["model"] if k.split(".")[0] in SHARED_STACK and k in warm]
            diff = [k for k in shared if not torch.equal(warm[k].cpu(), src["model"][k])]
            check(shared and not diff,
                  f"oracle warm start: {len(diff)} of {len(shared)} shared tensors differ from "
                  f"the rfcn checkpoint's {diff[:3]}")
            n_shared = len(shared)
            del warm, src
        report, n, seen, feed, peak, wall = ladder_rung(
            f"ladder {rung}", argv, train_synth_full, data, nms_cuda, dev, steps=steps, **openers)
        ckpts[rung] = out / "checkpoints"
        rep = report["report"]
        check(list(rep) == RUNG_REPORT_KEYS, f"ladder {rung}: report keys {list(rep)}")
        check(json.loads((out / "report.json").read_text()) == json.loads(json.dumps(rep)),
              f"ladder {rung}: report.json differs from the returned report")
        curves = [json.loads(c) for c in report["curves"]]
        check([c["step"] for c in curves] == list(range(0, steps, log_every))
              and all(np.isfinite(v) for c in curves for v in c.values()),
              f"ladder {rung}: {len(curves)} logged steps, finite: "
              f"{all(np.isfinite(v) for c in curves for v in c.values())}")
        want = steps + eval_schedule_launches(rung, report["val_roidb"])
        check(n == want, f"ladder {rung}: {n} kernel launches, not {steps} steps + "
                         f"{want - steps} from the evaluation's schedule")
        check(set(seen) == {"train", "eval"}, f"ladder {rung}: recorded {sorted(seen)}")
        err = max(err, recorded_masks_equal(f"ladder {rung}", seen, greedy_alive))
        launches[f"ladder_{rung}"] = n
        (art / f"report_{rung}.json").write_text((out / "report.json").read_text())
        (art / f"curves_{rung}.jsonl").write_text((out / "curves.jsonl").read_text())
        check(len(feed) == 1 and feed[0][0] == steps, f"ladder {rung}: feed summaries {feed}")
        _, train_wall, wait = feed[0]
        measured[rung] = m = {
            "steps_per_s": steps / report["train_wall"], "loader_wait_share": wait / train_wall,
            "ms_per_step_fed": (train_wall - wait) / steps * 1e3, "peak_gib": peak / 2**30,
            "eval_frames_per_s": rep["eval_frames"] / report["eval_wall"],
            "mAP": rep["mAP_synth_val"], "seconds": wall, "launches": n,
            "first_loss": curves[0]["total_loss"], "last_loss": curves[-1]["total_loss"]}
        print(f"ladder {rung}: train_synth_full.main(--rung {rung} --profile hard --steps {steps}"
              f"{' --init-from <rfcn>' if rung == 'oracle' else ''}) over {videos} x {frames} "
              f"rendered frames (960x576, 576x960) at the flagship recipe (bf16, "
              f"{'R-FCN ResNet-101 with DCN' if rung == 'rfcn' else 'LSFA mv_only graph, oracle MVs'}"
              f"): returned 0; total_loss {m['first_loss']:.4f} -> {m['last_loss']:.4f}, every "
              f"logged step finite; {m['steps_per_s']:.3f} steps/s, loader wait "
              f"{100 * m['loader_wait_share']:.1f}% of {train_wall:.1f} s, "
              f"{m['ms_per_step_fed']:.1f} ms per step with the batch ready, peak "
              f"{m['peak_gib']:.2f} GiB; eval over {val_videos} val videos: "
              f"{rep['eval_frames']} frames at {m['eval_frames_per_s']:.2f} frames/s, mAP "
              f"{rep['mAP_synth_val']:.4f}; {n} kernel launches ({steps} steps + "
              f"{n - steps} from the evaluation's schedule), masks equal to the plain "
              f"version's on the last step's and the first evaluation's RPN inputs; "
              f"{wall:.1f} s with rendering"
              + (f"; warm start: {n_shared} shared tensors bit-equal to the rfcn checkpoint's"
                 if rung == "oracle" else ""))

    # F5: a non-key sample of the oracle rung takes the analytic flow
    cfg, _ = train_synth_full.rung_cfg("oracle")
    records, _, _ = data(str(tmp / "ladder_data"), n_videos=videos, n_frames=frames, seed=0,
                         sizes=train_synth_full.SIZES, split="train", profile="hard", oracle=True)
    rec = next(r for r in records if r["frame_seg_id"] == 5 and r["width"] > r["height"])
    sample = None
    for seed in range(20):
        sample = load_pair_sample(rec, cfg, np.random.default_rng(seed), bucket_hw=BUCKET,
                                  open_video=data.train_reader)
        if sample["eq_flag"] == 0.0:
            break
    moving = float(np.abs(sample["motion_vector"]).max())
    check(sample["eq_flag"] == 0.0 and moving > 0,
          f"oracle rung: a non-key sample's motion_vector is zero (eq_flag {sample['eq_flag']})")
    print(f"ladder oracle: a non-key training sample (frame 5, the fast path of "
          f"RenderedTrainReader) carries the generator's flow: |motion_vector| up to "
          f"{moving:.2f} cells, where the rendered clip's own MVs are zero")

    launches["ladder_xval"] = 0
    for rung in ("rfcn", "oracle"):
        report, n, seen, _, _, _ = ladder_rung(
            f"ladder xval {rung}", ["--rung", rung, "--ckpt", str(ckpts[rung]), "--val-videos",
                                    str(xval_videos), "--data", str(tmp / "ladder_data"),
                                    "--out", str(art)],
            eval_rung, data, nms_cuda, dev, steps=0, open_eval_video=data.prepared)
        rep = report["report"]
        check(list(rep) == XVAL_REPORT_KEYS, f"ladder xval {rung}: report keys {list(rep)}")
        check(all(np.isfinite(rep[k]) for k in ("mAP_synth_val", "mAP_key_frames",
                                                "mAP_nonkey_frames")), f"ladder xval {rep}")
        want = eval_schedule_launches(rung, report["val_roidb"])
        check(n == want, f"ladder xval {rung}: {n} kernel launches, not {want} from its schedule")
        err = max(err, recorded_masks_equal(f"ladder xval {rung}", seen, greedy_alive))
        launches["ladder_xval"] += n
        measured[f"{rung}_xval"] = m = {
            "mAP": rep["mAP_synth_val"], "mAP_key": rep["mAP_key_frames"],
            "mAP_nonkey": rep["mAP_nonkey_frames"], "mAP_by_offset": rep["mAP_by_offset"],
            "eval_frames_per_s": rep["eval_frames"] / report["eval_wall"]}
        print(f"ladder xval: eval_rung.main(--rung {rung}) over {xval_videos} fresh val videos "
              f"(seed 2000): {rep['eval_frames']} frames at {m['eval_frames_per_s']:.2f} "
              f"frames/s, mAP {m['mAP']:.4f} (key {m['mAP_key']:.4f}, non-key "
              f"{m['mAP_nonkey']:.4f}), by offset {m['mAP_by_offset']}; {n} kernel launches "
              f"({'2 per frame' if rung == 'rfcn' else '4 per GOP'}), masks equal to the plain "
              f"version's on its first RPN input")

    render_ablation.main(["--dir", str(art)])
    md = (art / "ABLATION.md").read_text()
    check("oracle" in md and "rfcn" in md, "render_ablation: ABLATION.md lacks the rungs")
    print(f"ladder: render_ablation wrote ABLATION.md ({len(md)} bytes) over "
          f"{sorted(p.name for p in art.glob('report_*.json'))}")
    return launches, err, measured


def entry_phase(dev, nms_cuda):
    """Phase 35: lsfa_tpu_torch.entry.entry() on the card: fn(*args)
    equal to the flagship's forward_key on the same inputs bit for bit,
    and its time. Returns kernel launches (forward_key runs no NMS)."""
    import torch

    from lsfa_tpu_torch import entry

    torch.cuda.synchronize()
    nms_cuda.LAUNCHES = 0
    fn, args = entry.entry()
    out = fn(*args)
    torch.cuda.synchronize()
    launches = nms_cuda.LAUNCHES
    _, model = entry._flagship(device=dev)
    model.load_state_dict({k: args[0][k] for k in model.state_dict()})
    with torch.no_grad():
        want = model.eval().forward_key(*args[1:])
    check(sorted(out) == sorted(want), f"entry: outputs {sorted(out)}")
    differ = [k for k in want if not torch.equal(out[k], want[k])]
    check(not differ, f"entry: fn(*args) differs from forward_key in {differ}")
    check(all(bool(torch.isfinite(v).all()) for v in out.values()), "entry: non-finite outputs")
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    del model
    print(f"entry: lsfa_tpu_torch.entry.entry() on {torch.cuda.get_device_name(0)}: fn(params, "
          f"data, data_key_old, feat_key_old, is_first) through torch.func.functional_call at "
          f"{tuple(args[1].shape[1:3])}, {len(args[0])} weight tensors: outputs "
          f"{ {k: tuple(v.shape) for k, v in out.items()} } equal to forward_key's bit for "
          f"bit; {statistics.median(times) * 1e3:.2f} ms per call (median of 10 after one "
          f"warm-up, host clock to synchronize), {launches} kernel launches")
    return launches


TOOLS_SMOKE = {"trials": "2", "stream_gops": "4", "pairs": "2", "steps": "3"}


def tool_result(tool, result, name, values=("value",)):
    """Checks a measurement tool's JSON result: the card named with its
    power limit, and each of `values` (keys of result) finite and
    positive. Returns result."""
    dev = result["device"]
    check(dev["name"] == name and dev["count"] >= 1,
          f"{tool}: device {dev} is not {name}")
    check(dev["power_limit_w"] is not None and dev["power_limit_w"] > 0,
          f"{tool}: no power limit in {dev}")
    for key in values:
        v = result[key]
        check(isinstance(v, (int, float)) and np.isfinite(v) and v > 0,
              f"{tool}: {key} = {v!r} is not finite and positive")
    return result


def schedule_launches(calls):
    """The kernel launches a recorded schedule implies: 4 per GOP of a
    window, 2 per frame."""
    return sum(4 * c["gops"] if c["kind"] == "window" else 2 for c in calls)


def counted(nms_cuda, fn):
    """(fn(), kernel launches during it)."""
    import torch

    torch.cuda.synchronize()
    nms_cuda.LAUNCHES = 0
    out = fn()
    torch.cuda.synchronize()
    return out, nms_cuda.LAUNCHES


def tools_phase(dev, nms_cuda, greedy_alive):
    """Phase 36: every measurement tool of the port once through its
    main(argv), at few trials (TOOLS_SMOKE). Checks each JSON result
    (finite positive values, the card and its power limit), the kernel's
    launches against each tool's schedule, the bench loop's detections
    against process_prepared_window on the same payloads, the kernel's
    masks against the plain version's on the bench's key and non-key RPN
    inputs and on profile_detection's N = 6000 input (two kernels per
    call there), report_mfu's shares (<= 105%) and its FLOP counts against
    the CPU's at the tiny config, and ab_interleaved's A, B, A, B order.
    Returns (launches by path, max abs error of the masks, the kernel's
    timing entry at N = 6000 and that input)."""
    import torch

    from lsfa_tpu_torch import bench
    from lsfa_tpu_torch.data import coviar
    from lsfa_tpu_torch.tools import (ab_interleaved, bench_decode, bench_train,
                                      profile_breakdown, profile_detection, profile_train,
                                      report_mfu)

    name = torch.cuda.get_device_name(0)
    t = TOOLS_SMOKE
    few = ["--trials", t["trials"], "--stream-gops", t["stream_gops"]]
    launches, lines = {}, []
    max_err = 0.0

    # the bench: the headline (e2e and the 3-stream aggregate), device-only, latency
    calls = []
    with recorded_schedule(calls):
        r, n = counted(nms_cuda, lambda: bench.main(few))
    tool_result("bench", r, name, ("value", "per_gop_ms_p50", "per_gop_ms_p99",
                                   "aggregate_3stream_timeplex_e2e_fps"))
    check(n == schedule_launches(calls) > 0, f"bench e2e: {n} launches, schedule "
          f"{schedule_launches(calls)}")
    launches["bench_e2e"] = n
    lines.append(f"e2e {r['value']:.1f} frames/s, per-GOP p50 {r['per_gop_ms_p50']:.1f} p99 "
                 f"{r['per_gop_ms_p99']:.1f} ms, timeplex(3) "
                 f"{r['aggregate_3stream_timeplex_e2e_fps']:.1f} frames/s ({n} launches)")
    r, n = counted(nms_cuda, lambda: bench.main(
        ["--device-only", "--trials", t["trials"], "--windows", "2"]))
    tool_result("bench --device-only", r, name)
    want = 4 * 4 * (1 + int(t["trials"]) * 2)          # G = 4 GOPs, warm-up and 2 windows a trial
    check(n == want, f"bench --device-only: {n} launches, schedule {want}")
    launches["bench_device_only"] = n
    lines.append(f"device-only {r['value']:.1f} frames/s ({n})")
    calls = []
    with recorded_schedule(calls):
        r, n = counted(nms_cuda, lambda: bench.main(["--latency", "--stream-gops",
                                                      t["stream_gops"]]))
    tool_result("bench --latency", r, name, ("value", "key_ms_p50", "non_key_ms_p95"))
    check(n == schedule_launches(calls) == 2 * (2 + 12 * int(t["stream_gops"])),
          f"bench --latency: {n} launches, schedule {schedule_launches(calls)}")
    launches["bench_latency"] = n
    lines.append(f"latency non-key p50 {r['value']:.2f} ms, key p50 {r['key_ms_p50']:.2f} ms ({n})")

    # the bench loop changes no detection; the kernel on the bench's inputs
    arm = bench.E2EArm(["--gops", "2"], device=dev, stream_gops=int(t["stream_gops"]))
    arm.warmup()
    windows = []
    bench.e2e_trial(arm, collect=windows)
    payloads = [arm.pv.gop(g) for g in range(arm.n_gops)]
    det = arm.det
    det.reset()
    state = det.get_state()
    for w, i in enumerate(range(0, len(payloads), arm.G)):
        want = [o.cpu() for o in det.process_prepared_window(payloads[i:i + arm.G],
                                                             first=(i == 0))]
        check(len(windows[w]) == len(want) and all(torch.equal(a, b) for a, b in
                                                    zip(windows[w], want)),
              f"bench: window {w}'s detections differ from process_prepared_window's")
    got, want, boxes, valid = key_rpn_masks(det, state, payloads[0], True, nms_cuda, greedy_alive)
    check(torch.equal(got, want), "bench: kernel != plain on the key frame's RPN input")
    det.reset()
    det.process_prepared_window(payloads[:1], first=True)
    got_c, want_c, boxes_c, _ = cur_rpn_masks(det, payloads[0], nms_cuda, greedy_alive)
    check(torch.equal(got_c, want_c), "bench: kernel != plain on the non-key RPN input")
    max_err = max(max_err, float((got.int() - want.int()).abs().max()),
                  float((got_c.int() - want_c.int()).abs().max()))
    lines.append(f"the e2e loop's {len(windows)} windows equal process_prepared_window's; masks "
                 f"equal on its RPN inputs {tuple(boxes.shape)} and {tuple(boxes_c.shape)}")

    # profile_detection's N = 6000 input: the two-phase route
    boxes6, valid6 = profile_detection.rpn_input(det, 6000)
    check(tuple(boxes6.shape) == (1, 6000, 4), f"profile_detection: RPN input {boxes6.shape}")
    got6, _ = nms_cuda.greedy_alive_cuda(boxes6, valid6, det.cfg.TEST.RPN_NMS_THRESH, 31)
    want6 = greedy_alive(boxes6, valid6, det.cfg.TEST.RPN_NMS_THRESH, 31)
    check(torch.equal(got6, want6), "profile_detection: kernel != plain at N = 6000")
    max_err = max(max_err, float((got6.int() - want6.int()).abs().max()))
    kernels, nodes = graph_kernels(lambda: nms_cuda.greedy_alive_cuda(
        boxes6, valid6, det.cfg.TEST.RPN_NMS_THRESH, 31))
    check((kernels, nodes) == (2, 2), f"N = 6000: one call captured {kernels} kernels")
    _, per_call = counted(nms_cuda, lambda: profile_detection.variant(det, 6000, "full")())
    check(per_call == 2, f"profile_detection full at pre_nms 6000: {per_call} launches")
    k_ms = cuda_ms(lambda: nms_cuda.greedy_alive_cuda(boxes6, valid6, 0.7, 31))
    bound_ms, bound_by = nms_cuda.nms_bound_ms(1, 6000)
    lines.append(f"N = 6000 (two-phase, {kernels} kernels per call): masks equal ("
                 f"{int(got6.sum())} alive of {int(valid6.sum())}), {k_ms * 1e3:.1f} us per call, "
                 f"bound {bound_ms * 1e3:.2f} us ({bound_by})")
    n6000 = {"shape": [1, 6000], "thresh": 0.7, "us": k_ms * 1e3, "bound_us": bound_ms * 1e3,
             "bound_by": bound_by, "share_of_bound": bound_ms / k_ms,
             "plain_us": cuda_ms(lambda: greedy_alive(boxes6, valid6, 0.7, 31)) * 1e3}
    del arm, det, windows

    # the profilers
    reps = 2
    r, n = counted(nms_cuda, lambda: profile_detection.main(["--reps", str(reps)]))
    tool_result("profile_detection", r, name, ())
    want = (reps + 1) * 3 * (1 + 1 + 2) + 0             # prop 1, psroi 1, full 2 per call
    check(n == want, f"profile_detection: {n} launches, schedule {want}")
    check(all(np.isfinite(v) and v > 0 for v in r["variants"].values()),
          f"profile_detection: {r['variants']}")
    launches["profile_detection"] = n
    lines.append(f"profile_detection full pre 6000 {r['variants']['full_pre6000']:.2f} ms, "
                 f"fwd {r['variants']['fwd']:.2f} ms ({n})")
    r, n = counted(nms_cuda, lambda: profile_breakdown.main(["--reps", str(reps)]))
    tool_result("profile_breakdown", r, name, ())
    check(all(np.isfinite(v) and v > 0 for v in r["components"].values()),
          f"profile_breakdown: {r['components']}")
    want = 1 + (reps + 1) * (2 + 1 + 1 + 1 + 2)         # rois, then the NMS-running components
    check(n == want, f"profile_breakdown: {n} launches, schedule {want}")
    launches["profile_breakdown"] = n
    lines.append(f"profile_breakdown key fwd+det {r['components']['key_fwd_det']:.2f} ms, cur x11 "
                 f"{r['components']['cur_fwd_no_det_x11']:.2f} ms ({n})")
    r, n = counted(nms_cuda, lambda: profile_train.main(["--reps", str(reps), "--steps",
                                                         t["steps"]]))
    tool_result("profile_train", r, name, ("images_per_s",))
    want = 2 * (reps + 1) + 1 + 5 + int(t["steps"])    # fwd_loss, grad; full steps; chained
    check(n == want, f"profile_train: {n} launches, schedule {want}")
    launches["profile_train"] = n
    lines.append(f"profile_train full step {r['phases']['full_step']:.1f} ms, chained "
                 f"{r['phases']['chained_step']:.1f} ms ({n})")

    # the train bench, LSFA and R-FCN
    for cfg_name, argv in (("lsfa", []), ("rfcn", ["--cfg", str(RFCN_CONFIG)])):
        r, n = counted(nms_cuda, lambda: bench_train.main(["--steps", t["steps"], *argv]))
        tool_result(f"bench_train {cfg_name}", r, name, ("value", "ms_per_step", "peak_gib"))
        check(n == 1 + int(t["steps"]), f"bench_train {cfg_name}: {n} launches, not 1 per step")
        check(np.isfinite(r["last_loss"]), f"bench_train {cfg_name}: loss {r['last_loss']}")
        launches[f"bench_train_{cfg_name}"] = n
        lines.append(f"bench_train {cfg_name} {r['ms_per_step']:.1f} ms/step, "
                     f"{r['peak_gib']:.2f} GiB ({n})")

    # report_mfu: shares, and the FLOP count of each program equal to the CPU's
    trials = 3
    r, n = counted(nms_cuda, lambda: report_mfu.main(["--trials", str(trials)]))
    tool_result("report_mfu", r, name, ())
    rows = r["programs"]
    for prog, row in rows.items():
        for share in ("mfu_pct", "hbm_util_pct"):
            check(row[share] is not None and 0 < row[share] <= 105,
                  f"report_mfu {prog}: {share} = {row[share]}")
    k = max(5, trials // 2)
    want = (2 + 2 + 4 * 2) * (1 + 1 + trials) + 2 + k  # inference: count + timed; train
    check(n == want, f"report_mfu: {n} launches, schedule {want}")
    launches["report_mfu"] = n
    lines.append("report_mfu " + ", ".join(
        f"{p} {row['ms']:.2f} ms {row['gflop']:.1f} GFLOP MFU {row['mfu_pct']:.2f}% HBM "
        f"{row['hbm_util_pct']:.2f}%" for p, row in rows.items()) + f" ({n})")
    card, n_tiny = counted(nms_cuda, lambda: report_mfu.main(["--tiny", "--trials", "1"]))
    cpu = report_mfu.main(["--tiny", "--trials", "1", "--device", "cpu"])
    for prog, row in report_mfu.program_rows(card).items():
        cpu_row = report_mfu.program_rows(cpu)[prog]
        check(row["gflop"] == cpu_row["gflop"] and row["nms_calls"] == cpu_row["nms_calls"],
              f"report_mfu --tiny {prog}: {row['gflop']} GFLOP on the card, "
              f"{cpu_row['gflop']} on the CPU")
    launches["report_mfu_tiny"] = n_tiny
    lines.append(f"report_mfu --tiny: FLOPs of the {len(card['programs'])} programs equal the "
                 f"CPU's")

    # ab_interleaved
    calls = []
    with recorded_schedule(calls):
        r, n = counted(nms_cuda, lambda: ab_interleaved.main(
            ["--b", "--gops 4", "--pairs", t["pairs"], "--stream-gops", t["stream_gops"]]))
    tool_result("ab_interleaved", r, name, ("median_b_over_a", "median_fps_a", "median_fps_b"))
    check(r["order"] == ["A", "B"] * int(t["pairs"]), f"ab_interleaved: order {r['order']}")
    check(np.allclose(r["pair_ratios"], np.asarray(r["fps_b"]) / np.asarray(r["fps_a"])),
          f"ab_interleaved: ratios {r['pair_ratios']}")
    check(n == schedule_launches(calls), f"ab_interleaved: {n} launches, schedule "
          f"{schedule_launches(calls)}")
    launches["ab_interleaved"] = n
    lines.append(f"ab_interleaved B/A {r['median_b_over_a']:.3f} ({r['ratio_spread']}) ({n})")

    # bench_decode is host-only: without the native library it raises, naming it
    if coviar.available():
        r = bench_decode.main(["--gops", "1", "--passes", "1"])
        check(all(c["ms_per_frame"] > 0 for c in r["clips"].values()), f"bench_decode: {r}")
        lines.append("bench_decode ran")
    else:
        try:
            bench_decode.main([])
            fail("bench_decode ran without the native library")
        except RuntimeError as e:
            check("libcoviar_tpu.so" in str(e), f"bench_decode raised {e}")
        lines.append("bench_decode raises without the native decoder, naming libcoviar_tpu.so")
    print(f"tools: on {name}: " + "; ".join(lines))
    return launches, max_err, n6000, (boxes6, valid6)


def tools_trace_phase(dev, nms_cuda, tmp):
    """The profilers' --trace parts (phase 27's place: after a profiled
    window the host's launches stay slower): profile_breakdown over one
    GOP and profile_train over 3 chained steps, each a Chrome trace with
    its top kernels and busy share. Returns launches by path."""
    from lsfa_tpu_torch.tools import profile_breakdown, profile_train

    launches = {}
    r, n = counted(nms_cuda, lambda: profile_breakdown.main(
        ["--reps", "1", "--trace", str(tmp / "breakdown")]))
    check(n == 1 + 2 * 7 + 4, f"profile_breakdown --trace: {n} launches")
    launches["profile_breakdown_trace"] = n
    gop = r["trace"]
    r, n = counted(nms_cuda, lambda: profile_train.main(
        ["--reps", "1", "--steps", "2", "--trace", str(tmp / "train")]))
    check(n == 2 * 2 + 1 + 5 + 2 + 3, f"profile_train --trace: {n} launches")
    launches["profile_train_trace"] = n
    for what, tr in (("a GOP", gop), ("3 train steps", r["trace"])):
        if tr["busy_share"] is None:
            print(f"profiled: {what} through the profiler tools: {NOT_TRACED}")
        else:
            top = ", ".join(f"{k['name'][:40]} {k['share']:.1%}" for k in tr["top"][:3])
            print(f"profiled: {what} through the profiler tools: {tr['kernels']} kernels, "
                  f"{tr['device_ms']:.2f} ms on the device, busy share {tr['busy_share']:.3f}; "
                  f"top {top}")
    return launches


def tools_profiled(dev, nms_cuda, n6000, input6000):
    """Phase 36's profiled part: the kernel's device time at N = 6000
    (into n6000) and the profilers' --trace parts. Returns launches by
    path."""
    _, dev_us = device_kernels(lambda: nms_cuda.greedy_alive_cuda(*input6000, 0.7, 31), 20)
    if dev_us is None:
        print(f"profiled: N = 6000 two-phase: {NOT_TRACED}")
    else:
        n6000.update(device_us=dev_us, device_share_of_bound=n6000["bound_us"] / dev_us)
        print(f"profiled: N = 6000 two-phase (profile_detection's input): {dev_us:.1f} us on the "
              f"device (mean of 20), {n6000['device_share_of_bound']:.4f} of the bound")
    with tempfile.TemporaryDirectory() as scratch:
        return tools_trace_phase(dev, nms_cuda, Path(scratch))


def tools_only():
    """`python3 chip_smoke.py --tools`: phase 36 alone (and its profiled
    part), after the build; prints the launches and the N = 6000 timing
    as one JSON line."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA card")
    sys.path.insert(0, str(REPO))
    from lsfa_tpu_torch.ops import nms_cuda
    from lsfa_tpu_torch.ops.nms import greedy_alive

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    nms_cuda.build()
    dev = torch.device("cuda", 0)
    launches, err, n6000, input6000 = tools_phase(dev, nms_cuda, greedy_alive)
    launches.update(tools_profiled(dev, nms_cuda, n6000, input6000))
    print(json.dumps({"launches": launches, "max_abs_err": err, "n6000": n6000,
                      "seconds": time.perf_counter() - T0}))


def main():
    import os

    # CUPTI stays set up between profiled windows: by default it is torn
    # down after each and set up again lazily, which PyTorch itself turns
    # off once CUDA graphs are captured (phase 3 captures some)
    os.environ["TEARDOWN_CUPTI"] = "0"
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

    dev = torch.device("cuda", 0)
    # torch's default: cuDNN convolutions may run in TF32. The package pins
    # its float32 convolutions itself, so every float32 parity phase below
    # runs against that pin; the flag is checked again at the end
    check(torch.backends.cudnn.allow_tf32 is True,
          "torch.backends.cudnn.allow_tf32 is not torch's default (True) at the start")

    # 1. environment
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"env: python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}, "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} (the package pins its float32 "
          f"convolutions), matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
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
        kernels, nodes = graph_kernels(lambda: nms_cuda.greedy_alive_cuda(b, v, thresh, sweeps))
        check((kernels, nodes) == ((1, 1) if n <= nms_cuda.FUSED_MAX_N else (2, 2)),
              f"{name}: one call captured {kernels} kernels in {nodes} graph nodes")
        checked.append((name, b, v, thresh, sweeps, timed, kernels))
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        nms_cuda.greedy_alive_cuda(b, v, thresh, sweeps)
        extra = torch.cuda.max_memory_allocated(dev) - before
        if n <= nms_cuda.FUSED_MAX_N:
            check(extra <= 2 * 512 + bsz * n, f"{name}: the fused path allocated {extra} bytes")
        line = (f"kernel vs plain: {name} t={thresh} sweeps={sweeps}: masks and converged equal "
                f"({int(got.sum())} alive, {int(conv.sum())}/{bsz} converged); cluster {csize}, "
                f"{kernels} kernel launch(es) per call (CUDA graph), {extra} bytes allocated")
        if timed:
            k_ms = cuda_ms(lambda: nms_cuda.greedy_alive_cuda(b, v, thresh, sweeps))
            p_ms = cuda_ms(lambda: greedy_alive(b, v, thresh, sweeps))
            bound_ms, bound_by = nms_cuda.nms_bound_ms(bsz, n)
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
    payloads = synth_gops(cfg, 3, 1)
    torch.cuda.synchronize()
    nms_cuda.LAUNCHES = 0
    gop_s, gop_enqueue = [], []
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
        gop_enqueue.append(time.perf_counter() - t0)
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
          f"ms/GOP = {GOP / statistics.mean(steady):.1f} frames/s, of it host enqueue "
          f"{statistics.mean(gop_enqueue[1:]) * 1e3:.1f} ms/GOP; "
          f"nms kernel launches {launches}; host syncs flagged after warm-up {syncs}; "
          f"valid detections/frame {int(outs[-1][1].sum())}, "
          f"{int(outs[-1][3].sum()) // (GOP - 1)} (key, non-key mean)")

    # the kernel on the last key frame's real RPN input
    got, want, boxes, valid = key_rpn_masks(det, last_state, payloads[-1], False, nms_cuda,
                                            greedy_alive)
    check(torch.equal(got, want), "kernel != plain on the key frame's RPN input")
    print(f"main path: kernel mask equals plain on the key frame's RPN input "
          f"{tuple(boxes.shape)}: {int(got.sum())} alive of {int(valid.sum())} valid")

    # 5. small input: card (kernel) vs CPU (plain), float32, same weights
    tiny, cpu_model = tiny_stream_model("cpu")
    gpu_model = lsfa_from_config(tiny, device=dev)
    gpu_model.load_state_dict(cpu_model.state_dict())
    small = synth_gops(tiny, 2, 2, bucket=(64, 112), content=(60, 104), scale=0.5)
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
    from lsfa_tpu_torch.eval.tester import collect_detections
    scoring("the 12 R-FCN frames of phase 8",
            {i: collect_detections(d, v) for i, (d, v) in enumerate(serve_outs)})
    max_err = max(max_err, train_err, serve_err, rfcn_err, bn_err)

    # 13-18: the evaluation loops over synthetic streams, and the float32 pin
    eval_dets, eval_launches = eval_phases(dev, model, cfg, nms_cuda)
    scoring("eval_videos' 102 flagship frames", eval_dets)
    float32_pin(dev, det, payloads)
    check(torch.backends.cudnn.allow_tf32 is True,
          "torch.backends.cudnn.allow_tf32 was left changed by the package")

    # 19-21: the reference's weights through the importer and the
    # launcher, and the warm-started trainer
    with tempfile.TemporaryDirectory() as scratch:
        scratch = Path(scratch)
        rt_launches, rt_err, ckpts = reference_roundtrip(dev, nms_cuda, greedy_alive, scratch)
        launcher_launches = launcher_phase(dev, nms_cuda, scratch, ckpts["LSFA"])
        warm_launches, warm_err = warm_start_phase(dev, get_default_config(), nms_cuda,
                                                   greedy_alive, scratch, ckpts["R-FCN"])
        # 22: the train+test launcher over a DET+VID tree, under NCCL
        tt_launches, tt_err = train_test_phase(dev, nms_cuda, greedy_alive, scratch)
    max_err = max(max_err, rt_err, warm_err, tt_err)

    # 23-26: the rest of the model family: the MobileNetV2 and Hobot trunks
    # at full width, the flagship's batched-GOP graph, every variant tiny
    mobile_launches, mobile_err = mobilenet_phase(dev, nms_cuda, greedy_alive)
    hobot_launches = hobot_phase(dev, nms_cuda)
    gop_launches, gop_err, gop_classes = batch_gop_phase(dev, model, cfg, nms_cuda, greedy_alive)
    variants_card_vs_cpu(dev)
    max_err = max(max_err, mobile_err, gop_err)
    check(torch.backends.cudnn.allow_tf32 is True,
          "torch.backends.cudnn.allow_tf32 was left changed by the package")

    # the kernel at the batched GOP's per-class shape, on that run's input
    boxes, valid, thresh, sweeps, _ = gop_classes
    k_ms = cuda_ms(lambda: nms_cuda.greedy_alive_cuda(boxes, valid, thresh, sweeps))
    p_ms = cuda_ms(lambda: greedy_alive(boxes, valid, thresh, sweeps))
    bound_ms, bound_by = nms_cuda.nms_bound_ms(*valid.shape)
    print(f"batched GOP: the kernel on that run's per-class input {tuple(boxes.shape)} t={thresh}: "
          f"{k_ms * 1e3:.1f} us per call (median of 20, wrapper included), plain "
          f"{p_ms * 1e3:.1f} us; bound {bound_ms * 1e3:.2f} us ({bound_by}), share "
          f"{bound_ms / k_ms:.3f}")
    print(f"phases 1-26: {time.perf_counter() - T0:.1f} s since the script started")

    # 28-33: the entry points of the last slice and the paths that raised
    with tempfile.TemporaryDirectory() as scratch:
        scratch = Path(scratch)
        demo_launches = demo_phase(dev, model, nms_cuda, scratch)
        overfit_launches = overfit_phase(nms_cuda)
        pretrain_flow_phase(dev, nms_cuda, scratch)
    bn_ar_launches = bn_allreduce_phase(dev, nms_cuda)
    bf16_launches = bf16_params_phase(dev, nms_cuda)
    jpeg_launches = jpeg_eval_phase(dev, model, cfg, nms_cuda)
    check(torch.backends.cudnn.allow_tf32 is True,
          "torch.backends.cudnn.allow_tf32 was left changed by the package")
    print(f"phases 1-33: {time.perf_counter() - T0:.1f} s since the script started")

    # 34-35: the synthetic ablation ladder's two card rungs, the entry hooks
    with tempfile.TemporaryDirectory() as scratch:
        ladder_launches, ladder_err, _ = ladder_phase(dev, nms_cuda, greedy_alive, Path(scratch),
                                                      **LADDER_SMOKE)
    entry_launches = entry_phase(dev, nms_cuda)
    max_err = max(max_err, ladder_err)
    print(f"phases 1-35: {time.perf_counter() - T0:.1f} s since the script started")

    # 36: the measurement tools (their --trace parts run after phase 27)
    tools_launches, tools_err, n6000, input6000 = tools_phase(dev, nms_cuda, greedy_alive)
    max_err = max(max_err, tools_err)
    print(f"phases 1-36: {time.perf_counter() - T0:.1f} s since the script started")

    # 27. launches and device time by torch.profiler, last: after a profiled
    # window the host's launches stay slower, which would bias phases 3-26
    rfcn_account(dev)
    timed = iter(shapes)
    for name, b, v, thresh, sweeps, is_timed, kernels in checked:
        entry = next(timed) if is_timed else None
        names, _ = device_kernels(lambda: nms_cuda.greedy_alive_cuda(b, v, thresh, sweeps))
        if not names:
            print(f"profiled: {name}: {NOT_TRACED}")
            continue
        check(len(names) == kernels,
              f"{name}: one call ran the device kernels {names}, its graph {kernels}")
        line = f"profiled: {name}: {len(names)} kernel launch(es) per call"
        if is_timed:
            _, dev_us = device_kernels(lambda: nms_cuda.greedy_alive_cuda(b, v, thresh, sweeps), 20)
            # num_sweeps = 0: the build and the one sweep that tests the exit
            _, build_us = device_kernels(lambda: nms_cuda.greedy_alive_cuda(b, v, thresh, 0), 20)
            if dev_us is None or build_us is None:
                line += f"; {NOT_TRACED}"
            else:
                entry.update(device_us=dev_us, device_us_sweeps0=build_us,
                             device_share_of_bound=entry["bound_us"] / dev_us)
                line += (f", {dev_us:.1f} us on the device (mean of 20), "
                         f"{entry['device_share_of_bound']:.3f} of the bound; with num_sweeps=0 "
                         f"(build and one test sweep) {build_us:.1f} us")
        print(line)
    tools_launches.update(tools_profiled(dev, nms_cuda, n6000, input6000))
    shapes.append(n6000)

    rpn = next(s for s in shapes if s["shape"] == [12, 2048])
    print(f"script: {time.perf_counter() - T0:.1f} s in all, on {smi}")
    print(json.dumps({"kernels": [{
        "name": "nms_sweep", "route": "cuda",
        "source": "lsfa_tpu_torch/csrc/nms_sweep.cu",
        "replaces": "lsfa_tpu/ops/pallas_nms.py:97",
        "launches": (launches + train_launches + serve_launches + rfcn_launches + bn_launches
                     + sum(eval_launches.values()) + sum(rt_launches.values())
                     + sum(launcher_launches.values()) + warm_launches
                     + sum(tt_launches.values()) + sum(mobile_launches.values())
                     + hobot_launches + gop_launches + sum(demo_launches.values())
                     + overfit_launches + bn_ar_launches + sum(bf16_launches.values())
                     + jpeg_launches + sum(ladder_launches.values()) + entry_launches
                     + sum(tools_launches.values())),
        "max_abs_err": max_err,
        "ms": rpn["us"] / 1e3, "plain_ms": rpn["plain_us"] / 1e3,
        "bound_ms": rpn["bound_us"] / 1e3, "bound_by": rpn["bound_by"], "library_ms": None,
        "launches_by_path": {"streaming": launches, "train": train_launches,
                             "rfcn_serve": serve_launches, "rfcn_train": rfcn_launches,
                             "train_bn": bn_launches, **eval_launches, **rt_launches,
                             **launcher_launches, "warm_train": warm_launches,
                             **tt_launches, **mobile_launches, "hobot_stream": hobot_launches,
                             "batch_gop": gop_launches, **demo_launches,
                             "overfit_smoke": overfit_launches, "bn_allreduce": bn_ar_launches,
                             **bf16_launches, "jpeg_eval": jpeg_launches, **ladder_launches,
                             "entry": entry_launches, **tools_launches},
        "shapes": shapes}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


def long_ladder(argv):
    """The ladder's two card rungs with a real step budget, outside the
    smoke run: phase 34 at the given sizes, its reports, curves and
    ABLATION.md written to --out with the measurements (measured.json).

    python3 chip_smoke.py --ladder STEPS --out DIR [--videos N] [--frames N]
        [--val-videos N] [--xval-videos N]"""
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="the ablation ladder's card rungs")
    ap.add_argument("--ladder", type=int, required=True, help="train steps of each rung")
    ap.add_argument("--out", required=True, help="report directory")
    ap.add_argument("--videos", type=int, default=12)
    ap.add_argument("--frames", type=int, default=72)
    ap.add_argument("--val-videos", type=int, default=6)
    ap.add_argument("--xval-videos", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA card")
    sys.path.insert(0, str(REPO))
    from lsfa_tpu_torch.ops import nms_cuda
    from lsfa_tpu_torch.ops.nms import greedy_alive

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    nms_cuda.build()
    out = Path(args.out)
    with tempfile.TemporaryDirectory() as scratch:
        launches, err, measured = ladder_phase(
            torch.device("cuda", 0), nms_cuda, greedy_alive, Path(scratch), art=out,
            steps=args.ladder, videos=args.videos, frames=args.frames,
            val_videos=args.val_videos, xval_videos=args.xval_videos)
    summary = {"card": smi, "steps": args.ladder, "videos": args.videos, "frames": args.frames,
               "val_videos": args.val_videos, "xval_videos": args.xval_videos,
               "launches": launches, "max_abs_err": err, "measured": measured,
               "seconds": time.perf_counter() - T0}
    (out / "measured.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))


if __name__ == "__main__":
    if sys.argv[1:] == ["--tools"]:
        tools_only()
    elif len(sys.argv) > 1:
        long_ladder(sys.argv[1:])
    else:
        main()
