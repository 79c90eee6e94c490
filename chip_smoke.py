#!/usr/bin/env python3
"""Smoke run of lsfa_tpu_torch on one NVIDIA card (sm_90a).

    python3 chip_smoke.py

Phases, each printing one line before the last:
  1. environment: torch/CUDA versions, the card's name and power limit;
  2. build: nvcc compiles the NMS fixpoint kernel from the checkout;
  3. kernel vs plain: the kernel's alive masks equal the plain version's
     bit for bit on the RPN shape (12, 2048), the per-class shape
     (330, 300), a deep suppression chain, the odd cap 1, a cut valid
     mask and N = 300; median times of both at the two main-path shapes;
  4. main path: the flagship LSFA (ResNet-101 with DCN, FlowNet-S, Nq-net,
     R-net, small net) at full width, random weights from a seed, bf16,
     through StreamingDetector over 3 GOPs (36 frames) of seeded I420
     payloads at the 608x1024 bucket; checks detection shapes and
     finiteness, the float32 carry, that the main path launched the
     kernel, and that the kernel's mask equals the plain version's on the
     last key frame's real RPN input;
  5. small-input reference: the tiny config in float32 on the card (with
     the kernel) against the same weights on the CPU (plain version).
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


def kernel_cases(rng):
    """(name, boxes (B, N, 4), valid (B, N), thresh, sweeps)."""
    chain_x = np.arange(128, dtype=np.float32) * 6.0
    chain = np.stack([chain_x, np.zeros(128, np.float32), chain_x + 20.0,
                      np.full(128, 20.0, np.float32)], axis=1)[None]
    cut = np.ones((4, 512), bool)
    cut[:, 100:] = False
    return [
        ("rpn (12, 2048)", np.stack([sorted_boxes(rng, 2048) for _ in range(12)]),
         rng.uniform(size=(12, 2048)) < 0.95, 0.7, 31),
        ("per-class (330, 300)", np.stack([sorted_boxes(rng, 300) for _ in range(330)]),
         rng.uniform(size=(330, 300)) < 0.8, 0.3, 31),
        ("chain n=128 cap n", chain, np.ones((1, 128), bool), 0.5, 128),
        ("odd cap 1", np.stack([sorted_boxes(rng, 256) for _ in range(4)]),
         np.ones((4, 256), bool), 0.6, 1),
        ("valid cut at 100", np.stack([sorted_boxes(rng, 512) for _ in range(4)]), cut, 0.5, 16),
        ("N=300 ragged", np.stack([sorted_boxes(rng, 300) for _ in range(7)]),
         np.ones((7, 300), bool), 0.5, 31),
    ]


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
    times = {}
    for name, boxes, valid, thresh, sweeps in kernel_cases(rng):
        b = torch.from_numpy(boxes).to(dev)
        v = torch.from_numpy(valid).to(dev)
        got, conv = nms_cuda.greedy_alive_cuda(b, v, thresh, sweeps)
        want, want_conv = greedy_alive(b, v, thresh, sweeps, with_converged=True)
        torch.cuda.synchronize()
        err = float((got.int() - want.int()).abs().max())
        max_err = max(max_err, err)
        check(torch.equal(got, want), f"kernel mask != plain mask on {name}")
        check(torch.equal(conv, want_conv), f"kernel converged != plain on {name}")
        line = f"kernel vs plain: {name}: masks equal ({int(got.sum())} alive)"
        if name.startswith(("rpn", "per-class")):
            k_ms = cuda_ms(lambda: nms_cuda.greedy_alive_cuda(b, v, thresh, sweeps))
            p_ms = cuda_ms(lambda: greedy_alive(b, v, thresh, sweeps))
            times[name] = (k_ms, p_ms)
            line += f", kernel {k_ms * 1e3:.1f} us, plain {p_ms * 1e3:.1f} us (median of 20)"
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
    check(launches > 0, "the main path never launched the NMS kernel")
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
    tiny = load_config(None, overrides={
        "network": {"num_layer": 18, "DFF_FEAT_DIM": 64, "ANCHOR_SCALES": [1, 2, 4]},
        "TEST": {"RPN_PRE_NMS_TOP_N": 256, "RPN_POST_NMS_TOP_N": 64, "max_per_image": 20},
        "tpu": {"compute_dtype": "float32", "nms_tier": 0}})
    cpu_model = lsfa_from_config(tiny)
    init_params(cpu_model, torch.Generator().manual_seed(3))
    with torch.no_grad():
        cpu_model.rfcn_cls.weight.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(4))
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

    k_ms, p_ms = times["rpn (12, 2048)"]
    print(json.dumps({"kernels": [{
        "name": "nms_sweep", "route": "cuda",
        "source": "lsfa_tpu_torch/csrc/nms_sweep.cu",
        "replaces": "lsfa_tpu/ops/pallas_nms.py:97",
        "launches": launches, "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
