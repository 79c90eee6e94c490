"""End-to-end learn->detect smoke; the counterpart of
``tools/overfit_smoke.py``: overfit the tiny LSFA on one synthetic scene,
then check that the streaming detector finds the object and the VID
evaluator scores it.

It runs the whole training and detection stack without data: the scene's
batch -> on-device anchor and roi targets -> OHEM losses -> SGD -> the
streaming detector -> ``vid_eval``. The scene is a 210-grey box
[30, 16, 85, 47] of class 3 on a 40-grey frame, a static video (eq flags
1, zero MV and residual); the tiny config's JSON twin with
RPN_PRE_NMS_TOP_N 128, RPN_POST_NMS_TOP_N 32 and BATCH_ROIS_OHEM 16; SGD
at 2e-3 (no decay step in reach). It passes when AP[class 3] > 0.49.

Usage: python -m lsfa_tpu_torch.tools.overfit_smoke [--steps 80] [--device cpu]

It runs on the card unless given --device cpu. The initial weights come
from this package's seeded init (seed 0), not JAX's.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs", "lsfa_tiny_smoke.json")
GT_BOX = np.asarray([30.0, 16.0, 85.0, 47.0])
GT_CLASS = 3
AP_GATE = 0.49


def smoke_config():
    """The tiny LSFA config with the smoke's RPN and OHEM budgets."""
    from lsfa_tpu_torch.config import load_config

    return load_config(CONFIG, overrides={"TRAIN": {
        "RPN_PRE_NMS_TOP_N": 128, "RPN_POST_NMS_TOP_N": 32, "BATCH_ROIS_OHEM": 16}})


def scene(cfg):
    """(frame (1, H, W, 3) float32, the train batch as numpy arrays)."""
    h, w = cfg.tpu.default_bucket
    fh, fw = h // 16, w // 16
    frame = np.full((1, h, w, 3), 40.0, np.float32)
    frame[:, 16:48, 30:86] = 210.0
    gt = np.zeros((1, 8, 5), np.float32)
    gt[0, 0] = [*GT_BOX, float(GT_CLASS)]
    gtv = np.zeros((1, 8), bool)
    gtv[0, 0] = True
    batch = {
        "data": frame, "data_ref": frame, "data_ref_old": frame,
        "eq_flag": np.ones((1,), np.float32), "eq_flag_old": np.ones((1,), np.float32),
        "motion_vector": np.zeros((1, fh, fw, 2), np.float32),
        "res_diff": np.zeros((1, fh, fw, 3), np.float32),
        "gt_boxes": gt, "gt_valid": gtv,
        "im_info": np.asarray([[h, w, 1.0]], np.float32),
    }
    return frame, batch


def train(model, cfg, batch, steps: int, draws=None, seed: int = 0, log=print):
    """`steps` train steps of `model` on the one batch (SGD, lr 2e-3).
    draws(i): the step's uniform draws (default: ``draw_uniforms`` from a
    generator on the model's device seeded with `seed`). Returns the
    metrics of every step as floats."""
    from lsfa_tpu_torch.data.loader import batch_to_device
    from lsfa_tpu_torch.train.schedule import make_optimizer
    from lsfa_tpu_torch.train.train_step import TrainSettings, draw_uniforms, make_train_step

    device = next(model.parameters()).device
    settings = TrainSettings.from_config(cfg)
    optimizer, scheduler = make_optimizer(model, base_lr=2e-3, lr_steps=[10000])
    step = make_train_step(model, settings, optimizer, scheduler)
    dev_batch = batch_to_device(batch, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    history = []
    for i in range(steps):
        d = draws(i) if draws is not None else draw_uniforms(settings, dev_batch, gen)
        history.append(step(dev_batch, {k: v.to(device) for k, v in d.items()}))
        if i % 20 == 0 or i == steps - 1:
            m = history[-1]
            log(f"step {i:3d} total={float(m['total_loss']):.4f} "
                f"rpn_acc={float(m['rpn_acc']):.3f} rcnn_acc={float(m['rcnn_acc']):.3f}")
    return [{k: float(v) for k, v in m.items()} for m in history]


def detect(model, cfg, frame, batch, log=print):
    """The trained model's detections on the scene's frame (flag 0) and
    vid_eval's per-class AP against its one box. Returns (detections,
    AP array)."""
    from lsfa_tpu_torch.eval.tester import StreamingDetector, collect_detections
    from lsfa_tpu_torch.eval.vid_eval import vid_eval

    det = StreamingDetector(model, cfg, tuple(cfg.tpu.default_bucket))
    d, v = det.process_frame(frame, batch["im_info"], flag=0)
    out = collect_detections(d, v)
    ap = vid_eval({0: out}, {0: {"labels": np.asarray([GT_CLASS]), "boxes": GT_BOX[None]}},
                  cfg.dataset.NUM_CLASSES)
    for t in np.argsort(-out["scores"])[:3]:
        log(f"det cls={out['labels'][t]} score={out['scores'][t]:.3f} "
            f"box={np.round(out['boxes'][t], 1)}")
    log(f"gt box: {GT_BOX}  AP[class {GT_CLASS}] = {ap[GT_CLASS - 1]:.3f}")
    return out, ap


def main(steps: int = 80, device=None, log=print, report: dict | None = None) -> int:
    """Train and detect; 0 when AP[class 3] > 0.49, else 1. device: None
    for the card (raises without one), or "cpu". report: filled with the
    step metrics, the seconds of the steps, the detections and the AP."""
    from lsfa_tpu_torch.train.driver import build_model

    cfg = smoke_config()
    frame, batch = scene(cfg)
    model = build_model(cfg, rng_seed=0, device=device)
    t0 = time.perf_counter()
    history = train(model, cfg, batch, steps, log=log)
    seconds = time.perf_counter() - t0
    out, ap = detect(model, cfg, frame, batch, log=log)
    score = ap[GT_CLASS - 1]
    ok = bool(np.isfinite(score) and score > AP_GATE)
    log("OVERFIT SMOKE: " + ("PASS" if ok else "FAIL"))
    if report is not None:
        report.update(history=history, train_seconds=seconds, detections=out, ap=ap)
    return 0 if ok else 1


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="learn->detect smoke of the tiny LSFA")
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args()
    sys.exit(main(args.steps, args.device))
