"""The flagship recipe trained on the synthetic VID set, scored on held-out
videos; the counterpart of ``tools/train_synth_full.py``.

It runs the real recipe (ResNet-101 with DCN, OHEM, the warm-up
multi-factor schedule, bf16 compute, the compressed-stream training feed:
frame pairs, MVs, residuals, flips, aspect-grouped buckets) through
``train.driver.train_net`` for --steps steps, writes the logged steps'
metrics, then detects over a held-out synthetic val split through the
evaluation loops (``eval_videos``, or ``eval_videos_rfcn`` for the
single-frame rung) and scores it with ``vid_eval``.

Usage:
  python -m lsfa_tpu_torch.tools.train_synth_full [--rung full] [--steps 2500]
      [--out DIR] [--data DIR] [--videos 30] [--frames 72] [--profile hard]
      [--init-from DIR] [--init-flow DIR] [--resume] [--cpu-smoke] [--device cpu]

It runs on the card unless given --cpu-smoke (the tiny nets of
``configs/*_tiny_smoke.json`` at 128x96 and 96x128) or --device cpu.

Artifacts in --out: ``curves<tag>.jsonl`` (one line per logged step: the
losses and accuracies), ``report<tag>.json`` (steps, steps/s, eval frames,
mAP and AP per gt class), ``checkpoints/<epoch>.pt``.

The videos come from ``data.synth.make_synth_vid_dataset``, which encodes
through the native library; `main` takes `make_dataset` (a callable with
its signature and returns), `open_video` (the training feed's reader of a
path, see ``data.loader.load_pair_sample``) and `open_eval_video` (the
evaluation loops' opener, with ``data.loader.PreparedVideo``'s signature)
in their place, for a machine without the native decoder.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")
RUNGS = ["full", "small", "rnet", "mv_only", "rfcn", "oracle"]
SIZES = ((960, 576), (576, 960))
SMOKE_SIZES = ((128, 96), (96, 128))


def rung_cfg(rung: str, cpu_smoke: bool = False):
    """(config, video sizes) of one ablation rung, shared with
    ``eval_rung`` so that re-evaluation rebuilds the rung's graph. The
    rungs, by the modules they keep:
      mv_only: key = fresh backbone, non-key = pure MV warp (DFF);
      rnet:    + the residual-correction branch;
      small:   + the small-image detail net;
      full:    + FlowNet/Nq long-term key aggregation (the flagship);
      rfcn:    the single-frame baseline, full backbone every frame, DCN
               on so that the ladder's deltas isolate aggregation;
      oracle:  the mv_only graph fed the generator's analytic flow in
               place of decoded MVs (``data/oracle_flow.py``): the bound
               on what any MV estimate can reach on this data."""
    from lsfa_tpu_torch.config import load_config

    if cpu_smoke:
        cfg = load_config(os.path.join(
            CONFIGS, "rfcn_tiny_smoke.json" if rung == "rfcn" else "lsfa_tiny_smoke.json"))
        sizes = SMOKE_SIZES
        cfg.TRAIN.RPN_PRE_NMS_TOP_N = 256
        cfg.TRAIN.RPN_POST_NMS_TOP_N = 64
        cfg.TRAIN.BATCH_ROIS_OHEM = 32
    elif rung == "rfcn":
        cfg = load_config(os.path.join(CONFIGS, "rfcn_resnet101_vid.json"))
        cfg.network.add_dcn = True
        sizes = SIZES
    else:
        cfg = load_config(os.path.join(CONFIGS, "lsfa_resnet101_vid.json"))
        sizes = SIZES
    if rung in ("mv_only", "rnet", "small", "oracle"):
        cfg.network.add_lt_aggregation = False
        cfg.network.add_Nq_net = False
        if rung in ("mv_only", "rnet", "oracle"):
            cfg.network.add_small_net = False
        if rung in ("mv_only", "oracle"):
            cfg.network.add_rnet = False
    if rung == "oracle":
        cfg.network.oracle_mv = True
    return cfg, sizes


def gt_classes_of(annotations) -> list:
    """The sorted classes of the gt boxes in `annotations`."""
    return sorted({int(lbl) for a in annotations.values() for lbl in a["labels"]})


def gt_class_ap(ap, gt_classes) -> np.ndarray:
    """vid_eval's AP of each of gt_classes; a gt class that no detection
    scored (vid_eval's nan) has AP 0, not an undefined one."""
    return np.asarray([ap[c - 1] if np.isfinite(ap[c - 1]) else 0.0 for c in gt_classes])


def evaluate(model, cfg, rung, val_roidb, logger, max_frames, open_eval_video, lt_off=False):
    """The detections of the rung's evaluation loop over val_roidb."""
    from lsfa_tpu_torch.eval.driver import eval_videos, eval_videos_rfcn

    if rung == "rfcn":
        return eval_videos_rfcn(model, cfg, val_roidb, logger=logger, max_frames=max_frames,
                                open_video=open_eval_video)
    return eval_videos(model, cfg, val_roidb, logger=logger, max_frames=max_frames,
                       lt_off=lt_off, open_video=open_eval_video)


def parse_args(argv):
    ap = argparse.ArgumentParser(description="train one ablation rung on synthetic VID")
    ap.add_argument("--steps", type=int, default=2500)
    ap.add_argument("--out", default="lsfa_synth_run")
    ap.add_argument("--data", default="lsfa_synth_data")
    ap.add_argument("--videos", type=int, default=30)
    ap.add_argument("--val-videos", type=int, default=6)
    ap.add_argument("--frames", type=int, default=72)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--cpu-smoke", action="store_true",
                    help="tiny nets on the CPU (a smoke of this tool)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the checkpoint in --out (weights, momentum, the "
                         "schedule's step)")
    ap.add_argument("--tag", default="", help="suffix of the report and curves file names")
    ap.add_argument("--batch-tag", default="",
                    help="training-batch tag written into the report (render_ablation "
                         "chains deltas only within one batch)")
    ap.add_argument("--init-from", default="",
                    help="checkpoint directory of this package (<dir>/<epoch>.pt) of a "
                         "trained detector, the rfcn rung's, whose shared detection stack "
                         "warm-starts this one (JAX's orbax directories do not load here)")
    ap.add_argument("--init-flow", default="",
                    help="checkpoint directory of this package holding a pretrained FlowNet "
                         "(tools.pretrain_flow; JAX's orbax directories do not load here)")
    ap.add_argument("--max-eval-frames", type=int, default=None)
    ap.add_argument("--profile", default="easy", choices=["easy", "hard"],
                    help="synthetic-data difficulty (data/synth.py: hard = occluders, "
                         "distractors, camera motion, low bitrate)")
    ap.add_argument("--rung", default="full", choices=RUNGS,
                    help="module-ablation rung (see rung_cfg)")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    return ap.parse_args(argv)


def main(argv=None, *, make_dataset=None, open_video=None, open_eval_video=None,
         report=None) -> int:
    """Train, evaluate, write the curves and the report; returns 0.
    report: filled with this run's report, the trained model, the curves'
    lines, the train and val roidbs and the config."""
    args = parse_args(argv)

    from lsfa_tpu_torch.data.dataset import append_flipped, filter_roidb
    from lsfa_tpu_torch.eval.vid_eval import vid_eval
    from lsfa_tpu_torch.models.lsfa import resolve_device
    from lsfa_tpu_torch.train.checkpoint import latest_step
    from lsfa_tpu_torch.train.driver import train_net
    from lsfa_tpu_torch.utils.logger import create_logger

    if make_dataset is None:
        from lsfa_tpu_torch.data.synth import make_synth_vid_dataset as make_dataset
    device = resolve_device("cpu" if args.cpu_smoke else args.device)
    os.makedirs(args.out, exist_ok=True)

    cfg, sizes = rung_cfg(args.rung, cpu_smoke=args.cpu_smoke)
    if args.init_from:
        cfg.network.pretrained_detector = args.init_from
    if args.init_flow:
        cfg.network.pretrained_flow = args.init_flow
    cfg.output_path = args.out
    # the synthetic classes are ids 1..8 of the 31-class head; the rest stay background
    logger, _ = create_logger(cfg.output_path, cfg.symbol, "synth")

    t0 = time.perf_counter()
    oracle = args.rung == "oracle"
    train_roidb, _, _ = make_dataset(
        args.data, n_videos=args.videos, n_frames=args.frames, seed=0, sizes=sizes,
        split="train", profile=args.profile, oracle=oracle)
    _, val_roidb, val_annos = make_dataset(
        args.data, n_videos=args.val_videos, n_frames=36, seed=1000, sizes=sizes,
        split="val", profile=args.profile, oracle=oracle)
    logger.info(f"synth data ready in {time.perf_counter() - t0:.1f}s: {len(train_roidb)} "
                f"train frames, {len(val_roidb)} val videos")
    if cfg.TRAIN.FLIP:
        train_roidb = append_flipped(train_roidb)
    train_roidb = filter_roidb(train_roidb)

    # the schedule scaled to the run's length (the recipe's x0.1 at 2/3)
    steps_per_epoch = max(len(train_roidb) // cfg.TRAIN.BATCH_IMAGES, 1)
    epochs_needed = max(1, -(-args.steps // steps_per_epoch))
    cfg.TRAIN.end_epoch = epochs_needed
    cfg.TRAIN.lr_step = str(2.0 * epochs_needed / 3.0)
    cfg.TRAIN.warmup = True
    cfg.TRAIN.warmup_lr = cfg.TRAIN.lr / 10.0
    cfg.TRAIN.warmup_step = min(100, args.steps // 10)
    ckpt_dir = os.path.join(args.out, "checkpoints")
    if args.resume:
        # --steps is the TOTAL target: a restored epoch that already covers
        # it leaves train_net nothing to do, and the report would score the
        # checkpoint unchanged
        cfg.TRAIN.RESUME = True
        done = latest_step(ckpt_dir)
        if done is not None and done >= epochs_needed:
            logger.warning(f"resume target end_epoch={epochs_needed} is already complete "
                           f"(checkpoint at epoch {done}): no training will happen; raise "
                           f"--steps past {epochs_needed * steps_per_epoch}")

    curves = []
    pending = []

    def line(step, metrics):
        return json.dumps({"step": step, **{k: round(float(v), 5) for k, v in metrics.items()}})

    with open(os.path.join(args.out, f"curves{args.tag}.jsonl"), "w") as curves_f:
        def hook(step, metrics):
            if step % args.log_every == 0:
                pending.append((step, metrics))
            # read back one logged step behind, so that the device keeps running
            while len(pending) > 1:
                curves.append(line(*pending.pop(0)))
                curves_f.write(curves[-1] + "\n")
                curves_f.flush()

        t_train = time.perf_counter()
        model = train_net(cfg, roidb=train_roidb, logger=logger, ckpt_dir=ckpt_dir,
                          max_steps=args.steps, metrics_hook=hook, device=device,
                          open_video=open_video)
        train_wall = time.perf_counter() - t_train
        for step, metrics in pending:
            curves.append(line(step, metrics))
            curves_f.write(curves[-1] + "\n")

    # held-out mAP through the evaluation loops
    t_eval = time.perf_counter()
    dets = evaluate(model, cfg, args.rung, val_roidb, logger, args.max_eval_frames,
                    open_eval_video)
    eval_wall = time.perf_counter() - t_eval
    ap = vid_eval(dets, val_annos, cfg.dataset.NUM_CLASSES)
    gt_classes = gt_classes_of(val_annos)
    ap_gt = gt_class_ap(ap, gt_classes)
    n_det = sum(len(d["labels"]) for d in dets.values())
    mean_ap = float(ap_gt.mean()) if len(ap_gt) else float("nan")
    for c, a in zip(gt_classes, ap_gt):
        logger.info(f"AP class {c} = {a:.4f}")
    logger.info(f"synthetic val mAP@0.5 = {mean_ap:.4f} over {len(gt_classes)} gt classes "
                f"({n_det} detections)")

    out = {
        "rung": args.rung,
        "profile": args.profile,
        "steps": args.steps,
        "train_wall_s": round(train_wall, 1),
        "steps_per_s": round(args.steps / train_wall, 3),
        "eval_wall_s": round(eval_wall, 1),
        "eval_frames": len(dets),
        "n_detections": n_det,
        "mAP_synth_val": round(mean_ap, 4),
        "ap_per_class": {int(c): round(float(a), 4) for c, a in zip(gt_classes, ap_gt)},
        "platform": device.type,
    }
    if args.batch_tag:
        out["batch"] = args.batch_tag
    with open(os.path.join(args.out, f"report{args.tag}.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    if report is not None:
        report.update(report=out, model=model, curves=curves, cfg=cfg, train_roidb=train_roidb,
                      val_roidb=val_roidb, train_wall=train_wall, eval_wall=eval_wall)
    return 0


if __name__ == "__main__":
    sys.exit(main())
