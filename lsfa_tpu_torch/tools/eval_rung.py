"""Re-score a trained ablation rung's checkpoint on a fresh, larger
held-out synthetic val set; the counterpart of ``tools/eval_rung.py``.

The in-run evaluation of ``train_synth_full`` scores 6 val videos, few
enough that rung-to-rung deltas of ~0.01 mAP ride on sampling noise. This
tool loads the rung's checkpoint (``train.checkpoint.load_checkpoint``),
rebuilds the rung's graph (the shared `rung_cfg`), draws a val set under
another generator seed (new data, not a superset of the in-run split) and
runs the evaluation loops and ``vid_eval``. Besides the mAP it reports the
key-frame and non-key-frame mAP and the mAP by frames from the key frame.

Usage:
  python -m lsfa_tpu_torch.tools.eval_rung --rung small --ckpt DIR/checkpoints
      [--val-videos 24] [--val-seed 2000] [--frames 36] [--profile hard]
      [--out DIR] [--lt-off] [--cpu-smoke] [--device cpu]

It runs on the card unless given --cpu-smoke or --device cpu. `main`
takes `make_dataset` and `open_eval_video` as ``train_synth_full.main``
does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from lsfa_tpu_torch.tools.train_synth_full import (
    RUNGS, evaluate, gt_class_ap, gt_classes_of, rung_cfg)


def rung_report(dets, annos, n_cls: int, frames: int, key_interval: int) -> dict:
    """The scores of detections `dets` against `annos` ({global frame
    index -> labels, boxes}) of videos of `frames` frames each, keyed every
    `key_interval` frames: mAP_synth_val, mAP_key_frames,
    mAP_nonkey_frames, mAP_by_offset (the mAP of the frames that lie k
    frames after their key frame, k < key_interval) and ap_per_class. A gt
    class with no detection scores AP 0. The key and non-key split
    localizes a module's gain (long-term aggregation acts on key frames,
    the R-net and the small net on non-key ones); mAP by offset shows
    whether warped features decay with distance from the key frame."""
    from lsfa_tpu_torch.eval.vid_eval import vid_eval

    gt_classes = gt_classes_of(annos)

    def subset_map(keep):
        sub_d = {g: d for g, d in dets.items() if keep(g)}
        sub_a = {g: a for g, a in annos.items() if keep(g)}
        vals = gt_class_ap(vid_eval(sub_d, sub_a, n_cls), gt_classes)
        return (float(vals.mean()) if len(vals) else float("nan")), vals

    mean_ap, ap_gt = subset_map(lambda g: True)
    map_key, _ = subset_map(lambda g: (g % frames) % key_interval == 0)
    map_nonkey, _ = subset_map(lambda g: (g % frames) % key_interval != 0)
    by_offset = [round(subset_map(lambda g, o=off: (g % frames) % key_interval == o)[0], 4)
                 for off in range(key_interval)]
    return {"mAP_synth_val": round(mean_ap, 4),
            "mAP_key_frames": round(map_key, 4),
            "mAP_nonkey_frames": round(map_nonkey, 4),
            "mAP_by_offset": by_offset,
            "ap_per_class": {int(c): round(float(a), 4) for c, a in zip(gt_classes, ap_gt)}}


def main(argv=None, *, make_dataset=None, open_eval_video=None, report=None) -> int:
    """Evaluate and write report_<rung>_<tag>.json in --out; returns 0.
    report: filled with this run's report, detections, model and val
    roidb."""
    ap = argparse.ArgumentParser(description="re-score an ablation rung's checkpoint")
    ap.add_argument("--rung", required=True, choices=RUNGS)
    ap.add_argument("--ckpt", default="",
                    help="checkpoint directory (default lsfa_ablation/<rung>/checkpoints)")
    ap.add_argument("--epoch", type=int, default=None, help="checkpoint epoch (default: latest)")
    ap.add_argument("--data", default="lsfa_synth_data")
    ap.add_argument("--val-videos", type=int, default=24)
    ap.add_argument("--val-seed", type=int, default=2000)
    ap.add_argument("--frames", type=int, default=36)
    ap.add_argument("--profile", default="hard", choices=["easy", "hard"])
    ap.add_argument("--out", default="runs/ablation_torch",
                    help="directory for report_<rung>_<tag>.json")
    ap.add_argument("--tag", default=None,
                    help="report file name tag (default xval, or xval_ltoff with --lt-off)")
    ap.add_argument("--lt-off", action="store_true",
                    help="turn long-term aggregation off at inference (every key frame "
                         "bootstraps): same weights, an exact A/B of the FlowNet/Nq stage")
    ap.add_argument("--max-eval-frames", type=int, default=None)
    ap.add_argument("--cpu-smoke", action="store_true",
                    help="tiny nets on the CPU (a smoke of this tool)")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)
    if args.tag is None:
        args.tag = "xval_ltoff" if args.lt_off else "xval"
    if args.lt_off and args.rung == "rfcn":
        ap.error("--lt-off is meaningless for the single-frame rfcn rung")

    from lsfa_tpu_torch.models.lsfa import resolve_device
    from lsfa_tpu_torch.train.checkpoint import load_checkpoint
    from lsfa_tpu_torch.train.driver import init_model
    from lsfa_tpu_torch.utils.logger import create_logger

    if make_dataset is None:
        from lsfa_tpu_torch.data.synth import make_synth_vid_dataset as make_dataset
    device = resolve_device("cpu" if args.cpu_smoke else args.device)
    ckpt = args.ckpt or os.path.join("lsfa_ablation", args.rung, "checkpoints")
    cfg, sizes = rung_cfg(args.rung, cpu_smoke=args.cpu_smoke)
    cfg.output_path = args.out
    logger, _ = create_logger(cfg.output_path, cfg.symbol, f"xval_{args.rung}")

    _, val_roidb, val_annos = make_dataset(
        args.data, n_videos=args.val_videos, n_frames=args.frames, seed=args.val_seed,
        sizes=sizes, split="val", profile=args.profile, oracle=(args.rung == "oracle"))
    logger.info(f"extended val set: {len(val_roidb)} videos x {args.frames} frames "
                f"(seed {args.val_seed})")

    model = init_model(cfg, device=device, logger=logger)
    restored, epoch = load_checkpoint(ckpt, args.epoch)
    model.load_state_dict(restored["model"])
    logger.info(f"loaded rung '{args.rung}' checkpoint epoch {epoch} from {ckpt}")

    t_eval = time.perf_counter()
    dets = evaluate(model, cfg, args.rung, val_roidb, logger, args.max_eval_frames,
                    open_eval_video, lt_off=args.lt_off)
    eval_wall = time.perf_counter() - t_eval
    scores = rung_report(dets, val_annos, cfg.dataset.NUM_CLASSES, args.frames,
                         cfg.TEST.KEY_FRAME_INTERVAL)
    n_det = sum(len(d["labels"]) for d in dets.values())
    for c, a in scores["ap_per_class"].items():
        logger.info(f"AP class {c} = {a:.4f}")
    logger.info(f"extended-val mAP@0.5 = {scores['mAP_synth_val']:.4f} over "
                f"{len(scores['ap_per_class'])} gt classes ({n_det} detections); key-frame mAP "
                f"= {scores['mAP_key_frames']:.4f}, non-key mAP = "
                f"{scores['mAP_nonkey_frames']:.4f}")
    logger.info("mAP by frames-from-key: " + " ".join(f"{m:.3f}" for m in scores["mAP_by_offset"]))

    out = {
        "rung": args.rung,
        "profile": args.profile,
        "ckpt": ckpt,
        "ckpt_epoch": int(epoch),
        "val_videos": args.val_videos,
        "val_seed": args.val_seed,
        "lt_off": bool(args.lt_off),
        "eval_wall_s": round(eval_wall, 1),
        "eval_frames": len(dets),
        "n_detections": n_det,
        **scores,
        "platform": device.type,
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"report_{args.rung}_{args.tag}.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    if report is not None:
        report.update(report=out, detections=dets, eval_wall=eval_wall, model=model,
                      val_roidb=val_roidb)
    return 0


if __name__ == "__main__":
    sys.exit(main())
