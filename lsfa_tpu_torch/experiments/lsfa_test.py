"""Evaluation launcher (the experiments/dff_rfcn/dff_rfcn_test.py role);
the counterpart of ``experiments/lsfa_test.py``.

Usage:
  python -m lsfa_tpu_torch.experiments.lsfa_test \
      --cfg lsfa_tpu_torch/configs/lsfa_resnet101_vid.json \
      [--ckpt <dir>] [--ignore-cache] [--max-frames N] [--streams N] \
      [--thresh T] [--device cpu]

It loads TEST.test_epoch (0: the latest) from the checkpoint directory
(``--ckpt``, else the train run's), builds one record per video of
dataset.test_image_set, runs the loop of ``eval/driver.py`` the config
calls for and prints mAP@0.5. Against the JAX launcher: a record's height
and width come from its first frame's annotation (JAX reads them from
the stream, or from the first JPEG with PIL); ``open_video`` is passed
through to the loops (see ``eval/driver.py``); lockstep lanes
(``--lanes``, ``--mesh``) are not carried, and ``--vis`` needs an image
writer without PIL, which is not written yet.
"""

from __future__ import annotations

import argparse
import logging
import os


def resolve_train_ckpt_dir(cfg, out_dir: str) -> str | None:
    """Default checkpoint tree for this config: the TRAIN run's directory
    (create_logger uses the image_set verbatim) + TRAIN.model_prefix —
    the reference's test.py:57 convention. None if absent."""
    cand = os.path.join(os.path.dirname(out_dir), cfg.dataset.image_set,
                        "checkpoints", cfg.TRAIN.model_prefix)
    return cand if os.path.isdir(cand) else None


def load_model(cfg, ckpt_dir=None, out_dir: str = "", logger=None, device=None):
    """The model `run_test` evaluates: `init_model`'s on `device` (the card
    when None), then the checkpoint of TEST.test_epoch (0: the latest)
    from `ckpt_dir`, or from the train run's directory when None; with
    neither, the random init."""
    from lsfa_tpu_torch.train.checkpoint import load_checkpoint
    from lsfa_tpu_torch.train.driver import init_model

    logger = logger or logging.getLogger("lsfa_tpu_torch.test")
    model = init_model(cfg, device=device, logger=logger)
    ckpt_dir = ckpt_dir or resolve_train_ckpt_dir(cfg, out_dir)
    if ckpt_dir:
        state, epoch = load_checkpoint(ckpt_dir, epoch=int(cfg.TEST.test_epoch) or None)
        model.load_state_dict(state["model"])
        logger.info(f"loaded checkpoint epoch {epoch}")
    else:
        logger.info("NO checkpoint given: evaluating random init")
    return model


def run_test(cfg, ckpt_dir=None, ignore_cache=False, max_frames=None,
             vis_frames: int = 0, thresh: float | None = None, streams: int = 0,
             open_video=None, device=None):
    """Evaluate the config's model over dataset.test_image_set. Returns
    (mAP, per-class AP) of ``eval.driver.evaluate_map``.

    streams > 1 time-multiplexes that many streams through one detector
    (``eval_videos_timeplex``); an ``rfcn*`` symbol runs the single-frame
    R-FCN over every frame (``eval_videos_rfcn``). thresh overrides
    TEST.SCORE_THRESH. open_video: passed to the loops (a callable with
    ``PreparedVideo``'s signature; None opens the videos with the native
    decoder). Detections are cached at ``<out_dir>/detections.pkl`` and
    read back from there unless ignore_cache."""
    if vis_frames:
        raise NotImplementedError(
            "--vis needs an image writer without PIL (ROADMAP Queue 1 item 7)")
    from lsfa_tpu_torch.data.dataset import ImageNetVID
    from lsfa_tpu_torch.eval.driver import (
        eval_videos, eval_videos_rfcn, eval_videos_timeplex, evaluate_map)
    from lsfa_tpu_torch.train.driver import is_rfcn
    from lsfa_tpu_torch.utils.logger import create_logger

    logger, out_dir = create_logger(cfg.output_path, cfg.symbol, cfg.dataset.test_image_set)
    if thresh is not None:
        cfg.TEST.SCORE_THRESH = float(thresh)
    model = load_model(cfg, ckpt_dir, out_dir, logger, device)
    ds = ImageNetVID(cfg.dataset.test_image_set, cfg.dataset.root_path,
                     cfg.dataset.dataset_path)
    # one record per video, sized by its first frame's annotation (0 where
    # there is none: the loops then read the stream)
    video_roidb = []
    for e in ds._index:
        first = ds._load_annotation({"path": e["path"], "frame_seg_id": 0})
        video_roidb.append({
            "vid_path": e["path"],
            "frame_seg_len": e.get("frame_seg_len", 1),
            "pattern": os.path.join(cfg.dataset.dataset_path, "Data", "VID", e["path"],
                                    "%06d.JPEG"),
            "video_path": ds.video_path(e),
            "height": first["height"],
            "width": first["width"],
        })
    kw = dict(det_cache=None if ignore_cache else os.path.join(out_dir, "detections.pkl"),
              logger=logger, max_frames=max_frames, open_video=open_video)
    if is_rfcn(cfg):
        dets = eval_videos_rfcn(model, cfg, video_roidb, **kw)
    elif streams > 1:
        dets = eval_videos_timeplex(model, cfg, video_roidb, streams=streams, **kw)
    else:
        dets = eval_videos(model, cfg, video_roidb, **kw)
    return evaluate_map(dets, ds, video_roidb, logger=logger)


def main(argv=None):
    ap = argparse.ArgumentParser(description="LSFA evaluation on the card")
    ap.add_argument("--cfg", required=True, help=".json or .yaml config")
    ap.add_argument("--ckpt", default=None, help="checkpoint directory")
    ap.add_argument("--ignore-cache", action="store_true")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--streams", type=int, default=0,
                    help="time-multiplexed video streams through one detector")
    ap.add_argument("--vis", type=int, default=0, metavar="N",
                    help="write the first N annotated frames (not ported)")
    ap.add_argument("--thresh", type=float, default=None,
                    help="detection score threshold override")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from lsfa_tpu_torch.config import load_config

    run_test(load_config(args.cfg), ckpt_dir=args.ckpt, ignore_cache=args.ignore_cache,
             max_frames=args.max_frames, vis_frames=args.vis, thresh=args.thresh,
             streams=args.streams, device=args.device)


if __name__ == "__main__":
    main()
