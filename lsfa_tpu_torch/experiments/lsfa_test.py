"""Evaluation launcher (the experiments/dff_rfcn/dff_rfcn_test.py role);
the counterpart of ``experiments/lsfa_test.py``.

Usage:
  python -m lsfa_tpu_torch.experiments.lsfa_test \
      --cfg lsfa_tpu_torch/configs/lsfa_resnet101_vid.json \
      [--ckpt <dir>] [--ignore-cache] [--max-frames N] [--streams N] \
      [--lanes N [--mesh M] [--decode-workers N]] [--thresh T] [--vis N] \
      [--device cpu]
  torchrun --nproc-per-node M -m lsfa_tpu_torch.experiments.lsfa_test \
      --cfg ... --lanes N --mesh M

It loads TEST.test_epoch (0: the latest) from the checkpoint directory
(``--ckpt``, else the train run's), builds one record per video of
dataset.test_image_set, runs the loop of ``eval/driver.py`` the config
calls for and prints mAP@0.5. A video whose compressed stream is not on
disk (when no ``open_video`` is given) is evaluated from its JPEG frames.
``--vis N`` writes the first N frames that have detections and an image,
annotated, to ``<out_dir>/vis/<global frame>.png``. Against the JAX
launcher: a record's height and width come from its first frame's
annotation (JAX reads them from the stream, or from the first JPEG with
PIL); ``open_video`` and ``read_image`` are passed through to the loops
(see ``eval/driver.py``) and ``--vis`` reads its frames with
``read_image``; ``--vis`` writes PNG (``utils.vis.write_png``), where JAX
writes JPEG; ``--mesh M`` splits the lanes over M ranks of a
``torch.distributed`` group (one process per card, as torchrun starts
them; rank 0 prints the mAP), where JAX shards them over M devices of one
process.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch


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
             open_video=None, device=None, read_image=None, model=None, lanes: int = 1,
             mesh_shape: int = 0):
    """Evaluate the config's model over dataset.test_image_set. Returns
    (mAP, per-class AP) of ``eval.driver.evaluate_map``.

    streams > 1 time-multiplexes that many streams through one detector
    (``eval_videos_timeplex``); else lanes > 1 runs that many streams in
    lockstep as the lanes of one detector (``eval_videos_lanes``), and
    mesh_shape > 0 splits those lanes over the ranks of the process group,
    which must have mesh_shape ranks (lanes % mesh_shape == 0): rank 0
    returns the result, every other rank None. An ``rfcn*`` symbol runs
    the single-frame R-FCN over every frame (``eval_videos_rfcn``). thresh
    overrides
    TEST.SCORE_THRESH. open_video, read_image: passed to the loops (a
    callable with ``PreparedVideo``'s signature, None opening the videos
    with the native decoder; a reader of the frames past a stream's end,
    None reading their JPEGs). model: evaluate this model (e.g. the one
    ``train_net`` just trained) in place of `load_model`'s. Detections are
    cached at ``<out_dir>/detections.pkl`` and read back from there unless
    ignore_cache. vis_frames: write that many annotated frames
    (`write_vis`)."""
    from lsfa_tpu_torch.data.dataset import ImageNetVID
    from lsfa_tpu_torch.eval.driver import (
        eval_videos, eval_videos_lanes, eval_videos_rfcn, eval_videos_timeplex, evaluate_map)
    from lsfa_tpu_torch.parallel import mesh
    from lsfa_tpu_torch.train.driver import is_rfcn
    from lsfa_tpu_torch.utils.logger import create_logger

    if mesh_shape:
        if mesh.world_size() != mesh_shape:
            raise ValueError(f"--mesh {mesh_shape} needs a process group of {mesh_shape} ranks, "
                             f"not {mesh.world_size()}")
        if lanes % mesh_shape:
            raise ValueError(f"lanes={lanes} must divide by mesh size {mesh_shape}")
    logger, out_dir = create_logger(cfg.output_path, cfg.symbol, cfg.dataset.test_image_set)
    if thresh is not None:
        cfg.TEST.SCORE_THRESH = float(thresh)
    if model is None:
        model = load_model(cfg, ckpt_dir, out_dir, logger, device)
    ds = ImageNetVID(cfg.dataset.test_image_set, cfg.dataset.root_path,
                     cfg.dataset.dataset_path)
    # one record per video, sized by its first frame's annotation (0 where
    # there is none: the loops then read the stream)
    video_roidb = []
    for e in ds._index:
        first = ds._load_annotation({"path": e["path"], "frame_seg_id": 0})
        video = ds.video_path(e)
        video_roidb.append({
            "vid_path": e["path"],
            "frame_seg_len": e.get("frame_seg_len", 1),
            "pattern": os.path.join(cfg.dataset.dataset_path, "Data", "VID", e["path"],
                                    "%06d.JPEG"),
            # without a stream on disk the loops read the video's JPEG frames
            "video_path": video if open_video is not None or os.path.exists(video) else None,
            "height": first["height"],
            "width": first["width"],
        })
    kw = dict(det_cache=None if ignore_cache else os.path.join(out_dir, "detections.pkl"),
              logger=logger, max_frames=max_frames, open_video=open_video,
              read_image=read_image)
    if is_rfcn(cfg):
        dets = eval_videos_rfcn(model, cfg, video_roidb, **kw)
    elif streams > 1:
        dets = eval_videos_timeplex(model, cfg, video_roidb, streams=streams, **kw)
    elif lanes > 1:
        dets = eval_videos_lanes(model, cfg, video_roidb, lanes=lanes,
                                 over_ranks=mesh_shape > 0, **kw)
        if mesh.rank() != 0:
            return None
    else:
        dets = eval_videos(model, cfg, video_roidb, **kw)
    if vis_frames:
        write_vis(dets, video_roidb, os.path.join(out_dir, "vis"), vis_frames, read_image,
                  logger)
    return evaluate_map(dets, ds, video_roidb, logger=logger)


def write_vis(dets, video_roidb, vis_dir: str, max_frames: int, read_image=None,
              logger=None) -> int:
    """Write up to max_frames annotated frames to
    ``<vis_dir>/<global frame index, 6 digits>.png``, in the roidb's frame
    order: a frame is written where it has detections and its image
    (``pattern % frame``, read with read_image, default the JPEG reader)
    can be read. Returns the count."""
    from lsfa_tpu_torch.data.loader import read_jpeg_bgr
    from lsfa_tpu_torch.utils.vis import draw_detections, write_png

    read_image = read_image or read_jpeg_bgr
    os.makedirs(vis_dir, exist_ok=True)
    gidx = written = 0
    for rec in video_roidb:
        for fid in range(rec["frame_seg_len"]):
            if written >= max_frames:
                break
            if gidx in dets:
                try:
                    im = read_image(rec["pattern"] % fid)
                except OSError:
                    im = None
                if im is not None:
                    rgb = np.clip(np.asarray(im, np.float32)[:, :, ::-1], 0, 255)
                    write_png(os.path.join(vis_dir, f"{gidx:06d}.png"),
                              draw_detections(rgb, dets[gidx]))
                    written += 1
            gidx += 1
        if written >= max_frames:
            break
    (logger.info if logger else print)(f"wrote {written} annotated frames to {vis_dir}")
    return written


def main(argv=None):
    ap = argparse.ArgumentParser(description="LSFA evaluation on the card")
    ap.add_argument("--cfg", required=True, help=".json or .yaml config")
    ap.add_argument("--ckpt", default=None, help="checkpoint directory")
    ap.add_argument("--ignore-cache", action="store_true")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--streams", type=int, default=0,
                    help="time-multiplexed video streams through one detector")
    ap.add_argument("--lanes", type=int, default=1,
                    help="video streams in lockstep as the lanes of one detector")
    ap.add_argument("--mesh", type=int, default=0,
                    help="split the lanes over this many ranks (one process each)")
    ap.add_argument("--decode-workers", type=int, default=None,
                    help="lane-parallel decode threads (default cfg.tpu.decode_workers)")
    ap.add_argument("--vis", type=int, default=0, metavar="N",
                    help="write the first N annotated frames to <out_dir>/vis")
    ap.add_argument("--thresh", type=float, default=None,
                    help="detection score threshold override")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from lsfa_tpu_torch.config import load_config
    from lsfa_tpu_torch.parallel import mesh

    cfg = load_config(args.cfg)
    if args.decode_workers is not None:
        cfg.tpu.decode_workers = args.decode_workers
    device = args.device
    if args.mesh and not mesh.active():
        device = mesh.initialize_distributed(device=device)      # torchrun's env://
    try:
        run_test(cfg, ckpt_dir=args.ckpt, ignore_cache=args.ignore_cache,
                 max_frames=args.max_frames, vis_frames=args.vis, thresh=args.thresh,
                 streams=args.streams, device=device, lanes=args.lanes, mesh_shape=args.mesh)
    finally:
        if args.mesh:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
