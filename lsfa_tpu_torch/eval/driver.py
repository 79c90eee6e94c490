"""Evaluation glue that needs no decoder; the counterparts of the helpers
of ``lsfa_tpu.eval.driver``: video sharding by frame count, the global
frame index of each video, the detection cache, and mAP over per-frame
annotations.

A detections mapping is {global frame index -> `collect_detections`
dict}, the frames numbered across the video roidb in its order. The
evaluation loops over decoded videos (eval_videos, eval_videos_rfcn,
eval_videos_timeplex) wait for a decoder on the card's machine.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from lsfa_tpu_torch.data.dataset import ImageNetVID
from lsfa_tpu_torch.eval.vid_eval import vid_eval


def shard_videos(roidb, n_shards: int):
    """Greedy bin-packing of video records by frame count: the longest
    first, each onto the least loaded shard."""
    order = np.argsort([-r["frame_seg_len"] for r in roidb])
    shards = [[] for _ in range(n_shards)]
    loads = np.zeros(n_shards)
    for i in order:
        s = int(np.argmin(loads))
        shards[s].append(roidb[i])
        loads[s] += roidb[i]["frame_seg_len"]
    return shards


def frame_bases(video_roidb):
    """Global frame index of each video's first frame (keyed by id(rec),
    in the roidb's order) and the total frame count."""
    base = {}
    acc = 0
    for rec in video_roidb:
        base[id(rec)] = acc
        acc += rec["frame_seg_len"]
    return base, acc


def load_det_cache(det_cache, log):
    """The detections pickled at `det_cache` (written by `save_det_cache`
    of an earlier run), or None when there is none."""
    if det_cache and os.path.exists(det_cache):
        with open(det_cache, "rb") as f:
            log(f"loaded detection cache {det_cache}")
            return pickle.load(f)
    return None


def save_det_cache(det_cache, detections):
    if det_cache:
        os.makedirs(os.path.dirname(det_cache) or ".", exist_ok=True)
        with open(det_cache, "wb") as f:
            pickle.dump(detections, f, protocol=pickle.HIGHEST_PROTOCOL)


def evaluate_map(detections, dataset: ImageNetVID, video_roidb, logger=None):
    """mAP@0.5 of `detections` against the per-frame annotations of the
    videos (each record's vid_path and frame_seg_len). Returns (mean AP
    over the classes with gt, per-class AP with nan where a class has no
    gt)."""
    log = logger.info if logger else print
    annotations = {}
    idx = 0
    for rec in video_roidb:
        for fid in range(rec["frame_seg_len"]):
            entry = {"path": rec["vid_path"], "frame_seg_id": fid}
            anno = dataset._load_annotation(entry)
            annotations[idx] = {"labels": anno["gt_classes"], "boxes": anno["boxes"]}
            idx += 1
    ap = vid_eval(detections, annotations, dataset.num_classes)
    mean_ap = float(np.nanmean(ap))
    for name, a in zip(dataset.classes[1:], ap):
        log(f"AP {name:>16s} = {a:.4f}" if np.isfinite(a) else f"AP {name:>16s} = (no gt)")
    log(f"mAP@0.5 = {mean_ap:.4f}")
    return mean_ap, ap
