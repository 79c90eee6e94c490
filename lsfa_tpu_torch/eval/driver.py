"""Evaluation driver: detect over videos and compute mAP; the counterpart
of ``lsfa_tpu.eval.driver``.

`eval_videos` streams each video through one `StreamingDetector`, whole
GOP windows at a time with the partial-GOP tail frame by frame;
`eval_videos_timeplex` serves several streams in turn through one
detector, swapping each stream's recurrent state in and out, with one
decoding thread per stream; `eval_videos_lanes` runs several streams in
lockstep as the lanes of one detector, one frame of every lane per step
(``eval/multistream.py``), optionally split over the ranks of a process
group; `eval_videos_rfcn` runs the single-frame R-FCN baseline over every
frame; `eval_videos_fgfa` runs FGFA over every frame, each detected on its
window of 2K + 1 frames, K frames late. All return a detections mapping
{global frame index -> `collect_detections` dict}, the frames numbered
across the video roidb in its order, which `evaluate_map` scores.

The loops open a record's stream with ``data.loader.PreparedVideo``,
which needs the native decoder. On a machine where it does not load, pass
`open_video`, a callable with `PreparedVideo`'s signature, such as a
``functools.partial`` of ``data.loader.SyntheticPreparedVideo``. A frame
past the end of its stream, and every frame of a record without a stream
(no ``video_path``: a VID tree of JPEG frames, read at its ``pattern``),
is read with `read_image` (default: the JPEG reader, which needs PIL)
through the host image chain, with zero MV and residual.

Against the JAX package: the last window of a video is not padded to the
window length (an eager detector has no fixed window shape; the padded
outputs were dropped there); `eval_videos_lanes` shards its lanes over
the ranks of a ``torch.distributed`` group where JAX shards them over a
device mesh.
"""

from __future__ import annotations

import collections
import os
import pickle
import queue
import threading

import numpy as np
import torch

from lsfa_tpu_torch.data import coviar
from lsfa_tpu_torch.data.dataset import ImageNetVID
from lsfa_tpu_torch.data.image import pick_bucket
from lsfa_tpu_torch.data.loader import (
    GOP_SIZE, EvalLoader, PreparedVideo, prepared_available, read_jpeg_bgr)
from lsfa_tpu_torch.data.prefetch import DevicePrefetcher
from lsfa_tpu_torch.eval.fgfa_tester import FGFADetector
from lsfa_tpu_torch.eval.multistream import eval_videos_multistream
from lsfa_tpu_torch.eval.rfcn_tester import RFCNDetector
from lsfa_tpu_torch.eval.tester import StreamingDetector, collect_detections
from lsfa_tpu_torch.eval.vid_eval import vid_eval
from lsfa_tpu_torch.parallel import mesh
from lsfa_tpu_torch.utils.profiler import PhaseTimer


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


def group_videos_by_bucket(video_roidb, cfg, read_image=None):
    """Partition video records by the image bucket their resized frames
    fit, so that portrait and landscape streams each run at their own
    shape. A record without height and width is sized from its stream, or
    where it has none on disk that the native decoder opens, from its
    first frame's image (`read_image`, default the JPEG reader)."""
    target, max_size = cfg.SCALES[0]
    buckets = [tuple(cfg.tpu.default_bucket)] + [tuple(b) for b in cfg.tpu.image_buckets]
    groups: dict = {}
    for rec in video_roidb:
        h, w = rec.get("height", 0), rec.get("width", 0)
        if not h or not w:
            video = rec.get("video_path")
            if video and coviar.available() and os.path.exists(video):
                reader = coviar.VideoReader(video)
                h, w = reader.height, reader.width
            elif "pattern" in rec:
                h, w = (read_image or read_jpeg_bgr)(rec["pattern"] % 0).shape[:2]
            else:
                raise ValueError(f"record {rec.get('vid_path')!r} has no height and width "
                                 f"and no stream or image to read them from")
        groups.setdefault(pick_bucket(h, w, buckets, target, max_size), []).append(rec)
    return groups


def _gop_eval_reason(rec, cfg, opened: bool = False) -> str | None:
    """Why a video cannot go through whole-GOP windows and falls back to
    the per-frame path, or None when it can. The key schedule must equal
    the GOP size: a window keys every GOP, so a multiple like 24 would
    make more key frames than the streaming schedule. opened: the caller
    opens streams itself (`open_video`), so the file and the native
    library are not asked for; a record without a stream (JPEG frames)
    takes the per-frame path whatever opens streams."""
    video = rec.get("video_path")
    if video is None:
        return "no compressed stream on disk"
    if not opened:
        if not os.path.exists(video):
            return "no compressed stream on disk"
        if not prepared_available():
            return "native prepared-decode plane not built"
    if cfg.TEST.KEY_FRAME_INTERVAL != GOP_SIZE:
        return (f"KEY_FRAME_INTERVAL={cfg.TEST.KEY_FRAME_INTERVAL} != "
                f"GOP_SIZE={GOP_SIZE} (GOP window keys every GOP)")
    if rec["frame_seg_len"] < GOP_SIZE:
        return f"video shorter than one GOP ({rec['frame_seg_len']} frames)"
    return None


def _split_by_path(recs, cfg, opened, log):
    """(records for whole-GOP windows, records for the per-frame path),
    logging why videos fall back."""
    gop_recs, frame_recs, reasons = [], [], collections.Counter()
    for rec in recs:
        reason = _gop_eval_reason(rec, cfg, opened)
        if reason is None:
            gop_recs.append(rec)
        else:
            reasons[reason] += 1
            frame_recs.append(rec)
    for reason, count in reasons.items():
        log(f"GOP-window fallback -> per-frame path for {count} video(s): {reason}")
    return gop_recs, frame_recs


def _windows(pv, rec, window: int):
    """The GOP index lists of a video's windows, whole GOPs only, and the
    frame its partial-GOP tail starts at (None without a tail)."""
    n_gops = min(rec["frame_seg_len"], pv.num_frames) // GOP_SIZE
    wins = [list(range(g0, min(g0 + window, n_gops))) for g0 in range(0, n_gops, window)]
    rest = rec["frame_seg_len"] - n_gops * GOP_SIZE
    return wins, (n_gops * GOP_SIZE if rest > 0 else None)


def _tail_record(rec, tail_start, base):
    """The record the per-frame path takes for a video's partial-GOP tail."""
    tail = dict(rec)
    tail["_tail_start"] = tail_start
    base[id(tail)] = base[id(rec)]       # the per-frame path looks up ITS records
    return tail


def _post_window(pending, detections, timer) -> int:
    """Read a window's outputs back (this waits for the device) and file
    them under their global frame indices. Returns the frames filed."""
    if pending is None:
        return 0
    outs, win, vid_base = pending
    with timer.phase("post"):
        kd, kv, cd, cv = (o.cpu().numpy() for o in outs)
        for wi, g in enumerate(win):
            first = vid_base + g * GOP_SIZE
            detections[first] = collect_detections(kd[wi], kv[wi])
            for i in range(cd.shape[1]):
                detections[first + 1 + i] = collect_detections(cd[wi, i], cv[wi, i])
    return len(win) * (1 + cd.shape[1])


def _eval_frames(det, frame_recs, cfg, bucket, base, detections, timer, budget, open_video,
                 read_image):
    """The per-frame path over whole videos and partial-GOP tails: each
    record restarts the detector, and a tail's first frame, a key frame,
    bootstraps it with flag 0 like a fresh stream. Stops after `budget`
    frames (None: no limit). Returns the frames run."""
    done = 0
    if not frame_recs or (budget is not None and budget <= 0):
        return done
    loader = EvalLoader(frame_recs, cfg, bucket_hw=bucket, open_video=open_video,
                        read_image=read_image)
    with DevicePrefetcher(loader, det.device, depth=2) as items:
        cur_video = -1
        for item in items:
            rec = frame_recs[item["video_index"]]
            tail_start = rec.get("_tail_start", 0)
            if item["video_index"] != cur_video:
                det.reset()
                cur_video = item["video_index"]
            flag = item["flag"]
            if tail_start and item["frame_id"] == tail_start:
                flag = 0
            with timer.phase("net"):
                d, v = det.process_frame(item["data"], item["im_info"], item["motion_vector"],
                                         item["res_diff"], flag=flag, small=item["small"])
            with timer.phase("post"):
                detections[base[id(rec)] + item["frame_id"]] = collect_detections(d, v)
            timer.tick()
            done += 1
            if budget is not None and done >= budget:
                break
    return done


def eval_videos(model, cfg, video_roidb, det_cache: str | None = None, logger=None,
                max_frames: int | None = None, lt_off: bool = False, open_video=None,
                read_image=None):
    """Streaming detection over videos, bucketed by orientation. Returns
    {global frame index -> {labels, scores, boxes}}, indexed in the
    original video_roidb frame order.

    model: an LSFA module with its weights, on the device to run on.
    det_cache: a pickle of an earlier run's detections is returned without
    running the net; this run's are written there. max_frames: stop once
    that many frames are filed (checked after each video's windows and
    each per-frame step). lt_off: every key frame bootstraps, which turns
    long-term aggregation off at inference on the same weights.
    open_video, read_image: see the module docstring."""
    log = logger.info if logger else print
    cached = load_det_cache(det_cache, log)
    if cached is not None:
        return cached
    base, _ = frame_bases(video_roidb)
    open_gop = open_video or PreparedVideo
    oracle_on = bool(getattr(cfg.network, "oracle_mv", False))
    window = int(getattr(cfg.tpu, "eval_gop_window", 2))
    timer = PhaseTimer()
    detections = {}
    for bucket, recs in group_videos_by_bucket(video_roidb, cfg, read_image).items():
        log(f"bucket {bucket}: {len(recs)} videos"
            + (" [long-term aggregation OFF]" if lt_off else ""))
        det = StreamingDetector(model, cfg, bucket, lt_off=lt_off)
        frame_counter = 0
        gop_recs, frame_recs = _split_by_path(recs, cfg, open_video is not None, log)
        # one-window deferred posting: enqueue window g, THEN read window
        # g-1 back while g runs on the device and the host decodes g+1;
        # at most two windows are in flight
        pending = None
        for rec in gop_recs:
            det.reset()
            pv = open_gop(rec["video_path"], cfg, bucket,
                          oracle=rec.get("oracle") if oracle_on else None)
            wins, tail_start = _windows(pv, rec, window)
            for win in wins:
                with timer.phase("data"):
                    payloads = [pv.gop(g) for g in win]
                with timer.phase("net"):
                    outs = det.process_prepared_window(payloads, first=(win[0] == 0))
                frame_counter += _post_window(pending, detections, timer)
                pending = (outs, win, base[id(rec)])
                timer.tick()
            if tail_start is not None:
                frame_recs.append(_tail_record(rec, tail_start, base))
            if max_frames is not None and frame_counter >= max_frames:
                break
        frame_counter += _post_window(pending, detections, timer)
        _eval_frames(det, frame_recs, cfg, bucket, base, detections, timer,
                     None if max_frames is None else max_frames - frame_counter, open_video,
                     read_image)
    log(timer.summary())
    save_det_cache(det_cache, detections)
    return detections


def eval_videos_timeplex(model, cfg, video_roidb, streams: int = 3,
                         det_cache: str | None = None, logger=None,
                         max_frames: int | None = None, lt_off: bool = False,
                         open_video=None, read_image=None):
    """`eval_videos` for several streams at once by time-multiplexing:
    each stream keeps its own device-resident recurrent state, and windows
    of different streams take turns through the one detector, which swaps
    the state in and out around each window (handles, no copy). One
    producer thread per stream decodes into a queue of depth 2, overlapped
    with the enqueue. Videos are dealt to streams longest first, each onto
    the least loaded.

    Detections equal `eval_videos`'s over the same records: each video's
    recurrence is the same, only the order of windows interleaves. A
    producer's exception is raised here, and every producer is stopped and
    joined before this returns or raises."""
    log = logger.info if logger else print
    cached = load_det_cache(det_cache, log)
    if cached is not None:
        return cached
    base, _ = frame_bases(video_roidb)
    open_gop = open_video or PreparedVideo
    oracle_on = bool(getattr(cfg.network, "oracle_mv", False))
    window = int(getattr(cfg.tpu, "eval_gop_window", 2))
    timer = PhaseTimer()
    detections = {}
    for bucket, recs in group_videos_by_bucket(video_roidb, cfg, read_image).items():
        det = StreamingDetector(model, cfg, bucket, lt_off=lt_off)
        gop_recs, frame_recs = _split_by_path(recs, cfg, open_video is not None, log)
        n_streams = max(1, min(streams, len(gop_recs)))
        log(f"bucket {bucket}: {len(recs)} videos over {n_streams} time-multiplexed streams")
        lanes: list = [[] for _ in range(n_streams)]
        loads = np.zeros(n_streams)
        for rec in sorted(gop_recs, key=lambda r: -r["frame_seg_len"]):
            i = int(np.argmin(loads))
            lanes[i].append(rec)
            loads[i] += rec["frame_seg_len"]

        stop = threading.Event()
        tails: list = [[] for _ in range(n_streams)]
        qs = [queue.Queue(maxsize=2) for _ in range(n_streams)]

        def offer(s, item):
            """Queue item for stream s unless stopped."""
            while not stop.is_set():
                try:
                    qs[s].put(item, timeout=0.05)
                    return
                except queue.Full:
                    continue

        def producer(s):
            try:
                for rec in lanes[s]:
                    pv = open_gop(rec["video_path"], cfg, bucket,
                                  oracle=rec.get("oracle") if oracle_on else None)
                    wins, tail_start = _windows(pv, rec, window)
                    for win in wins:
                        if stop.is_set():
                            return
                        offer(s, ([pv.gop(g) for g in win], win, base[id(rec)]))
                    if tail_start is not None:
                        tails[s].append((rec, tail_start))
            except Exception as e:                  # raised again by the consumer
                offer(s, e)
                return
            offer(s, None)

        threads = [threading.Thread(target=producer, args=(s,), daemon=True)
                   for s in range(n_streams)]
        for t in threads:
            t.start()
        live = collections.deque(range(n_streams))
        states: dict = {}
        pending = None
        frame_counter = 0
        try:
            while live:
                s = live.popleft()
                with timer.phase("data"):
                    item = qs[s].get()
                if item is None:
                    continue                        # stream exhausted
                if isinstance(item, Exception):
                    raise item
                live.append(s)
                payloads, win, vid_base = item
                first = win[0] == 0
                with timer.phase("net"):
                    if first:
                        det.reset()                 # a new video bootstraps
                    else:
                        det.set_state(states[s])
                    outs = det.process_prepared_window(payloads, first=first)
                    states[s] = det.get_state()
                frame_counter += _post_window(pending, detections, timer)
                pending = (outs, win, vid_base)
                timer.tick()
                if max_frames is not None and frame_counter >= max_frames:
                    break
            frame_counter += _post_window(pending, detections, timer)
        finally:
            stop.set()
            for t in threads:
                t.join()
        for s in range(n_streams):
            frame_recs += [_tail_record(rec, start, base) for rec, start in tails[s]]
        _eval_frames(det, frame_recs, cfg, bucket, base, detections, timer,
                     None if max_frames is None else max_frames - frame_counter, open_video,
                     read_image)
    log(timer.summary())
    save_det_cache(det_cache, detections)
    return detections


def eval_videos_lanes(model, cfg, video_roidb, lanes: int, det_cache: str | None = None,
                      logger=None, max_frames: int | None = None, over_ranks: bool = False,
                      open_video=None, read_image=None, stats: list | None = None):
    """`lanes` video streams in lockstep through one lane-batched detector
    per bucket group (``eval.multistream.eval_videos_multistream``),
    detections merged back to the global frame order of video_roidb: the
    mapping `eval_videos` returns.

    max_frames: the frame cap becomes a step cap (each step advances
    every lane one frame), and a bucket group is charged steps x lanes,
    idle-lane padding included, so later groups cannot run past the cap.
    over_ranks: split the lanes over the ranks of the process group
    (``parallel.mesh``; lanes must divide by the world size): each rank
    runs its contiguous block of the global playlists and rank 0 gathers
    the detections, so rank 0 returns the whole mapping and every other
    rank its own lanes'. stats: receives one dict per bucket group run on
    this rank: its bucket, the `eval_videos_multistream` stats (steps, and
    the lanes this rank carried) and frames, the global indices of the
    real frames this rank's lanes filed, sorted. det_cache, open_video,
    read_image: as `eval_videos`'s (rank 0 writes the cache)."""
    log = logger.info if logger else print
    cached = load_det_cache(det_cache, log)
    if cached is not None:
        return cached
    rank, world = (mesh.rank(), mesh.world_size()) if over_ranks else (0, 1)
    if lanes % world:
        raise ValueError(f"lanes={lanes} must divide by the {world} ranks")
    base, total = frame_bases(video_roidb)
    detections = {}
    budget = max_frames
    for bucket, recs in group_videos_by_bucket(video_roidb, cfg, read_image).items():
        if budget is not None and budget <= 0:
            log(f"bucket {bucket}: skipped (max_frames reached)")
            continue
        log(f"bucket {bucket}: {len(recs)} videos over {lanes} lanes"
            + (f", {lanes // world} on rank {rank} of {world}" if world > 1 else ""))
        group: dict = {}
        lane_dets = eval_videos_multistream(
            model, cfg, recs, lanes=lanes, logger=logger, bucket_hw=bucket,
            max_steps=None if budget is None else max(1, -(-budget // lanes)), stats=group,
            open_video=open_video, read_image=read_image, rank=rank, world=world)
        if budget is not None:
            budget -= group["steps"] * lanes
        for (vi, fid), det in lane_dets.items():
            detections[base[id(recs[vi])] + fid] = det
        if stats is not None:
            stats.append({"bucket": bucket, **group,
                          "frames": sorted(base[id(recs[vi])] + fid for vi, fid in lane_dets)})
    if world > 1:
        import torch.distributed as dist

        parts = [None] * world if rank == 0 else None
        dist.gather_object(detections, parts, dst=0)
        if rank != 0:
            return detections
        detections = {k: d for part in parts for k, d in part.items()}
    missing = total - len(detections)
    if missing and max_frames is None:
        log(f"WARNING: {missing} frames produced no detections record")
    save_det_cache(det_cache, detections)
    return detections


def eval_videos_rfcn(model, cfg, video_roidb, det_cache: str | None = None, logger=None,
                     max_frames: int | None = None, open_video=None, read_image=None):
    """The single-frame R-FCN baseline over every frame of the videos: no
    key-frame state, no motion vectors or residuals. model: an RFCN module
    with its weights. Returns the mapping `eval_videos` returns."""
    log = logger.info if logger else print
    cached = load_det_cache(det_cache, log)
    if cached is not None:
        return cached
    base, _ = frame_bases(video_roidb)
    timer = PhaseTimer()
    detections = {}
    frame_counter = 0
    for bucket, recs in group_videos_by_bucket(video_roidb, cfg, read_image).items():
        if max_frames is not None and frame_counter >= max_frames:
            break
        log(f"bucket {bucket}: {len(recs)} videos (rfcn per-frame)")
        det = RFCNDetector(model, cfg, bucket)
        loader = EvalLoader(recs, cfg, bucket_hw=bucket, full_frames=True, open_video=open_video,
                            read_image=read_image)
        with DevicePrefetcher(loader, det.device, depth=2) as items:
            for item in items:
                with timer.phase("net"):
                    d, v = det.detect(item["data"], item["im_info"])
                with timer.phase("post"):
                    rec = recs[item["video_index"]]
                    detections[base[id(rec)] + item["frame_id"]] = collect_detections(d, v)
                timer.tick()
                frame_counter += 1
                if max_frames is not None and frame_counter >= max_frames:
                    break
    log(timer.summary())
    save_det_cache(det_cache, detections)
    return detections


def eval_videos_fgfa(model, cfg, video_roidb, det_cache: str | None = None, logger=None,
                     max_frames: int | None = None, open_video=None, read_image=None):
    """FGFA over every frame of the videos, one lane: each video's frames
    go to ``FGFADetector.process_frames`` K at a time, a video's first
    chunk with `first`, which emits the previous video's last K frames;
    each bucket's last video is flushed. model: an FGFA module with its
    weights. Returns the mapping `eval_videos` returns."""
    log = logger.info if logger else print
    cached = load_det_cache(det_cache, log)
    if cached is not None:
        return cached
    base, _ = frame_bases(video_roidb)
    timer = PhaseTimer()
    detections = {}
    frame_counter = 0
    for bucket, recs in group_videos_by_bucket(video_roidb, cfg, read_image).items():
        if max_frames is not None and frame_counter >= max_frames:
            break
        log(f"bucket {bucket}: {len(recs)} videos (fgfa, K = {model.window_k})")
        det = FGFADetector(model, cfg, bucket)
        keys, buf = [], []       # the global index of every frame given; the chunk

        def file(out, first_row):
            """Read a call's rows back: row r holds keys[first_row + r], and a
            negative index a row from before the detector's first frame."""
            with timer.phase("post"):
                dets, valid = (o.cpu() for o in out)
                for r in range(dets.shape[0]):
                    if first_row + r >= 0:
                        detections[keys[first_row + r]] = collect_detections(dets[r], valid[r])

        def push(first):
            with timer.phase("net"):
                out = det.process_frames(torch.stack([d for d, _, _ in buf]), buf[0][2],
                                         first=first)
            first_row = len(keys) - det.k
            keys.extend(key for _, key, _ in buf)
            file(out, first_row)
            buf.clear()

        loader = EvalLoader(recs, cfg, bucket_hw=bucket, full_frames=True, open_video=open_video,
                            read_image=read_image)
        cur, first = None, False
        with DevicePrefetcher(loader, det.device, depth=2) as items:
            for item in items:
                if item["video_index"] != cur:
                    if buf:
                        push(first)
                    cur, first = item["video_index"], True
                rec = recs[item["video_index"]]
                buf.append((item["data"].reshape((1,) + tuple(item["data"].shape[-3:])),
                            base[id(rec)] + item["frame_id"], item["im_info"].reshape(1, 3)))
                if len(buf) == det.k:
                    push(first)
                    first = False
                timer.tick()
                frame_counter += 1
                if max_frames is not None and frame_counter >= max_frames:
                    break
        if buf:
            push(first)
        first_row = len(keys) - det.k
        file(det.flush(), first_row)
    log(timer.summary())
    save_det_cache(det_cache, detections)
    return detections


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
