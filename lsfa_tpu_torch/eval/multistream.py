"""Lockstep lane-batched multi-stream evaluation; the counterpart of
``lsfa_tpu.eval.multistream``.

B video streams ride the lanes of one ``StreamingDetector(batch=B)``: each
step runs one frame of every lane in one batch, so the host enqueues a
step's kernels once for B frames. That pays where the host's enqueue, not
the device's work, bounds the rate (``eval_videos_timeplex`` serves
streams in turn through one lane instead).

Lockstep scheduling: every video is padded to a multiple of the key-frame
interval, so all lanes are always at the same position within a GOP and
share one flag per step; a lane that starts a new video at a key step
raises its own is_first flag (the per-lane stream start). Padding frames
are marked not real and their detections dropped.

Against the JAX package: a record's stream is opened with `open_video`
(default ``data.loader.PreparedVideo``, which raises where the native
decoder does not load), never through the decoder's raw fallback; a frame
past the stream's end, and every frame of a record without a stream, is
read with `read_image` through the host chain
(``data.loader.host_payload``), as the port's other loops read it. A
non-key step ships no full-size frame. The lanes of a run can be split
over ranks (`rank`, `world`): each rank runs its contiguous block of the
global playlists, for the global number of steps.
"""

from __future__ import annotations

import numpy as np

from lsfa_tpu_torch.data.loader import (
    GOP_SIZE, PreparedVideo, host_payload, read_jpeg_bgr)
from lsfa_tpu_torch.data.prefetch import DevicePrefetcher
from lsfa_tpu_torch.eval.tester import StreamingDetector


def build_lane_playlists(video_roidb, lanes: int, interval: int):
    """Greedy length-balanced lane assignment; each video padded to a
    multiple of `interval`. Returns per-lane lists of
    (video_idx, frame_id, real)."""
    order = np.argsort([-r["frame_seg_len"] for r in video_roidb])
    playlists = [[] for _ in range(lanes)]
    loads = np.zeros(lanes)
    for vi in order:
        n = video_roidb[vi]["frame_seg_len"]
        padded = int(np.ceil(n / interval) * interval)
        lane = int(np.argmin(loads))
        pl = playlists[lane]
        for f in range(padded):
            fid = min(f, n - 1)
            pl.append((int(vi), fid, f < n))
        loads[lane] += padded
    # more lanes than videos: idle lanes replay video 0 as padding so the
    # fixed-batch programs always see `lanes` streams
    for pl in playlists:
        if not pl:
            pl.extend((int(order[0]), 0, False) for _ in range(interval))
    return playlists


def stack_lane_gops(lane_gops):
    """`StreamingDetector(batch=B).process_gops` inputs from B lanes' GOP
    payloads (``PreparedVideo.gop`` tuples: frames, smalls, mv, res,
    im_info), `lane_gops[l][g]` GOP g of lane l: key_frames (G, B, ...),
    smalls, mvs and ress (G, n, B, ...) (float32 grids), im_info (B, 3)
    from each lane's first GOP."""
    n_gops = len(lane_gops[0])

    def nonkey(k, dtype=None):
        out = np.stack([np.stack([lane[g][k][1:] for lane in lane_gops], axis=1)
                        for g in range(n_gops)])
        return out if dtype is None else out.astype(dtype)

    keys = np.stack([np.concatenate([lane[g][0][0:1] for lane in lane_gops])
                     for g in range(n_gops)])
    info = np.stack([np.asarray(lane[0][4], np.float32) for lane in lane_gops])
    return keys, nonkey(1), nonkey(2, np.float32), nonkey(3, np.float32), info


class MultiStreamEvalLoader:
    """Yields lockstep lane-batched frames for StreamingDetector(batch=B):
    dicts of flag, is_first (B,), data (key steps; None on non-key steps),
    small, motion_vector, res_diff, im_info (B, 3) and lane_meta, the
    (video_idx, frame_id, real) of each lane.

    One loader serves one iteration at a time: its per-lane stream caches
    are mutated from __iter__'s worker threads, so make a fresh loader per
    run. open_video, read_image: as ``data.loader.EvalLoader``'s. rank,
    world: serve lanes [rank*B/world, (rank+1)*B/world) of the `lanes`
    global playlists."""

    def __init__(self, video_roidb, cfg, lanes: int = 4, bucket_hw=None, open_video=None,
                 read_image=None, rank: int = 0, world: int = 1):
        if lanes % world:
            raise ValueError(f"lanes={lanes} must divide by the {world} ranks")
        self.roidb = video_roidb
        self.cfg = cfg
        self.bucket_hw = tuple(bucket_hw or cfg.tpu.default_bucket)
        self.interval = cfg.TEST.KEY_FRAME_INTERVAL
        playlists = build_lane_playlists(video_roidb, lanes, self.interval)
        self.n_steps = max(len(p) for p in playlists)
        per = lanes // world
        self.playlists = playlists[rank * per:(rank + 1) * per]
        self.lanes = per
        self.open_video = open_video or PreparedVideo
        self.read_image = read_image or read_jpeg_bgr
        # per-LANE stream caches: an idle lane replays video 0 alongside the
        # lane that owns it, and a stream handle's one-GOP cache is not
        # thread-safe, so lanes never share one. Each lane is decoded by one
        # task per step, so the per-lane dicts need no lock.
        self._prepared: list = [{} for _ in range(per)]
        # ONE wire format for every lane and step, since the lanes are
        # concatenated into one batch: I420 only when every record has a
        # stream (a record of JPEG frames is read as BGR); frames past a
        # stream's end are packed to it (host_payload)
        self._wire = "bgr8"
        if (getattr(cfg.tpu, "frame_payload", "bgr8") == "i420"
                and self.interval % GOP_SIZE == 0
                and all(rec.get("video_path") for rec in video_roidb)):
            self._wire = "i420"

    def _prepared_frame(self, lane, rec, fid):
        """The stream's payloads of frame fid; None without a stream or past
        its end."""
        video = rec.get("video_path")
        if video is None:
            return None
        cache = self._prepared[lane]
        pv = cache.pop(video, None)
        if pv is None:
            # bounded: a lane is on one video at a time, keep one of slack
            if len(cache) >= 2:
                cache.pop(next(iter(cache)))
            oracle = rec.get("oracle") if getattr(self.cfg.network, "oracle_mv", False) else None
            pv = self.open_video(video, self.cfg, self.bucket_hw, wire_fmt=self._wire,
                                 oracle=oracle)
        cache[video] = pv                    # LRU: (re)inserted as the newest
        if fid >= pv.num_frames:
            return None
        return pv.frame(fid)

    def _lane_step(self, l, t):
        """Lane l's frame of step t: (data, small, mv, res, im_info row,
        (video_idx, frame_id, real)). Touches only this lane's cache, so
        lanes run concurrently."""
        pl = self.playlists[l]
        vi, fid, real = pl[min(t, len(pl) - 1)]
        real = real and t < len(pl)
        rec = self.roidb[vi]
        prep = self._prepared_frame(l, rec, fid)
        if prep is not None:
            data, small, mv, res, info = prep
        else:
            data, small, info, mv, res = host_payload(
                self.read_image(rec["pattern"] % fid), self.cfg, self.bucket_hw, self._wire)
        return data, small, mv, res, info.reshape(3), (vi, fid, real)

    def __iter__(self):
        # lane-parallel decode (tpu.decode_workers > 1): the native data
        # plane releases the GIL; lanes are independent and rows are put
        # back in lane order, so the output is the serial path's
        workers = int(getattr(self.cfg.tpu, "decode_workers", 0))
        pool = None
        if workers > 1 and self.lanes > 1:
            from concurrent.futures import ThreadPoolExecutor
            pool = ThreadPoolExecutor(max_workers=min(workers, self.lanes))
        prev_video = [-1] * self.lanes
        try:
            for t in range(self.n_steps):
                flag = 0 if t == 0 else (1 if t % self.interval == 0 else 2)
                if pool is not None:
                    rows = list(pool.map(lambda l: self._lane_step(l, t), range(self.lanes)))
                else:
                    rows = [self._lane_step(l, t) for l in range(self.lanes)]
                is_first = np.zeros(self.lanes, np.float32)
                for l, row in enumerate(rows):
                    vi = row[5][0]
                    if flag in (0, 1) and vi != prev_video[l]:
                        is_first[l] = 1.0
                        prev_video[l] = vi
                yield {
                    "flag": flag,
                    "is_first": is_first,
                    "data": np.concatenate([r[0] for r in rows]) if flag in (0, 1) else None,
                    "small": np.concatenate([r[1] for r in rows]),
                    "motion_vector": np.concatenate([r[2] for r in rows]),
                    "res_diff": np.concatenate([r[3] for r in rows]),
                    "im_info": np.stack([r[4] for r in rows]),
                    "lane_meta": [r[5] for r in rows],
                }
        finally:
            if pool is not None:
                pool.shutdown()


def eval_videos_multistream(model, cfg, video_roidb, lanes: int = 4, logger=None,
                            max_steps: int | None = None, bucket_hw=None,
                            stats: dict | None = None, open_video=None, read_image=None,
                            rank: int = 0, world: int = 1):
    """Lane-batched streaming detection. Returns
    {(video_idx, frame_id) -> {labels, scores, boxes}} of the real frames
    of this rank's lanes (all lanes when world is 1).

    model: an LSFA module with its weights, on the device to run on.
    max_steps: stop after that many lockstep steps. stats: receives
    {"steps": N, "lanes": L}: the steps run (each `lanes` frames of device
    work, idle-lane padding included), so that callers with a frame
    budget can charge the real work, and the lanes this rank carried,
    read from the leading dimension of the detector's key-feature carry
    (lanes // world when the lanes are split over ranks). A step's
    detections are read back while the next step runs."""
    log = logger.info if logger else print
    h, w = bucket_hw or cfg.tpu.default_bucket
    loader = MultiStreamEvalLoader(video_roidb, cfg, lanes=lanes, bucket_hw=(h, w),
                                   open_video=open_video, read_image=read_image, rank=rank,
                                   world=world)
    det = StreamingDetector(model, cfg, (h, w), batch=loader.lanes)
    detections = {}

    def post(pending):
        if pending is None:
            return
        d, v, meta = pending
        d, v = d.cpu().numpy(), v.cpu().numpy()
        for l, (vi, fid, real) in enumerate(meta):
            if real:
                dl = d[l][v[l]]
                detections[(vi, fid)] = {"labels": dl[:, 0].astype(int), "scores": dl[:, 1],
                                         "boxes": dl[:, 2:6]}

    steps_run = 0
    pending = None
    with DevicePrefetcher(loader, det.device, depth=2) as items:
        for item in items:
            d, v = det.process_frame(item["data"], item["im_info"], item["motion_vector"],
                                     item["res_diff"], flag=item["flag"], small=item["small"],
                                     is_first=item["is_first"])
            post(pending)
            pending = (d, v, item["lane_meta"])
            steps_run += 1
            if max_steps is not None and steps_run >= max_steps:
                break
    post(pending)
    if stats is not None:
        stats.update(steps=steps_run, lanes=det.feat_key.shape[0])
    log(f"multistream eval: {len(detections)} frames over {loader.lanes} lanes")
    return detections
