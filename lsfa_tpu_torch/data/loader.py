"""Batch assembly and the per-video data plane, the counterparts of
``lsfa_tpu.data.loader`` without a module-level PIL import:

  * training: `load_pair_sample` (one sample of the get_pair_image
    contract, from the native decoder's one-call fast path or the host
    image chain of ``data/image.py``), `collate_train_batch`, and
    `TrainLoader`, the shuffling epoch iterator with worker threads, which
    loads each rank's slice of a global batch; seeded synthetic train
    batches shaped like its output;
  * readers: a video reader has ``get_num_frames()`` and
    ``load(gop, pos, representation)`` (0: BGR uint8 frame, 1: int MV
    (H, W, 2), 2: int residual (H, W, 3)); `open_native_video` opens the
    native decoder's, `SyntheticVideoReader` is its seeded stand-in, and
    `read_jpeg_bgr` reads a still image (importing PIL when called);
  * evaluation: `PreparedVideo` over the native decoder, its seeded
    stand-in `SyntheticPreparedVideo`, and `EvalLoader`, the frame-by-frame
    iterator with the key-frame schedule.

The loaders take `open_video` and `read_image` as parameters: a machine
without FFmpeg cannot load the decoder, and one without PIL cannot read
JPEGs. Where JAX silently reads a video record's JPEG because the decoder
does not load (training only the key path), the port raises.

A batch is a dict of host arrays: data, data_ref, data_ref_old (B, H, W, 3)
raw BGR frames padded to the bucket; motion_vector (B, fh, fw, 2) and
res_diff (B, fh, fw, 3) float32 grids at stride 16; eq_flag, eq_flag_old
(B,); im_info (B, 3) [h, w, scale] of the real image; gt_boxes
(B, max_gt, 5) [x1, y1, x2, y2, cls] zero-padded with gt_valid (B, max_gt).
"""

from __future__ import annotations

import os
import queue
import threading
import zlib

import numpy as np
import torch

from lsfa_tpu_torch.data import coviar
from lsfa_tpu_torch.data.image import (
    bgr_to_i420, pad_to_bucket, pick_bucket, resize, small_pool_factor, transform_mv_res)

GOP_SIZE = 12


def read_jpeg_bgr(path: str) -> np.ndarray:
    """A still image as HxWx3 float32 BGR (PIL is imported here, so that a
    machine without it can import this module and pass its own reader)."""
    from PIL import Image

    with Image.open(path) as im:
        rgb = np.asarray(im.convert("RGB"), np.uint8)
    return rgb[:, :, ::-1].astype(np.float32)


def open_native_video(path: str):
    """The native decoder's reader of `path` (one cached handle per path).
    Raises where the library does not load, naming the `open_video`
    parameter that takes a reader in its place, and where the file does
    not exist."""
    if not coviar.available():
        raise RuntimeError(f"{coviar.MISSING}; pass open_video (a callable that opens a "
                           f"reader, e.g. SyntheticVideoReader) to read {path}")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no compressed stream at {path}")
    return coviar._reader(path)


class SyntheticVideoReader:
    """A seeded stand-in for the native decoder's reader of one stream,
    for machines where it does not load: `get_num_frames()` and
    `load(gop, pos, representation)` at the record's height and width.
    Frame (gop, pos) is drawn from (seed, gop, pos), so it is the same in
    whatever order it is asked for; seed defaults to a checksum of the
    path. Frames are uniform BGR uint8; MVs are constant over 16x16
    macroblocks, a few pixels long; residuals small ints; a GOP's key
    frame (pos 0) has zero MV and residual, as a decoded I-frame."""

    def __init__(self, path: str, height: int, width: int, num_frames: int = 1 << 30,
                 seed: int | None = None):
        self.path = path
        self.height, self.width = int(height), int(width)
        self.num_frames = num_frames
        self.seed = zlib.crc32(str(path).encode()) if seed is None else seed

    def get_num_frames(self) -> int:
        return self.num_frames

    def load(self, gop_idx: int, pos_in_gop: int, representation: int) -> np.ndarray:
        fid = gop_idx * GOP_SIZE + pos_in_gop
        if not 0 <= pos_in_gop < GOP_SIZE or not 0 <= fid < self.num_frames:
            raise IndexError(f"frame ({gop_idx}, {pos_in_gop}) of a "
                             f"{self.num_frames}-frame stream")
        rng = np.random.default_rng([self.seed, gop_idx, pos_in_gop, representation])
        h, w = self.height, self.width
        if representation == 0:
            return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        if representation not in (1, 2):
            raise ValueError(f"bad representation {representation}")
        chans = 2 if representation == 1 else 3
        if pos_in_gop == 0:
            return np.zeros((h, w, chans), np.int32)
        if representation == 2:
            return rng.integers(-24, 25, (h, w, 3), dtype=np.int32)
        blocks = rng.integers(-6, 7, (-(-h // 16), -(-w // 16), 2), dtype=np.int32)
        return np.repeat(np.repeat(blocks, 16, axis=0), 16, axis=1)[:h, :w]


def load_pair_sample(rec, cfg, rng: np.random.Generator, bucket_hw=None, open_video=None,
                     read_image=None):
    """One training sample of the get_pair_image contract
    (lib/utils/image.py:92-200): the current frame, its GOP's key frame
    (ref), the previous GOP's key frame (old ref), the accumulated MV and
    residual; eq_flag 1 when the pair degenerates to the key path (a key
    frame, or a drawn reference offset of 0), eq_flag_old 1 in the first
    GOP. Returns a dict of host arrays: data, data_ref, data_ref_old
    (1, H, W, 3), eq_flag, eq_flag_old, motion_vector (1, fh, fw, 2),
    res_diff (1, fh, fw, 3), im_info (3,), gt_boxes (G, 5) scaled.

    A video record ("pattern" in rec) is read through
    open_video(video_path) (`open_native_video` when None); other records
    and a frame past the stream's end through read_image(path)
    (`read_jpeg_bgr` when None). When the reader has
    `decode_train_sample` (the native decoder) and bucket_hw is given, the
    whole sample comes from that one call at the bucket (the fast path);
    else the host chain of ``data/image.py`` runs. The two paths draw
    from `rng` in JAX's orders, which differ: the fast path the scale,
    then the reference offset; the host chain the offset, then the scale."""
    read_image = read_image or read_jpeg_bgr
    means = cfg.network.PIXEL_MEANS
    scale = cfg.network.PIXEL_SCALE
    stride = cfg.network.RCNN_FEAT_STRIDE
    legacy_swap = bool(getattr(cfg.network, "res_diff_legacy_swap", False))
    eq_flag, eq_flag_old = 0.0, 0.0
    im_h, im_w = int(rec["height"]), int(rec["width"])
    mv = np.zeros((im_h, im_w, 2), np.float32)
    res = np.zeros((im_h, im_w, 3), np.float32)
    reader = None
    if "pattern" in rec:
        video = rec.get("video_path")
        if not video:                          # the reference asserts (lib/utils/image.py:130)
            raise FileNotFoundError(f"video record {rec.get('image', '?')} has no readable "
                                    f"compressed stream (video_path={video!r})")
        reader = (open_video or open_native_video)(video)

    if (reader is not None and bucket_hw is not None and hasattr(reader, "decode_train_sample")
            and rec["frame_seg_id"] < reader.get_num_frames()):
        cur_id = rec["frame_seg_id"]
        target, max_size = cfg.SCALES[int(rng.integers(len(cfg.SCALES)))]
        data, ref, old, mv_t, res_t, info, pos = reader.decode_train_sample(
            cur_id, bucket_hw, target, max_size, means, scale, stride=stride,
            legacy_swap=legacy_swap, flip=bool(rec.get("flipped")))
        ref_id = int(np.clip(cur_id + rng.integers(cfg.TRAIN.MIN_OFFSET, cfg.TRAIN.MAX_OFFSET + 1),
                             0, rec["frame_seg_len"] - 1))
        if pos == 0 or ref_id == cur_id:       # degenerate pair: the key path
            eq_flag = 1.0
            ref = old = data
            mv_t = np.zeros_like(mv_t)
            res_t = zero_residual_grid(res_t.shape, info, means, scale, stride,
                                       legacy_swap=legacy_swap)
        elif cur_id - pos == 0:                # first GOP: old ref == ref
            eq_flag_old = 1.0
        if eq_flag == 0.0 and "oracle" in rec and getattr(cfg.network, "oracle_mv", False):
            # the generator's analytic flow replaces the decoded MV grid
            from lsfa_tpu_torch.data.oracle_flow import oracle_mv_grid
            mv_t = oracle_mv_grid(rec["oracle"], cur_id, cur_id - pos, mv_t.shape[0],
                                  mv_t.shape[1], float(info[2]), stride, (im_h, im_w),
                                  flip=bool(rec.get("flipped")))
        im_scale = float(info[2])
        boxes = rec["boxes"] * im_scale        # stored flipped already (append_flipped)
        gt = np.concatenate([boxes, rec["gt_classes"][:, None].astype(np.float32)], axis=1)
        return {"data": data[None], "data_ref": ref[None], "data_ref_old": old[None],
                "eq_flag": eq_flag, "eq_flag_old": eq_flag_old,
                "motion_vector": mv_t[None], "res_diff": res_t[None],
                "im_info": np.asarray([info[0], info[1], im_scale], np.float32),
                "gt_boxes": gt}

    if reader is not None:
        cur_id = rec["frame_seg_id"]
        gop_id, pos_id = cur_id // GOP_SIZE, cur_id % GOP_SIZE
        # random reference offset in [MIN_OFFSET, MAX_OFFSET] (image.py:124)
        ref_id = int(np.clip(cur_id + rng.integers(cfg.TRAIN.MIN_OFFSET, cfg.TRAIN.MAX_OFFSET + 1),
                             0, rec["frame_seg_len"] - 1))
        if cur_id >= reader.get_num_frames():  # stream shorter than the annotation
            im = read_image(rec["image"])
            ref = old_ref = im.copy()
            eq_flag = 1.0
        else:
            im = reader.load(gop_id, pos_id, 0).astype(np.float32)
            if pos_id == 0 or ref_id == cur_id:
                ref = old_ref = im.copy()
                eq_flag = 1.0
            else:
                old_gop = max(gop_id - 1, 0)
                eq_flag_old = 1.0 if old_gop == gop_id else 0.0
                ref = reader.load(gop_id, 0, 0).astype(np.float32)
                old_ref = reader.load(old_gop, 0, 0).astype(np.float32)
                mv = -reader.load(gop_id, pos_id, 1).astype(np.float32)
                res = reader.load(gop_id, pos_id, 2).astype(np.float32)
    else:
        im = read_image(rec["image"])
        ref = old_ref = im.copy()
        eq_flag = 1.0

    if rec.get("flipped"):
        im, ref, old_ref, res = im[:, ::-1], ref[:, ::-1], old_ref[:, ::-1], res[:, ::-1]
        mv = mv[:, ::-1].copy()
        mv[:, :, 0] = -mv[:, :, 0]

    # multi-scale: one entry of SCALES per image (lib/utils/image.py:183);
    # raw resized BGR, normalized on the device
    target, max_size = cfg.SCALES[int(rng.integers(len(cfg.SCALES)))]
    im_r, im_scale = resize(im, target, max_size)
    ref_r, _ = resize(ref, target, max_size)
    old_r, _ = resize(old_ref, target, max_size)
    mv_t, res_t = transform_mv_res(mv, res, im_scale, means, scale, stride,
                                   legacy_swap=legacy_swap)
    boxes = rec["boxes"] * im_scale
    gt = np.concatenate([boxes, rec["gt_classes"][:, None].astype(np.float32)], axis=1)
    return {"data": im_r[None], "data_ref": ref_r[None], "data_ref_old": old_r[None],
            "eq_flag": eq_flag, "eq_flag_old": eq_flag_old,
            "motion_vector": mv_t, "res_diff": res_t,
            "im_info": np.asarray([im_r.shape[0], im_r.shape[1], im_scale], np.float32),
            "gt_boxes": gt}


def zero_residual_grid(shape, info, pixel_means, pixel_scale, stride: int = 16,
                       legacy_swap: bool = False):
    """The residual grid a zero raw residual gives: the channel transform
    runs after padding, so valid cells carry (0 - mean) * scale constants,
    not zeros (what the reference feeds at I-frames and degenerate pairs).
    Bucket-pad cells stay zero."""
    fh, fw, _ = shape
    sh, sw = float(info[0]), float(info[1])
    gh = int(np.ceil(sh / stride))
    gw = int(np.ceil(sw / stride))
    mB, mG, mR = [float(m) for m in pixel_means]
    o0 = (0.0 - mR) * pixel_scale
    o1 = (0.0 - mG) * pixel_scale
    o2 = (o0 - mB) * pixel_scale if legacy_swap else (0.0 - mB) * pixel_scale
    out = np.zeros((fh, fw, 3), np.float32)
    out[:gh, :gw] = (o0, o1, o2)
    return out


def collate_train_batch(samples, bucket_hw, max_gt: int = 100,
                        mv_res_dtype=np.float32):
    """Stack samples (dicts as ``lsfa_tpu.data.loader.load_pair_sample``
    returns them) into one fixed-shape batch."""
    bh, bw = bucket_hw
    fb = (bh // 16, bw // 16)
    b = len(samples)

    def stack(key, hw):
        return np.concatenate([pad_to_bucket(s[key], hw) for s in samples])

    out = {
        "data": stack("data", bucket_hw),
        "data_ref": stack("data_ref", bucket_hw),
        "data_ref_old": stack("data_ref_old", bucket_hw),
        "motion_vector": stack("motion_vector", fb).astype(mv_res_dtype),
        "res_diff": stack("res_diff", fb).astype(mv_res_dtype),
        "eq_flag": np.asarray([s["eq_flag"] for s in samples], np.float32),
        "eq_flag_old": np.asarray([s["eq_flag_old"] for s in samples], np.float32),
        "im_info": np.stack([s["im_info"] for s in samples]),
    }
    gt = np.zeros((b, max_gt, 5), np.float32)
    gtv = np.zeros((b, max_gt), bool)
    for i, s in enumerate(samples):
        g = min(len(s["gt_boxes"]), max_gt)
        gt[i, :g] = s["gt_boxes"][:g]
        gtv[i, :g] = True
    out["gt_boxes"] = gt
    out["gt_valid"] = gtv
    return out


class TrainLoader:
    """Shuffling epoch iterator with worker threads (AnchorLoader and
    MultiThreadPrefetchingIter in the reference), over global batches of
    `batch_size` records.

    Records are grouped by the bucket their resized shape fits (portrait
    or landscape), and every batch is drawn from one group;
    TRAIN.ASPECT_GROUPING interleaves the groups' batches (the reference's
    order) or leaves them group after group. Every rank draws the same
    epoch plan from `seed`, so `len()` is the same on every rank; rank r of
    `world_size` loads and collates only its contiguous slice of each
    global batch, rows [r * b, (r + 1) * b) with b = batch_size //
    world_size. Each worker draws from its own generator, seeded before
    the threads start (rank 0's seeds are the JAX package's), and workers
    take batches in plan order; batches are yielded in plan order too
    (JAX yields them as they finish, which differs only with more than one
    worker, where which worker draws for which batch is a race in both).
    A worker's exception is raised by the iterator, and the threads end
    when the iterator is exhausted, closed or dropped. open_video and
    read_image are passed to `load_pair_sample`."""

    def __init__(self, roidb, cfg, batch_size: int, bucket_hw=None, seed: int = 0,
                 prefetch: int = 2, num_workers: int = 2, open_video=None, read_image=None,
                 rank: int = 0, world_size: int = 1):
        if batch_size % world_size or not 0 <= rank < world_size:
            raise ValueError(f"a global batch of {batch_size} over {world_size} ranks "
                             f"(rank {rank})")
        self.roidb = roidb
        self.cfg = cfg
        self.batch_size = batch_size
        self.max_gt = cfg.tpu.max_gt_boxes
        self.rng = np.random.default_rng(seed)
        self.prefetch = prefetch
        self.num_workers = num_workers
        self.open_video = open_video
        self.read_image = read_image
        self.rank, self.world_size = rank, world_size
        self.buckets = ([tuple(bucket_hw)] if bucket_hw is not None
                        else [tuple(b) for b in cfg.tpu.image_buckets])
        # the bucket under the largest scale: any sampled SCALES entry fits
        tgt = max(s[0] for s in cfg.SCALES)
        mx = max(s[1] for s in cfg.SCALES)
        self._rec_bucket = np.asarray([
            self.buckets.index(pick_bucket(int(r["height"]), int(r["width"]), self.buckets,
                                           tgt, mx))
            for r in roidb])

    def __len__(self):
        return sum(int(np.sum(self._rec_bucket == bi)) // self.batch_size
                   for bi in range(len(self.buckets)))

    def _epoch_batches(self):
        """(bucket index, record indices) of each global batch."""
        batches = []
        for bi in range(len(self.buckets)):
            idxs = np.nonzero(self._rec_bucket == bi)[0]
            if self.cfg.TRAIN.SHUFFLE:
                self.rng.shuffle(idxs)
            for i in range(len(idxs) // self.batch_size):
                batches.append((bi, idxs[i * self.batch_size:(i + 1) * self.batch_size]))
        if self.cfg.TRAIN.SHUFFLE and self.cfg.TRAIN.ASPECT_GROUPING:
            self.rng.shuffle(batches)
        return batches

    def __iter__(self):
        batches = self._epoch_batches()
        seeds = [int(self.rng.integers(2**31)) for _ in range(self.num_workers)]
        local = self.batch_size // self.world_size
        lo = self.rank * local
        todo: queue.Queue = queue.Queue()
        for i, (bi, idxs) in enumerate(batches):
            todo.put((i, bi, idxs[lo:lo + local]))
        done: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def offer(item):
            while not stop.is_set():
                try:
                    done.put(item, timeout=0.05)
                    return
                except queue.Full:
                    continue

        def worker(wid):
            wrng = np.random.default_rng(seeds[wid] + (self.rank << 31))
            try:
                while not stop.is_set():
                    try:
                        i, bi, idxs = todo.get_nowait()
                    except queue.Empty:
                        return
                    samples = [load_pair_sample(self.roidb[j], self.cfg, wrng,
                                                bucket_hw=self.buckets[bi],
                                                open_video=self.open_video,
                                                read_image=self.read_image)
                               for j in idxs]
                    offer((i, collate_train_batch(samples, self.buckets[bi], self.max_gt)))
            except Exception as e:          # raised again by the consumer
                offer((-1, e))

        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            ready = {}
            for i in range(len(batches)):
                while i not in ready:
                    j, item = done.get()
                    if isinstance(item, Exception):
                        raise item
                    ready[j] = item
                yield ready.pop(i)
        finally:
            stop.set()
            for t in threads:
                t.join()


def synthetic_sample(rng: np.random.Generator, content_hw, num_classes: int,
                     n_gt: int, eq_flag: float, eq_flag_old: float):
    """One seeded stand-in for a loaded training pair at the real extent
    content_hw: uint8 BGR frames, MV (dx, dy) and residual grids over the
    content's cells, and n_gt boxes of classes 1..num_classes-1. A key
    pair (eq_flag 1) repeats the frame as both references with zero
    motion, as the loader does."""
    h, w = content_hw
    fh, fw = -(-h // 16), -(-w // 16)
    data = rng.integers(0, 256, (1, h, w, 3), dtype=np.uint8)
    if eq_flag:
        ref = old = data
        mv = np.zeros((1, fh, fw, 2), np.float32)
    else:
        ref = rng.integers(0, 256, (1, h, w, 3), dtype=np.uint8)
        old = ref if eq_flag_old else rng.integers(0, 256, (1, h, w, 3), dtype=np.uint8)
        mv = rng.normal(0, 1.5, (1, fh, fw, 2)).astype(np.float32)
    res = rng.normal(0, 10, (1, fh, fw, 3)).astype(np.float32)
    x1 = rng.uniform(0, w * 0.7, n_gt)
    y1 = rng.uniform(0, h * 0.7, n_gt)
    x2 = np.minimum(x1 + rng.uniform(w * 0.1, w * 0.5, n_gt), w - 1)
    y2 = np.minimum(y1 + rng.uniform(h * 0.1, h * 0.5, n_gt), h - 1)
    cls = rng.integers(1, num_classes, n_gt).astype(np.float32)
    return {"data": data, "data_ref": ref, "data_ref_old": old,
            "eq_flag": float(eq_flag), "eq_flag_old": float(eq_flag_old),
            "motion_vector": mv, "res_diff": res,
            "im_info": np.asarray([h, w, 1.0], np.float32),
            "gt_boxes": np.stack([x1, y1, x2, y2, cls], axis=1).astype(np.float32)}


def synthetic_train_batches(n: int, bucket_hw, seed: int = 0, batch_images: int = 1,
                            num_classes: int = 31, max_gt: int = 100, content_hw=None,
                            max_boxes: int = 10):
    """n seeded collated batches at the bucket: frames fill content_hw
    (default: the bucket less 8 rows and 24 columns), every fourth image
    starting with the first is a key pair (eq_flag 1), eq_flag_old is
    drawn, and each image holds 1..max_boxes gt boxes."""
    rng = np.random.default_rng(seed)
    bh, bw = bucket_hw
    content_hw = content_hw or (bh - 8, bw - 24)
    batches, i = [], 0
    for _ in range(n):
        samples = []
        for _ in range(batch_images):
            samples.append(synthetic_sample(
                rng, content_hw, num_classes, int(rng.integers(1, max_boxes + 1)),
                eq_flag=float(i % 4 == 0), eq_flag_old=float(rng.uniform() < 0.3)))
            i += 1
        batches.append(collate_train_batch(samples, bucket_hw, max_gt))
    return batches


def to_device(x, device, dtype=None):
    """Host array or tensor -> tensor on `device` (cast to `dtype` when
    given). A tensor already there is returned as it is; host data goes to
    a card through pinned memory, so the copy does not block the host."""
    t = torch.as_tensor(x)
    if dtype is not None:
        t = t.to(dtype)
    device = torch.device(device)
    if t.device == device:
        return t
    if device.type == "cuda" and t.device.type == "cpu":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def batch_to_device(batch: dict, device) -> dict:
    """Host batch -> tensors on `device` (`to_device` on each entry)."""
    return {k: to_device(v, device) for k, v in batch.items()}


class _GopPayloads:
    """What `PreparedVideo` and its synthetic stand-in share: the frames
    mode and wire format resolved from the config, and frames served from
    a one-GOP cache of the subclass's `_load_gop`."""

    def __init__(self, cfg, bucket_hw, frames_mode, wire_fmt):
        self.cfg = cfg
        self.bucket_hw = tuple(bucket_hw)
        self.frames_mode = frames_mode
        self.wire_fmt = wire_fmt
        self._gop = -1
        self._cache = None

    def _mode(self) -> int:
        # key frames land on GOP starts when the key interval divides the
        # GOP size: then only the key frame needs a full-res resize, and
        # non-key frames ship small + MV + residual only
        if self.frames_mode is not None:
            return self.frames_mode
        return 1 if self.cfg.TEST.KEY_FRAME_INTERVAL % GOP_SIZE == 0 else 0

    @property
    def wire_format(self) -> str:
        """The resolved frame/small payload format this handle serves:
        i420 halves the shipped bytes but exists only for the key-only
        decode mode (full-frame consumers need BGR)."""
        if self._mode() != 1:
            return "bgr8"
        if self.wire_fmt is not None:
            return self.wire_fmt
        return getattr(self.cfg.tpu, "frame_payload", "bgr8")

    def gop(self, gop_idx: int):
        """(frames (N, bh, bw, 3) u8 BGR or (N, bh*3/2, bw, 1) I420, smalls
        likewise at 1/small_pool_factor, mv (N, fh, fw, 2) and res
        (N, fh, fw, 3) float32, im_info (3,) float32) of one GOP."""
        if gop_idx != self._gop:
            self._cache = self._load_gop(gop_idx)
            self._gop = gop_idx
        return self._cache

    def frame(self, fid: int):
        """(data (1, ...) u8, small (1, ...) u8, mv (1, fh, fw, 2) and res
        (1, fh, fw, 3) float32, im_info (1, 3) float32) of one frame, in
        the GOP's wire format."""
        frames, smalls, mv, res, info = self.gop(fid // GOP_SIZE)
        pos = fid % GOP_SIZE
        return (frames[pos:pos + 1], smalls[pos:pos + 1], mv[pos:pos + 1],
                res[pos:pos + 1], info[None])


class PreparedVideo(_GopPayloads):
    """Per-video handle over the native prepared-decode data plane: one
    call decodes a whole GOP straight to device-ready payloads (frames,
    smalls, MV and residual grids). Raises `coviar.MISSING` where the
    native library does not load: there is no synthetic fallback."""

    def __init__(self, video_path: str, cfg, bucket_hw,
                 frames_mode: int | None = None,
                 wire_fmt: str | None = None, oracle=None):
        """frames_mode: override the full-res policy — 0 ships every
        frame full-res (required by single-frame detectors like the R-FCN
        baseline), 1 key frames only; None picks by the key schedule.
        wire_fmt: override cfg.tpu.frame_payload (loaders that must keep
        one wire format across heterogeneous videos pass 'bgr8').
        oracle: analytic motion state (rec["oracle"]) — decoded MV grids
        are replaced by the generator's ground-truth flow
        (data/oracle_flow.py)."""
        super().__init__(cfg, bucket_hw, frames_mode, wire_fmt)
        self.reader = coviar.VideoReader(video_path)
        self.num_frames = self.reader.num_frames
        self.oracle = oracle

    def _load_gop(self, gop_idx: int):
        cfg = self.cfg
        target, max_size = cfg.SCALES[0]
        fmt = self.wire_format
        small_src = getattr(cfg.tpu, "small_src", "bgr")
        res_src = getattr(cfg.tpu, "res_src", "bgr")
        if fmt != "i420":
            small_src = "bgr"       # direct-YUV paths are i420-only
            res_src = "bgr"
        frames, smalls, mv, res, info = self.reader.decode_gop_prepared(
            gop_idx, self.bucket_hw, target, max_size,
            cfg.network.PIXEL_MEANS, cfg.network.PIXEL_SCALE,
            stride=cfg.network.RCNN_FEAT_STRIDE,
            small_factor=small_pool_factor(cfg.network.small_net_stride),
            legacy_swap=bool(getattr(cfg.network, "res_diff_legacy_swap", False)),
            frames_mode=self._mode(), payload_fmt=fmt, small_src=small_src,
            res_src=res_src)
        if self.oracle is not None:
            from lsfa_tpu_torch.data.oracle_flow import substitute_gop_mv
            mv = substitute_gop_mv(
                mv, self.oracle, gop_idx * GOP_SIZE, float(info[2]),
                cfg.network.RCNN_FEAT_STRIDE, (self.reader.height, self.reader.width))
        return frames, smalls, mv, res, info


def prepared_available() -> bool:
    """Whether the native library loaded and carries the prepared-decode
    entry points."""
    lib = coviar._lib() if coviar.available() else None
    return (lib is not None
            and hasattr(lib, "coviar_decode_gop_prepared_mode")
            and hasattr(lib, "coviar_decode_train_sample"))


class SyntheticPreparedVideo(_GopPayloads):
    """A seeded stand-in for a decoded video with `PreparedVideo`'s
    surface (num_frames, wire_format, gop, frame), for machines where the
    native decoder does not load: give it to the evaluation loops as
    `open_video`, through ``functools.partial`` for the keyword arguments.

    GOP g is drawn from (seed, g), so it is the same in whatever order
    GOPs are asked for; seed defaults to a checksum of `video_path`.
    Frames fill `content_hw` (default: the bucket less 8 rows and 24
    columns) and are padded as the decoder pads (BGR zeros, or Y=16,
    U=V=128); in the key-only mode non-key frame slots stay zero. Smalls
    are drawn, not pooled from the frames; MV (dx, dy) fields span a few
    cells, and the key frame's MV and residual are zero. The stream has
    `num_frames` frames (default: no end), so the last GOP may be short."""

    def __init__(self, video_path: str, cfg, bucket_hw,
                 frames_mode: int | None = None,
                 wire_fmt: str | None = None, oracle=None, *,
                 num_frames: int = 1 << 30, seed: int | None = None,
                 content_hw=None, im_scale: float = 1.0):
        if oracle is not None:
            raise ValueError("a synthetic stream has no oracle motion state")
        super().__init__(cfg, bucket_hw, frames_mode, wire_fmt)
        self.num_frames = num_frames
        self.seed = zlib.crc32(str(video_path).encode()) if seed is None else seed
        bh, bw = self.bucket_hw
        self.content_hw = tuple(content_hw) if content_hw else (bh - 8, bw - 24)
        self.im_scale = im_scale

    def _images(self, rng, n, hw, content, filled):
        """n frames at hw in the wire format, the first `filled` drawn over
        `content`, the rest left as the decoder leaves unused slots."""
        (h, w), (ch, cw) = hw, content
        if self.wire_format == "i420":
            out = np.zeros((n, h * 3 // 2, w, 1), np.uint8)
            y = np.full((filled, h, w), 16, np.uint8)
            y[:, :ch, :cw] = rng.integers(16, 236, (filled, ch, cw), dtype=np.uint8)
            uv = np.full((2, filled, h // 2, w // 2), 128, np.uint8)
            uv[:, :, :ch // 2, :cw // 2] = rng.integers(
                64, 192, (2, filled, ch // 2, cw // 2), dtype=np.uint8)
            planes = [y, uv[0].reshape(filled, h // 4, w), uv[1].reshape(filled, h // 4, w)]
            out[:filled, :, :, 0] = np.concatenate(planes, axis=1)
            return out
        out = np.zeros((n, h, w, 3), np.uint8)
        out[:filled, :ch, :cw] = rng.integers(0, 256, (filled, ch, cw, 3), dtype=np.uint8)
        return out

    def _load_gop(self, gop_idx: int):
        n = min(GOP_SIZE, self.num_frames - gop_idx * GOP_SIZE)
        if gop_idx < 0 or n <= 0:
            raise IndexError(f"bad gop {gop_idx} of a {self.num_frames}-frame stream")
        rng = np.random.default_rng([self.seed, gop_idx])
        cfg = self.cfg
        bh, bw = self.bucket_hw
        ch, cw = self.content_hw
        stride = cfg.network.RCNN_FEAT_STRIDE
        sf = small_pool_factor(cfg.network.small_net_stride)
        frames = self._images(rng, n, (bh, bw), (ch, cw), 1 if self._mode() == 1 else n)
        smalls = self._images(rng, n, (bh // sf, bw // sf), (ch // sf, cw // sf), n)
        mv = rng.normal(0, 2.0, (n, bh // stride, bw // stride, 2)).astype(np.float32)
        res = rng.normal(0, 10, (n, bh // stride, bw // stride, 3)).astype(np.float32)
        mv[0] = 0.0
        res[0] = 0.0
        return frames, smalls, mv, res, np.asarray([ch, cw, self.im_scale], np.float32)


class EvalLoader:
    """Frame-by-frame video iterator with the key-frame schedule: yields
    the dicts ``StreamingDetector.process_frame`` and
    ``RFCNDetector.detect`` consume (video_index, frame_id, flag 0 stream
    start / 1 key / 2 non-key, data, small, im_info, motion_vector,
    res_diff). Frames come from the prepared data plane; a frame past the
    stream's end (the reference meets one at every video's last frame)
    from read_image(pattern % frame) through the host image chain, with
    zero MV and residual, in the stream's wire format. A record without a
    compressed stream (no video_path: a VID tree of JPEG frames) reads
    every frame so, in BGR. A record whose video_path does not open
    raises (open_video's error)."""

    def __init__(self, video_roidb, cfg, bucket_hw=None,
                 full_frames: bool = False, open_video=None, read_image=None):
        """full_frames: every frame ships full-res `data` (single-frame
        detectors); the default lets the data plane skip non-key resizes.
        open_video: a callable with `PreparedVideo`'s signature that opens
        each record's stream (default: `PreparedVideo`). read_image: reads
        a frame past the stream's end (default: `read_jpeg_bgr`)."""
        self.roidb = video_roidb          # one rec per video (seg_len frames)
        self.cfg = cfg
        self.bucket_hw = tuple(bucket_hw or cfg.tpu.default_bucket)
        self.key_interval = cfg.TEST.KEY_FRAME_INTERVAL
        self.full_frames = full_frames
        self.open_video = open_video or PreparedVideo
        self.read_image = read_image or read_jpeg_bgr

    def _host_frame(self, path, wire_format):
        """(data, small, im_info, mv, res) of one image through the host
        chain, as the prepared plane would ship it with zero MV and
        residual."""
        cfg = self.cfg
        target, max_size = cfg.SCALES[0]
        bh, bw = self.bucket_hw
        im = self.read_image(path)
        im_r, im_scale = resize(im, target, max_size)
        # raw BGR uint8 padded to the bucket (normalized on the device)
        data = pad_to_bucket(np.clip(np.round(im_r), 0, 255).astype(np.uint8)[None],
                             self.bucket_hw)
        # the small net's input: the padded frame's block mean
        f = small_pool_factor(cfg.network.small_net_stride)
        small = np.clip(np.round(data.astype(np.float32).reshape(
            1, bh // f, f, bw // f, f, 3).mean((2, 4))), 0, 255).astype(np.uint8)
        if wire_format == "i420":           # one wire format per video
            data, small = bgr_to_i420(data), bgr_to_i420(small)
        h, w = im.shape[:2]
        mv_t, res_t = transform_mv_res(
            np.zeros((h, w, 2), np.float32), np.zeros((h, w, 3), np.float32), im_scale,
            cfg.network.PIXEL_MEANS, cfg.network.PIXEL_SCALE,
            legacy_swap=bool(getattr(cfg.network, "res_diff_legacy_swap", False)))
        fb = (bh // 16, bw // 16)
        info = np.asarray([[im_r.shape[0], im_r.shape[1], im_scale]], np.float32)
        return data, small, info, pad_to_bucket(mv_t, fb), pad_to_bucket(res_t, fb)

    def __iter__(self):
        cfg = self.cfg
        for vid_idx, rec in enumerate(self.roidb):
            n = rec["frame_seg_len"]
            # a partial-GOP tail record of the GOP loops: the frames before
            # _tail_start were served by whole GOPs
            start = int(rec.get("_tail_start", 0))
            video = rec.get("video_path")
            prep = None if video is None else self.open_video(
                video, cfg, self.bucket_hw,
                frames_mode=0 if self.full_frames else None,
                oracle=rec.get("oracle") if getattr(cfg.network, "oracle_mv", False) else None)
            for fid in range(start, n):
                if fid == 0:
                    flag = 0
                elif fid % self.key_interval == 0:
                    flag = 1
                else:
                    flag = 2
                if prep is not None and fid < prep.num_frames:
                    data, small, mv, res, info = prep.frame(fid)
                else:
                    data, small, info, mv, res = self._host_frame(
                        rec["pattern"] % fid, "bgr8" if prep is None else prep.wire_format)
                yield {"video_index": vid_idx, "frame_id": fid, "flag": flag,
                       "data": data, "small": small, "im_info": info,
                       "motion_vector": mv, "res_diff": res}
