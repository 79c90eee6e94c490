"""Batch assembly and the per-video data plane, the counterparts of
``lsfa_tpu.data.loader`` without PIL: train batch collation with seeded
synthetic train batches shaped like its output, `PreparedVideo` over the
native decoder, its seeded stand-in `SyntheticPreparedVideo` for machines
that cannot load the decoder, and `EvalLoader`, the frame-by-frame
iterator with the key-frame schedule.

A batch is a dict of host arrays: data, data_ref, data_ref_old (B, H, W, 3)
raw BGR frames padded to the bucket; motion_vector (B, fh, fw, 2) and
res_diff (B, fh, fw, 3) float32 grids at stride 16; eq_flag, eq_flag_old
(B,); im_info (B, 3) [h, w, scale] of the real image; gt_boxes
(B, max_gt, 5) [x1, y1, x2, y2, cls] zero-padded with gt_valid (B, max_gt).
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from lsfa_tpu_torch.data import coviar
from lsfa_tpu_torch.data.image import pad_to_bucket, small_pool_factor

GOP_SIZE = 12


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


HOST_CHAIN = ("the host image chain (JPEG frames, resize, MV and residual transform) is "
              "not ported yet: ROADMAP.md, Queue 1 item 5 (training data)")


class EvalLoader:
    """Frame-by-frame video iterator with the key-frame schedule: yields
    the dicts ``StreamingDetector.process_frame`` and
    ``RFCNDetector.detect`` consume (video_index, frame_id, flag 0 stream
    start / 1 key / 2 non-key, data, small, im_info, motion_vector,
    res_diff), served by the prepared data plane."""

    def __init__(self, video_roidb, cfg, bucket_hw=None,
                 full_frames: bool = False, open_video=None):
        """full_frames: every frame ships full-res `data` (single-frame
        detectors); the default lets the data plane skip non-key resizes.
        open_video: a callable with `PreparedVideo`'s signature that opens
        each record's stream (default: `PreparedVideo`)."""
        self.roidb = video_roidb          # one rec per video (seg_len frames)
        self.cfg = cfg
        self.bucket_hw = tuple(bucket_hw or cfg.tpu.default_bucket)
        self.key_interval = cfg.TEST.KEY_FRAME_INTERVAL
        self.full_frames = full_frames
        self.open_video = open_video or PreparedVideo

    def __iter__(self):
        cfg = self.cfg
        for vid_idx, rec in enumerate(self.roidb):
            n = rec["frame_seg_len"]
            # a partial-GOP tail record of the GOP loops: the frames before
            # _tail_start were served by whole GOPs
            start = int(rec.get("_tail_start", 0))
            video = rec.get("video_path")
            if video is None:
                raise NotImplementedError(
                    f"record {rec.get('vid_path', vid_idx)!r} has no compressed stream "
                    f"(video_path): {HOST_CHAIN}")
            prep = self.open_video(
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
                if fid >= prep.num_frames:
                    raise NotImplementedError(
                        f"frame {fid} of {video} lies past the stream's end "
                        f"({prep.num_frames} frames): {HOST_CHAIN}")
                data, small, mv, res, info = prep.frame(fid)
                yield {"video_index": vid_idx, "frame_id": fid, "flag": flag,
                       "data": data, "small": small, "im_info": info,
                       "motion_vector": mv, "res_diff": res}

