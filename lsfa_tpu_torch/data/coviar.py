"""Python binding for the native compressed-video loader, a copy of
``lsfa_tpu.data.coviar`` (ctypes and numpy only), which the port cannot
import. It binds the same ``native/coviar/libcoviar_tpu.so``.

Drop-in API parity with the reference's coviar_py2 module
(external/data_loader_py2/coviar_data_loader.c:500-582):
    load(path, gop_idx, pos_in_gop, representation, accumulate)
        representation 0 = BGR image (float-convertible uint8 HxWx3)
                       1 = accumulated motion vectors (int32 HxWx2, (dx,dy))
                       2 = residual vs MV-warped GOP key (int32 HxWx3)
    get_num_frames(path), get_num_gops(path)

plus what the reference lacks:
    VideoReader           — stateful handle with a GOP cache: one decode per
                            GOP serves all frames (reference re-decodes the
                            file prefix for EVERY sample, SURVEY.md §3.4)
    encode_test_video     — synthesize an MPEG-4 clip (test fixture maker)

The native library is optional at import time: `available()` reports
whether it loaded. It links FFmpeg 5 (libavformat.so.59, libavcodec.so.59,
libavutil.so.57, libswscale.so.6); on a machine without them it does not
load, and whatever opens or encodes a video raises `MISSING`.
"""

from __future__ import annotations

import ctypes
import functools
import os
import threading

import numpy as np

_LIB_PATHS = [
    os.path.join(os.path.dirname(__file__), "..", "..", "native", "coviar",
                 "libcoviar_tpu.so"),
    "libcoviar_tpu.so",
]


MISSING = ("libcoviar_tpu.so could not be loaded (looked for native/coviar/"
           "libcoviar_tpu.so beside the package, then on the loader's path): it needs "
           "FFmpeg 5's libavformat.so.59, libavcodec.so.59, libavutil.so.57 and "
           "libswscale.so.6")


@functools.lru_cache(maxsize=1)
def _lib():
    for p in _LIB_PATHS:
        try:
            lib = ctypes.CDLL(os.path.abspath(p))
            break
        except OSError:
            lib = None
    if lib is None:
        return None
    lib.coviar_open.restype = ctypes.c_void_p
    lib.coviar_open.argtypes = [ctypes.c_char_p]
    lib.coviar_close.argtypes = [ctypes.c_void_p]
    for f in ("coviar_num_frames", "coviar_num_gops", "coviar_width",
              "coviar_height"):
        getattr(lib, f).restype = ctypes.c_int
        getattr(lib, f).argtypes = [ctypes.c_void_p]
    lib.coviar_gop_frames.restype = ctypes.c_int
    lib.coviar_gop_frames.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.coviar_decode_gop.restype = ctypes.c_int
    lib.coviar_decode_gop.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
    lib.coviar_encode_test_video.restype = ctypes.c_int
    lib.coviar_encode_test_video.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int]
    if hasattr(lib, "coviar_encode_frames"):
        lib.coviar_encode_frames.restype = ctypes.c_int
        lib.coviar_encode_frames.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    if hasattr(lib, "coviar_encode_frames_br"):
        lib.coviar_encode_frames_br.restype = ctypes.c_int
        lib.coviar_encode_frames_br.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int64]
    if hasattr(lib, "coviar_decode_gop_prepared_mode"):
        lib.coviar_decode_gop_prepared_mode.restype = ctypes.c_int
        lib.coviar_decode_gop_prepared_mode.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_float, ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int]
    if hasattr(lib, "coviar_decode_gop_prepared_fmt"):
        lib.coviar_decode_gop_prepared_fmt.restype = ctypes.c_int
        lib.coviar_decode_gop_prepared_fmt.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_float, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int]
    if hasattr(lib, "coviar_decode_train_sample"):
        lib.coviar_decode_train_sample.restype = ctypes.c_int
        lib.coviar_decode_train_sample.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_float, ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float)]
    if hasattr(lib, "coviar_last_error"):
        lib.coviar_last_error.restype = ctypes.c_char_p
        lib.coviar_last_error.argtypes = [ctypes.c_void_p]
    if hasattr(lib, "coviar_prof_read"):
        lib.coviar_prof_read.restype = None
        lib.coviar_prof_read.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_double), ctypes.c_int]
    if hasattr(lib, "coviar_encode_test_video_b"):
        lib.coviar_encode_test_video_b.restype = ctypes.c_int
        lib.coviar_encode_test_video_b.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int]
    return lib


def available() -> bool:
    return _lib() is not None


class VideoReader:
    """Stateful reader with a one-GOP decode cache."""

    def __init__(self, path: str):
        lib = _lib()
        if lib is None:
            raise RuntimeError(MISSING)
        self._lib = lib
        self._h = lib.coviar_open(path.encode())
        if not self._h:
            raise IOError(f"cannot open video: {path}")
        self.path = path
        self.num_frames = lib.coviar_num_frames(self._h)
        self.num_gops = lib.coviar_num_gops(self._h)
        self.width = lib.coviar_width(self._h)
        self.height = lib.coviar_height(self._h)
        self._cache_gop = -1
        self._cache = None
        # the FFmpeg handle is stateful (seek/flush/decode); serialize all
        # decode access per reader — loader worker threads share readers
        # through the module-level cache
        self._lock = threading.Lock()

    def close(self):
        if getattr(self, "_h", None):
            self._lib.coviar_close(self._h)
            self._h = None

    def __del__(self):
        self.close()

    def gop_frames(self, gop_idx: int) -> int:
        return self._lib.coviar_gop_frames(self._h, gop_idx)

    def _err(self) -> str:
        """Native-side diagnostic for the last failed call (': msg' suffix
        for IOError text; '' if the .so predates coviar_last_error)."""
        if not hasattr(self._lib, "coviar_last_error") or not self._h:
            return ""
        msg = self._lib.coviar_last_error(self._h)
        msg = msg.decode(errors="replace") if msg else ""
        return f": {msg}" if msg else ""

    #: stage labels for prof_read (see Handle::prof in coviar.cpp)
    PROF_STAGES = ("demux+avcodec", "frame_to_bgr", "mv_accumulate",
                   "full_payload", "small_payload", "mv_res_grids")

    def prof_read(self, reset: bool = True) -> dict:
        """Cumulative per-stage decode seconds since open (or last reset),
        keyed by PROF_STAGES. Returns {} if the .so predates the profiler."""
        if not hasattr(self._lib, "coviar_prof_read"):
            return {}
        buf = (ctypes.c_double * 6)()
        with self._lock:
            self._lib.coviar_prof_read(self._h, buf, 1 if reset else 0)
        return dict(zip(self.PROF_STAGES, list(buf)))

    def decode_gop(self, gop_idx: int):
        """Returns (bgr (N,H,W,3) uint8, mv (N,H,W,2) int32, res (N,H,W,3)
        int32) for the whole GOP; cached until another GOP is requested.
        Thread-safe (decoding on one handle is serialized)."""
        with self._lock:
            if gop_idx == self._cache_gop:
                return self._cache
            n = self.gop_frames(gop_idx)
            if n <= 0:
                raise IndexError(f"bad gop {gop_idx} for {self.path}")
            h, w = self.height, self.width
            bgr = np.empty((n, h, w, 3), np.uint8)
            mv = np.empty((n, h, w, 2), np.int32)
            res = np.empty((n, h, w, 3), np.int32)
            got = self._lib.coviar_decode_gop(
                self._h, gop_idx,
                bgr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                mv.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                res.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n)
            if got != n:
                raise IOError(f"decoded {got}/{n} frames of gop "
                              f"{gop_idx}{self._err()}")
            self._cache_gop = gop_idx
            self._cache = (bgr, mv, res)
            return self._cache


    def decode_gop_prepared(self, gop_idx: int, bucket_hw, target_size: int,
                            max_size: int, pixel_means_bgr,
                            pixel_scale: float = 1.0, stride: int = 16,
                            small_factor: int = 4,
                            legacy_swap: bool = False,
                            frames_mode: int = 0,
                            payload_fmt: str = "bgr8",
                            small_src: str = "bgr",
                            res_src: str = "bgr"):
        """Decode one GOP straight to DEVICE-READY payloads (the C++ data
        plane — ~30x faster than the numpy/PIL chain on one core):

        Returns (frames (N,bh,bw,3) u8 resized+padded raw BGR,
                 smalls (N,bh/sf,bw/sf,3) u8 box-mean of the padded frame,
                 mv (N,fh,fw,2) f32 warp-ready (negated, feature-cell units),
                 res (N,fh,fw,3) f32 transformed residual grid,
                 im_info (3,) f32 [scaled_h, scaled_w, im_scale]).

        payload_fmt "i420" ships frames as (N, bh*3/2, bw, 1) and smalls
        as (N, sbh*3/2, sbw, 1) planar YUV420 — HALF the host->device
        bytes; the model's preprocess converts YUV->normalized RGB on
        device (dispatch on the trailing dim). Requires frames_mode=1.

        Semantics match the reference cv2.INTER_LINEAR preprocessing
        (lib/utils/image.py:202-308); legacy_swap reproduces its in-place
        channel-transform bug (needed for exact parity with weights the
        reference trained — image.py:217-218)."""
        lib = self._lib
        if not hasattr(lib, "coviar_decode_gop_prepared_mode"):
            raise RuntimeError("libcoviar_tpu.so too old: rebuild native/")
        bh, bw = bucket_hw
        fh, fw = bh // stride, bw // stride
        sbh, sbw = bh // small_factor, bw // small_factor
        fmt = {"bgr8": 0, "i420": 1}[payload_fmt]
        if (small_src == "yuv" or res_src == "yuv") and payload_fmt != "i420":
            # the C plane refuses this combination too (rc -9), but a
            # ValueError here beats an opaque IOError from deep in ctypes
            raise ValueError("small_src/res_src 'yuv' require "
                             f"payload_fmt='i420', got {payload_fmt!r}")
        if payload_fmt == "i420" and frames_mode != 1:
            raise ValueError("payload_fmt='i420' requires frames_mode=1 "
                             "(key-only full frames)")
        if small_src == "yuv":
            # bit 4: smalls scaled straight from the decoder's YUV planes
            # (skips the YUV->BGR->YUV round trip; i420-only, ~1 ms/f)
            fmt |= 16
        elif small_src != "bgr":
            raise ValueError(f"small_src must be 'bgr' or 'yuv': {small_src}")
        if res_src == "yuv":
            # bit 5: residual-grid taps convert per-pixel from the
            # decoder's YUV planes; with direct smalls too, non-key
            # frames skip the full-res YUV->BGR pass entirely
            fmt |= 32
        elif res_src != "bgr":
            raise ValueError(f"res_src must be 'bgr' or 'yuv': {res_src}")
        if fmt != 0 and not hasattr(lib, "coviar_decode_gop_prepared_fmt"):
            raise RuntimeError("libcoviar_tpu.so too old: rebuild native/")
        with self._lock:
            n = self.gop_frames(gop_idx)
            if n <= 0:
                raise IndexError(f"bad gop {gop_idx} for {self.path}")
            # mode 1: non-key slots stay zero (calloc pages — no fill cost)
            alloc = np.zeros if frames_mode == 1 else np.empty
            if fmt & 0xF == 1:
                frames = alloc((n, bh * 3 // 2, bw, 1), np.uint8)
                smalls = np.empty((n, sbh * 3 // 2, sbw, 1), np.uint8)
            else:
                frames = alloc((n, bh, bw, 3), np.uint8)
                smalls = np.empty((n, sbh, sbw, 3), np.uint8)
            mv = np.empty((n, fh, fw, 2), np.float32)
            res = np.empty((n, fh, fw, 3), np.float32)
            info = np.empty((3,), np.float32)
            means = np.ascontiguousarray(pixel_means_bgr, np.float32)
            args = [
                self._h, gop_idx, target_size, max_size, bh, bw, stride,
                small_factor, means.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_float)),
                ctypes.c_float(pixel_scale), int(legacy_swap),
                int(frames_mode)]
            tail = [
                frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                smalls.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                mv.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                res.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                info.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n]
            if fmt != 0:
                got = lib.coviar_decode_gop_prepared_fmt(
                    *args, fmt, *tail)
            else:
                got = lib.coviar_decode_gop_prepared_mode(*args, *tail)
            if got != n:
                raise IOError(f"prepared-decoded {got}/{n} of gop "
                              f"{gop_idx}{self._err()}")
            return frames, smalls, mv, res, info


    def decode_train_sample(self, cur_id: int, bucket_hw, target_size: int,
                            max_size: int, pixel_means_bgr,
                            pixel_scale: float = 1.0, stride: int = 16,
                            legacy_swap: bool = False, flip: bool = False):
        """One get_pair_image training sample (lib/utils/image.py:92-200)
        as device-ready payloads: (data, data_ref, data_ref_old —
        (bh,bw,3) u8 resized+padded, flip applied at the source), mv
        (fh,fw,2) f32, res (fh,fw,3) f32, im_info (3,) f32. ~12x faster
        than the per-frame Python chain."""
        lib = self._lib
        if not hasattr(lib, "coviar_decode_train_sample"):
            raise RuntimeError("libcoviar_tpu.so too old: rebuild native/")
        bh, bw = bucket_hw
        fh, fw = bh // stride, bw // stride
        with self._lock:
            data = np.empty((bh, bw, 3), np.uint8)
            ref = np.empty((bh, bw, 3), np.uint8)
            old = np.empty((bh, bw, 3), np.uint8)
            mv = np.empty((fh, fw, 2), np.float32)
            res = np.empty((fh, fw, 3), np.float32)
            info = np.empty((3,), np.float32)
            means = np.ascontiguousarray(pixel_means_bgr, np.float32)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            f32p = ctypes.POINTER(ctypes.c_float)
            rc = lib.coviar_decode_train_sample(
                self._h, cur_id, target_size, max_size, bh, bw, stride,
                means.ctypes.data_as(f32p), ctypes.c_float(pixel_scale),
                int(legacy_swap), int(flip),
                data.ctypes.data_as(u8p), ref.ctypes.data_as(u8p),
                old.ctypes.data_as(u8p),
                mv.ctypes.data_as(f32p), res.ctypes.data_as(f32p),
                info.ctypes.data_as(f32p))
            if rc < 0:
                raise IOError(f"train-sample decode failed rc={rc} "
                              f"(frame {cur_id}){self._err()}")
            return data, ref, old, mv, res, info, rc   # rc = pos in GOP


@functools.lru_cache(maxsize=8)
def _reader(path: str) -> VideoReader:
    return VideoReader(path)


def load(path: str, gop_idx: int, pos_in_gop: int, representation: int,
         accumulate: bool = True) -> np.ndarray:
    """Reference-parity one-shot loader (but GOP-cached underneath)."""
    assert accumulate, "only accumulated MV/residual are supported"
    r = _reader(path)
    bgr, mv, res = r.decode_gop(gop_idx)
    if representation == 0:
        return bgr[pos_in_gop].copy()
    if representation == 1:
        return mv[pos_in_gop].copy()
    if representation == 2:
        return res[pos_in_gop].copy()
    raise ValueError(f"bad representation {representation}")


def get_num_frames(path: str) -> int:
    return _reader(path).num_frames


def get_num_gops(path: str) -> int:
    return _reader(path).num_gops


def encode_test_video(path: str, n_frames: int = 36, w: int = 128,
                      h: int = 96, gop_size: int = 12, seed: int = 0,
                      b_frames: int = 0):
    """Synthesize an MPEG-4 test clip. b_frames > 0 produces a stream the
    loader must REFUSE (frame indexing assumes IPPP decode order)."""
    lib = _lib()
    if lib is None:
        raise RuntimeError(MISSING)
    if b_frames > 0:
        rc = lib.coviar_encode_test_video_b(path.encode(), n_frames, w, h,
                                            gop_size, seed, b_frames)
    else:
        rc = lib.coviar_encode_test_video(path.encode(), n_frames, w, h,
                                          gop_size, seed)
    if rc != 0:
        raise IOError(f"encode failed rc={rc}")


def encode_frames(path: str, frames, gop_size: int = 12,
                  bit_rate: int | None = None):
    """Encode (N, H, W, 3) uint8 BGR frames to an MPEG-4 stream with a
    fixed GOP — the synthetic-dataset generator's encoder (data/synth.py).
    H and W must be even (YUV420 chroma subsampling). `bit_rate`
    (bits/sec; encoder default 2 Mbps when None) controls compression —
    the hardened benchmark profile encodes at a low rate so the
    MV/residual streams carry real quantization noise."""
    lib = _lib()
    if lib is None:
        raise RuntimeError(MISSING)
    if not hasattr(lib, "coviar_encode_frames"):
        raise RuntimeError("libcoviar_tpu.so lacks coviar_encode_frames")
    frames = np.ascontiguousarray(frames, np.uint8)
    n, h, w, c = frames.shape
    assert c == 3 and h % 2 == 0 and w % 2 == 0, frames.shape
    buf = frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    if bit_rate is None:
        rc = lib.coviar_encode_frames(path.encode(), buf, n, w, h, gop_size)
    else:
        if not hasattr(lib, "coviar_encode_frames_br"):
            raise RuntimeError("libcoviar_tpu.so predates "
                               "coviar_encode_frames_br — rebuild native/")
        rc = lib.coviar_encode_frames_br(path.encode(), buf, n, w, h,
                                         gop_size, int(bit_rate))
    if rc != 0:
        raise IOError(f"encode failed rc={rc}")
