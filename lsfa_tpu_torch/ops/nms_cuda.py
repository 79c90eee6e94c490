"""Binding of the CUDA NMS fixpoint kernel (``csrc/nms_sweep.cu``).

The kernel replaces ``lsfa_tpu/ops/pallas_nms.py::greedy_alive_pallas``;
its plain PyTorch version is ``ops/nms.py::greedy_alive``. The source is
compiled by ``nvcc`` for sm_90a into a plain-C shared library under
``lsfa_tpu_torch/_build/`` on first use, keyed by a hash of the source and
flags, and loaded with ``ctypes``. A failed build raises; nothing falls
back to the plain version.

For N <= 2048 the wrapper makes one launch (a thread-block cluster per
item) and allocates only the outputs; for larger N it adds the
(B, ceil(N/64), N) 64-bit suppression scratch of the two-phase path. The
kernel decides IoU > t without dividing, from the constants of
`division_free_threshold`, which this module computes on the host.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

PKG = Path(__file__).resolve().parents[1]
SOURCE = PKG / "csrc" / "nms_sweep.cu"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]
FUSED_MAX_N = 2048      # one cluster launch, no scratch, up to this N
MAX_N = 8192            # two-phase scratch is batch * N * ceil(N/64) * 8 bytes
MAX_BATCH = 65535       # the two-phase build grid's y extent

# the least time of the fixpoint on an H100 SXM (NVIDIA data sheet):
# float32 outside the tensor cores, HBM3
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
FLOPS_PER_PAIR = 16     # two extents 8, intersection 3, union and clamp 3, divide 1, compare 1

# launches of the kernel since the last reset (one per wrapper call)
LAUNCHES = 0
_lib = None
BUILD_SECONDS = None    # wall time of the build (or load) in this process


@functools.lru_cache(maxsize=64)
def division_free_threshold(iou_thresh: float):
    """The constants of the kernel's division-free IoU test, as Python
    numbers: (t, t_up, mid, tie_up) with t = float32(iou_thresh),
    t_up = nextafter(t, inf) and mid = (t + t_up) / 2, exact in float64.
    For float32 inter and u > 0,

        fl(inter / u) > t  <=>  inter > mid * u  or  (inter == mid * u and tie_up)

    where mid * u is exact in float64 (25 + 24 significant bits) and
    tie_up says that round-half-to-even takes mid up to t_up (t_up's
    mantissa is even)."""
    t = np.float32(iou_thresh)
    t_up = np.nextafter(t, np.float32(np.inf))
    if not (np.isfinite(t) and np.isfinite(t_up)):
        raise ValueError(f"IoU threshold {iou_thresh!r} is not a finite float32 "
                         f"below the largest one")
    mid = (float(t) + float(t_up)) / 2.0
    tie_up = int(t_up.view(np.uint32)) % 2 == 0
    return float(t), float(t_up), mid, tie_up


def nms_flops(b: int, n: int) -> float:
    """The fixpoint's float32 operations on (b, n) boxes: one IoU test per
    pair of the strict upper triangle, FLOPS_PER_PAIR each."""
    return FLOPS_PER_PAIR * b * n * (n - 1) / 2


def nms_bytes(b: int, n: int) -> int:
    """The fixpoint's bytes: boxes (float32 x4) and valid read once, alive
    and converged written once."""
    return b * n * 16 + b * n + b * n + b


def nms_bound_ms(b: int, n: int):
    """The least time of the fixpoint on an H100: `nms_flops` at PEAK_F32
    against `nms_bytes` at PEAK_BYTES. Returns (ms, "operations" or
    "bytes")."""
    t_ops, t_bytes = nms_flops(b, n) / PEAK_F32, nms_bytes(b, n) / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib, BUILD_SECONDS
    if _lib is not None:
        return _lib
    t0 = time.perf_counter()
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib_path = BUILD_DIR / f"libnms_sweep_{digest[:16]}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE.name}:\n{proc.stderr}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.nms_sweep_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_float, ctypes.c_double, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.nms_sweep_cluster_size.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.nms_sweep_cluster_size.restype = ctypes.c_int
    _lib = lib
    BUILD_SECONDS = time.perf_counter() - t0
    return lib


def cluster_size(batch: int, n: int, device=None) -> int:
    """CTAs per item of the fused launch for (batch, n) on the card, 0 for
    the two-phase path (n > FUSED_MAX_N)."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    got = build().nms_sweep_cluster_size(batch, n, index)
    if got < 0:
        raise RuntimeError(f"nms_sweep_cluster_size failed with CUDA error {-got}")
    return got


def greedy_alive_cuda(boxes, valid, iou_thresh: float, num_sweeps: int):
    """The NMS fixpoint on the card. boxes (B, N, 4) float32 contiguous,
    rank-sorted; valid (B, N) bool contiguous, on the same CUDA device.
    Returns (alive (B, N) bool, converged (B,) bool), enqueued on the
    current stream without synchronizing."""
    global LAUNCHES
    if not boxes.is_cuda or valid.device != boxes.device:
        raise ValueError(f"boxes and valid must share one CUDA device, got "
                         f"{boxes.device} and {valid.device}")
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"need float32 boxes and bool valid, got {boxes.dtype}, {valid.dtype}")
    if boxes.ndim != 3 or boxes.shape[-1] != 4 or tuple(valid.shape) != tuple(boxes.shape[:2]):
        raise ValueError(f"need boxes (B, N, 4) and valid (B, N), got "
                         f"{tuple(boxes.shape)} and {tuple(valid.shape)}")
    if not (boxes.is_contiguous() and valid.is_contiguous()) or boxes.data_ptr() % 16:
        raise ValueError("boxes and valid must be contiguous, boxes 16-byte aligned")
    bsz, n = valid.shape
    if n > MAX_N or bsz > MAX_BATCH:
        raise ValueError(f"(B, N) = ({bsz}, {n}) exceeds ({MAX_BATCH}, {MAX_N})")
    dev = boxes.device
    if bsz == 0 or n == 0:
        return (torch.empty((bsz, n), dtype=torch.bool, device=dev),
                torch.ones((bsz,), dtype=torch.bool, device=dev))
    lib = _lib or build()
    # alive and converged: two views of one allocation
    out = torch.empty((bsz * n + bsz,), dtype=torch.bool, device=dev)
    scratch = None
    if n > FUSED_MAX_N:
        scratch = torch.empty((bsz, (n + 63) // 64, n), dtype=torch.int64, device=dev)
    t, t_up, mid, tie_up = division_free_threshold(iou_thresh)
    index = boxes.get_device()
    ptr = out.data_ptr()
    sup = 0 if scratch is None else scratch.data_ptr()
    err = lib.nms_sweep_launch(boxes.data_ptr(), valid.data_ptr(), bsz, n, t, t_up, mid,
                               tie_up, int(num_sweeps), sup, ptr, ptr + bsz * n, index,
                               torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"nms_sweep launch failed with CUDA error {err}")
    LAUNCHES += 1
    return out[:bsz * n].view(bsz, n), out[bsz * n:]
