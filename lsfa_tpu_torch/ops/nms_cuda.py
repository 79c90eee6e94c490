"""Binding of the CUDA NMS fixpoint kernel (``csrc/nms_sweep.cu``).

The kernel replaces ``lsfa_tpu/ops/pallas_nms.py::greedy_alive_pallas``;
its plain PyTorch version is ``ops/nms.py::greedy_alive``. The source is
compiled by ``nvcc`` for sm_90a into a plain-C shared library under
``lsfa_tpu_torch/_build/`` on first use, keyed by a hash of the source and
flags, and loaded with ``ctypes``. A failed build raises; nothing falls
back to the plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parents[1]
SOURCE = PKG / "csrc" / "nms_sweep.cu"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]
MAX_N = 8192            # sup scratch is batch * N * ceil(N/64) * 8 bytes
MAX_BATCH = 65535       # the build grid's z extent

# launches of the kernel since the last reset (one per wrapper call)
LAUNCHES = 0
_lib = None
BUILD_SECONDS = None    # wall time of the build (or load) in this process


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
                   ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _lib = lib
    BUILD_SECONDS = time.perf_counter() - t0
    return lib


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
    alive = torch.empty((bsz, n), dtype=torch.bool, device=dev)
    if bsz == 0 or n == 0:
        return alive, torch.ones((bsz,), dtype=torch.bool, device=dev)
    converged = torch.empty((bsz,), dtype=torch.bool, device=dev)
    lib = build()
    words = (n + 63) // 64
    sup = torch.empty((bsz, words, n), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.nms_sweep_launch(boxes.data_ptr(), valid.data_ptr(), bsz, n,
                               float(iou_thresh), int(num_sweeps), sup.data_ptr(),
                               alive.data_ptr(), converged.data_ptr(),
                               dev.index if dev.index is not None else torch.cuda.current_device(),
                               stream)
    if err != 0:
        raise RuntimeError(f"nms_sweep launch failed with CUDA error {err}")
    LAUNCHES += 1
    return alive, converged
