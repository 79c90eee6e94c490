"""Build and load of the port's CUDA C++ kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` into a plain-C shared library under
``lsfa_tpu_torch/_build/`` on first use, keyed by a hash of the source and
flags, and loaded with ``ctypes``. A failed build raises; nothing falls
back to a plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build_library(source: Path, flags: list[str], stem: str) -> ctypes.CDLL:
    """Compile `source` with `flags` into ``_build/lib<stem>_<hash>.so``
    (once per hash of source and flags) and load it."""
    digest = hashlib.sha256(source.read_bytes() + " ".join(flags).encode()).hexdigest()
    lib_path = BUILD_DIR / f"lib{stem}_{digest[:16]}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        proc = subprocess.run([nvcc(), *flags, "-o", str(tmp), str(source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source.name}:\n{proc.stderr}")
        os.replace(tmp, lib_path)
    return ctypes.CDLL(str(lib_path))
