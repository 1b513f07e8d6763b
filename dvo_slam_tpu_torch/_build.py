"""Build the port's CUDA kernels with ``nvcc`` at first use and load them
with ``ctypes``.

Each ``csrc/*.cu`` file is compiled for Hopper (``sm_90a``) into a shared
library with a plain C interface, inside the package's ``build/``
directory (listed in ``.gitignore``).  The library name carries a hash of
the source and the flags, so an edited source is rebuilt and an unchanged
one is loaded as it is.  Nothing is built or imported at module import
time: the CPU tests import every module of the package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, NamedTuple

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")

# -fmad=false: no contraction of a*b + c into one rounding, so the
# kernel's float32 chain rounds as the plain PyTorch twin's does.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


class KernelLibrary(NamedTuple):
    lib: ctypes.CDLL
    path: str
    build_seconds: float  # 0.0 when an existing build was loaded
    compiler_log: str  # nvcc's output (ptxas registers / shared memory)


_lock = threading.Lock()
_loaded: Dict[str, KernelLibrary] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under PyTorch's CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        candidate = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(candidate):
            return candidate
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under CUDA_HOME): the CUDA "
        "kernels are built from source at first use and need the CUDA toolkit"
    )


def load_library(name: str) -> KernelLibrary:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    with _lock:
        if name in _loaded:
            return _loaded[name]
        source = os.path.join(CSRC_DIR, name + ".cu")
        with open(source, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
        path = os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")
        seconds, log = 0.0, ""
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, source]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) building {source}:\n{log}"
                )
            os.replace(tmp, path)
        loaded = KernelLibrary(ctypes.CDLL(path), path, seconds, log)
        _loaded[name] = loaded
        return loaded
