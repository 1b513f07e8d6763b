"""Build the port's CUDA kernels with ``nvcc`` at first use, load them
with ``ctypes``, and hand the wrappers PyTorch's current stream.

Each ``csrc/*.cu`` file is compiled for Hopper (``sm_90a``) into a shared
library with a plain C interface, inside the package's ``build/``
directory (listed in ``.gitignore``).  The library name carries a hash of
the source and the flags, so an edited source is rebuilt and an unchanged
one is loaded as it is.  ``load_libraries`` starts one ``nvcc`` per
source, all at once.  Nothing is built or imported at module import
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

import torch

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
    compiler_log: str  # nvcc's output (ptxas registers / shared memory), kept beside the library


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


def _library_path(name: str):
    """(source, library path, extra flags) of ``csrc/<name>.cu``, or of its
    variant ``<name>+MACRO`` built with ``-DMACRO`` (a diagnostic build,
    e.g. ``fused_stats+DVO_STAMPS``)."""
    stem, *macros = name.split("+")
    flags = tuple("-D" + macro for macro in macros)
    source = os.path.join(CSRC_DIR, stem + ".cu")
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS + flags).encode())
    return source, os.path.join(BUILD_DIR, f"lib{stem}_{digest.hexdigest()[:16]}.so"), flags


def _read_log(path: str) -> str:
    """The compiler's output kept beside a built library ("" if none)."""
    try:
        with open(path + ".log") as f:
            return f.read()
    except OSError:
        return ""


def load_libraries(names) -> Dict[str, KernelLibrary]:
    """Build (where needed) and load ``csrc/<name>.cu`` for every name; cached
    per process.  The sources that need a build are compiled at once, one
    ``nvcc`` each, all started together; a library's ``build_seconds`` runs
    from that start to when its build was collected.  Raises, after every
    build has ended, if any failed."""
    with _lock:
        pending = {}
        for name in names:
            if name in _loaded or name in pending:
                continue
            source, path, flags = _library_path(name)
            if os.path.exists(path):
                _loaded[name] = KernelLibrary(ctypes.CDLL(path), path, 0.0, _read_log(path))
                continue
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            log = tempfile.TemporaryFile(mode="w+", dir=BUILD_DIR)
            cmd = [find_nvcc(), *NVCC_FLAGS, *flags, "-o", tmp, source]
            proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, text=True)
            pending[name] = (source, path, tmp, log, proc)
        t0 = time.perf_counter()
        failures = []
        for name, (source, path, tmp, log, proc) in pending.items():
            returncode = proc.wait()
            seconds = time.perf_counter() - t0
            log.seek(0)
            text = log.read()
            log.close()
            if returncode != 0:
                os.unlink(tmp)
                failures.append(f"nvcc failed ({returncode}) building {source}:\n{text}")
                continue
            with open(path + ".log", "w") as f:
                f.write(text)
            os.replace(tmp, path)
            _loaded[name] = KernelLibrary(ctypes.CDLL(path), path, seconds, text)
        if failures:
            raise RuntimeError("\n".join(failures))
        return {name: _loaded[name] for name in names}


def load_library(name: str) -> KernelLibrary:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    return load_libraries([name])[name]


# PyTorch's current raw CUDA stream, without building a Stream object per call
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def current_stream(device: torch.device) -> int:
    """The raw handle of PyTorch's current CUDA stream on ``device``, which
    the kernels launch on."""
    if _raw_stream is not None:
        return _raw_stream(device.index)
    return torch.cuda.current_stream(device).cuda_stream
