"""Identity copy of a quad table into a standalone buffer (counterpart of
the TPU kernel ``pallas_copy`` in ``tools/gather_probe.py``).

The gather probe's ``pcopy`` variant copies each stream's [32, N] table out
of the stacked [B, 32, N] table, so that every stream's gather reads an
allocation of its own.  Two implementations, one result:
  * ``table_copy_plain`` — ``x.clone()``: the CPU path, the kernel's oracle
    and the time it is compared with;
  * ``table_copy_cuda`` — the hand-written CUDA kernel
    (``csrc/table_copy.cu``, ``dvo_table_copy``): a float4 grid-stride copy.
``table_copy`` picks one by the tensor's device.
"""

from __future__ import annotations

import ctypes
import functools

import torch


def table_copy_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain version: a new buffer holding ``x``."""
    return x.clone()


@functools.lru_cache(maxsize=None)
def _kernel_library():
    from .._build import load_library

    lib = load_library("table_copy").lib
    lib.dvo_table_copy.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
    ]
    lib.dvo_table_copy.restype = ctypes.c_int
    return lib


def table_copy_cuda(x: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel: ``x`` [C, n] float32, contiguous, on a card -> a new
    [C, n] buffer with the same bits; one launch on the current stream, no
    host synchronisation.  Each call adds one to ``table_copy_cuda.launches``."""
    if not isinstance(x, torch.Tensor) or not x.is_cuda:
        raise ValueError("table_copy_cuda: x must be a CUDA tensor")
    if x.dtype != torch.float32:
        raise ValueError(f"table_copy_cuda: x must be float32, got {x.dtype}")
    if x.dim() != 2 or x.numel() == 0:
        raise ValueError(f"table_copy_cuda: x must be a non-empty [C, n] table, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("table_copy_cuda: x must be contiguous")
    lib = _kernel_library()
    out = torch.empty_like(x)
    err = lib.dvo_table_copy(
        x.data_ptr(), out.data_ptr(), x.numel(), torch.cuda.current_stream(x.device).cuda_stream
    )
    if err != 0:
        raise RuntimeError(f"table_copy_cuda: kernel launch failed, CUDA error {err}")
    table_copy_cuda.launches += 1
    return out


table_copy_cuda.launches = 0


def table_copy(x: torch.Tensor) -> torch.Tensor:
    """Dispatch on the tensor's device: a CPU tensor takes the plain copy, a
    CUDA tensor the kernel; any other device raises."""
    kind = x.device.type
    if kind == "cpu":
        return table_copy_plain(x)
    if kind == "cuda":
        return table_copy_cuda(x)
    raise ValueError(f"table_copy: no implementation for device {x.device}")
