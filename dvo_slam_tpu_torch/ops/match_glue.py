"""A tracker match's glue on the card: the glue kernels of
``csrc/fused_stats.cu`` (``dvo_match_setup``, ``dvo_match_link``,
``dvo_match_result``), which do what ``models/dense_tracker``'s plain glue
does around a match's levels.

  * ``setup_cuda``: the first level's start values (x, T, initial,
    precision) from the warm start or the identity (``match_start``);
  * ``link_cuda``: the next level's start values from a level's final carry
    (``next_start``);
  * ``result_cuda``: the match's flat float32 row [*batch, 53 + 4 levels]
    from the last level's final carry and every level's final carry and
    refpack (``level_stats``, ``match_result`` and ``flatten_result``).

Each writes into ``out`` where it is given (a match graph's static
buffers), else into new tensors, and returns what it wrote.  The plain glue
stays the CPU's and float64's glue and the kernels' oracle.  The kernels
take the step kernels' exp, log and inverse (``ops/irls_step``), so a
stream's values part from the plain glue's by a few ulps only where cuBLAS
orders a small product otherwise, and do not depend on B.

Each call adds one to its wrapper's ``launches``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Sequence, Tuple

import torch

from .. import _build
from . import fused_kernels
from .irls_step import _check, _on_one_card

# the row's words before the levels' counts: T (16), information (36), nll
ROW_BASE = 53
# the start values (x, T, initial, precision): per-stream shapes
START = ((6,), (4, 4), (4, 4), (2, 2))
MAX_LEVELS = 8  # the most levels ``result_cuda`` takes (the kernel's argument block)


@functools.lru_cache(maxsize=None)
def _library():
    lib = fused_kernels._kernel_library()
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dvo_match_setup.argtypes = [p, i] + [p] * 5
    lib.dvo_match_link.argtypes = [p] * 4 + [i] + [p] * 5
    lib.dvo_match_result.argtypes = [p, p, p, i, i, i, f, f, p, p]
    lib.dvo_match_glue_max_levels.argtypes = []
    for name in ("dvo_match_setup", "dvo_match_link", "dvo_match_result",
                 "dvo_match_glue_max_levels"):
        getattr(lib, name).restype = i
    if lib.dvo_match_glue_max_levels() != MAX_LEVELS:
        raise RuntimeError(f"fused_stats library's match result takes "
                           f"{lib.dvo_match_glue_max_levels()} levels, not {MAX_LEVELS}")
    return lib


def _outputs(who, out, batch, device) -> Tuple[torch.Tensor, ...]:
    """The four start buffers: ``out`` checked, or new ones."""
    if out is None:
        return tuple(torch.empty(batch + shape, dtype=torch.float32, device=device)
                     for shape in START)
    if len(out) != len(START):
        raise ValueError(f"{who}: out holds the {len(START)} start values")
    for name, t, shape in zip(("x", "T", "initial", "precision"), out, START):
        _check(who, f"out.{name}", t, batch + shape, torch.float32)
        if not t.is_contiguous():
            raise ValueError(f"{who}: out.{name} must be contiguous")
    return tuple(out)


def setup_cuda(initial: Optional[torch.Tensor], batch: tuple, device,
               out: Optional[Sequence[torch.Tensor]] = None) -> Tuple[torch.Tensor, ...]:
    """The first level's start values (x [*batch, 6], T, initial [*batch, 4,
    4], precision [*batch, 2, 2]) from the warm start ``initial`` (result
    space, [*batch, 4, 4] float32 on the card) or the identity (None), into
    ``out`` or new tensors on ``device``.  One launch on the current
    stream."""
    who = "setup_cuda"
    batch = tuple(batch)
    streams = math.prod(batch)
    if streams < 1:
        raise ValueError(f"{who}: no stream in a batch of shape {list(batch)}")
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"{who}: the start values must go to a CUDA device")
    if initial is not None:
        _check(who, "initial", initial, batch + (4, 4), torch.float32)
        _on_one_card(who, [initial])
    out = _outputs(who, out, batch, device)
    device = _on_one_card(who, list(out) + ([] if initial is None else [initial]))
    init = None if initial is None else initial.contiguous()
    err = _library().dvo_match_setup(
        None if init is None else init.data_ptr(), streams, *(t.data_ptr() for t in out),
        _build.current_stream(device))
    if err != 0:
        raise RuntimeError(f"{who}: kernel launch failed, CUDA error {err}")
    setup_cuda.launches += 1
    return out


setup_cuda.launches = 0


def link_cuda(inc_applied: torch.Tensor, T: torch.Tensor, initial: torch.Tensor,
              precision: torch.Tensor,
              out: Optional[Sequence[torch.Tensor]] = None) -> Tuple[torch.Tensor, ...]:
    """The next level's start values from a level's final carry fields:
    x = log_se3(``inc_applied``), then ``T``, ``initial`` and ``precision``
    as they are ([*batch, 4, 4] and [*batch, 2, 2] float32 CUDA tensors),
    into ``out`` or new tensors.  One launch on the current stream."""
    who = "link_cuda"
    if not isinstance(inc_applied, torch.Tensor) or inc_applied.dim() < 2:
        raise ValueError(f"{who}: inc_applied must be a [..., 4, 4] CUDA tensor")
    batch = tuple(inc_applied.shape[:-2])
    streams = math.prod(batch)
    if streams < 1:
        raise ValueError(f"{who}: no stream in a batch of shape {list(batch)}")
    fields = (inc_applied, T, initial, precision)
    for name, t, shape in zip(("inc_applied", "T", "initial", "precision"), fields,
                              ((4, 4), (4, 4), (4, 4), (2, 2))):
        _check(who, name, t, batch + shape, torch.float32)
    if out is not None:
        out = _outputs(who, out, batch, None)
    device = _on_one_card(who, fields + tuple(out or ()))
    out = out or _outputs(who, None, batch, device)
    fields = tuple(t.contiguous() for t in fields)
    err = _library().dvo_match_link(*(t.data_ptr() for t in fields), streams,
                                    *(t.data_ptr() for t in out), _build.current_stream(device))
    if err != 0:
        raise RuntimeError(f"{who}: kernel launch failed, CUDA error {err}")
    link_cuda.launches += 1
    return out


link_cuda.launches = 0


def _selection(who, l, refpack, batch):
    """(level ``l``'s refpack as [streams, 8, N] with unit-stride rows,
    N): its row 6 of stream 0 and the words between two streams' rows
    are what the kernel reads."""
    if not isinstance(refpack, torch.Tensor) or refpack.dim() < 2 or refpack.shape[-2] != 8:
        raise ValueError(f"{who}: level {l}'s refpack must be a [..., 8, N] CUDA tensor")
    pixels = refpack.shape[-1]
    _check(who, f"refpack[{l}]", refpack, batch + (8, pixels), torch.float32)
    flat = refpack.reshape((-1, 8, pixels))
    if flat.stride(-1) != 1:
        flat = flat.contiguous()
    return flat, pixels


def result_cuda(final: Sequence[torch.Tensor], levels: Sequence[Tuple[Sequence[torch.Tensor],
                                                                      torch.Tensor]],
                *, smoothing: bool, mu: float, info_scale: float,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The match's flat row [*batch, 53 + 4 levels] (float32) into ``out``
    or a new tensor.  ``final``: the last level's final (T, initial, A, ll)
    ([*batch, 4, 4], [*batch, 4, 4], [*batch, 6, 6], [*batch] float32);
    ``levels``: for each level, coarse to fine, ((n, iteration,
    termination), refpack), its final counts ([*batch] int32) and its
    refpack [*batch, 8, N] (the selected pixels are its row 6's nonzero
    entries); ``smoothing`` / ``mu``: the prior's term in the negative
    log-likelihood; ``info_scale``: the information's scale.  One launch on
    the current stream."""
    who = "result_cuda"
    if len(final) != 4:
        raise ValueError(f"{who}: final holds the last level's T, initial, A and ll")
    T, initial, A, ll = final
    if not isinstance(T, torch.Tensor) or T.dim() < 2:
        raise ValueError(f"{who}: T must be a [..., 4, 4] CUDA tensor")
    batch = tuple(T.shape[:-2])
    streams = math.prod(batch)
    if streams < 1:
        raise ValueError(f"{who}: no stream in a batch of shape {list(batch)}")
    for name, t, shape in zip(("T", "initial", "A", "ll"), final, ((4, 4), (4, 4), (6, 6), ())):
        _check(who, name, t, batch + shape, torch.float32)
    if not levels or len(levels) > MAX_LEVELS:
        raise ValueError(f"{who}: {len(levels)} levels; the kernel takes 1 to {MAX_LEVELS}")
    # the kernel's pointers: the final fields, then each level's counts and
    # its selection row of stream 0
    pointers, strides, pixels, tensors = [t.contiguous() for t in final], [], [], list(final)
    for l, (counts, refpack) in enumerate(levels):
        if len(counts) != 3:
            raise ValueError(f"{who}: level {l} holds n, iteration and termination")
        for name, t in zip(("n", "iteration", "termination"), counts):
            _check(who, f"{name}[{l}]", t, batch, torch.int32)
        flat, n = _selection(who, l, refpack, batch)
        pointers += [t.contiguous() for t in counts] + [flat[0, 6]]
        strides.append(flat.stride(0))
        pixels.append(n)
        tensors += [*counts, refpack]
    width = ROW_BASE + 4 * len(levels)
    if out is not None:
        _check(who, "out", out, batch + (width,), torch.float32)
        if not out.is_contiguous():
            raise ValueError(f"{who}: out must be contiguous")
    device = _on_one_card(who, tensors + ([] if out is None else [out]))
    if out is None:
        out = torch.empty(batch + (width,), dtype=torch.float32, device=device)
    lib = _library()
    addresses = (ctypes.c_void_p * len(pointers))(*(t.data_ptr() for t in pointers))
    c_strides = (ctypes.c_longlong * len(strides))(*strides)
    c_pixels = (ctypes.c_int * len(pixels))(*pixels)
    err = lib.dvo_match_result(
        ctypes.cast(addresses, ctypes.c_void_p), ctypes.cast(c_strides, ctypes.c_void_p),
        ctypes.cast(c_pixels, ctypes.c_void_p), len(levels), streams, int(bool(smoothing)),
        float(mu), float(info_scale), out.data_ptr(), _build.current_stream(device))
    if err != 0:
        raise RuntimeError(f"{who}: kernel launch failed, CUDA error {err}")
    result_cuda.launches += 1
    return out


result_cuda.launches = 0
