"""The IRLS step around the evaluation, on the card: the head and tail
kernels of ``csrc/fused_stats.cu`` (``dvo_irls_step_head`` /
``dvo_irls_step_tail``), which do what ``models/dense_tracker._step`` does
besides its ``evaluate`` call.

  * ``step_head_cuda``: inc = exp_se3(x), T_new = inc T, initial_new =
    inverse(inc) initial, into new buffers (kernel 1 reads T_new);
  * ``step_tail_cuda``: from the evaluation (n, precision, ll, A, b), the
    carry and the head's outputs, the prior with smoothing, the equilibrated
    Cholesky solve, the termination tests and code, the accept/revert of the
    carried fields, iteration + 1 and done, written into the carry's buffers
    (``out``, which may be the carry read) and the iteration's trace row.

``dense_tracker._step`` is their plain version: the CPU's and float64's
step, and the oracle of the card tests.  The elementwise ops round as
PyTorch's; the small matrix products and the Cholesky sums take one fixed
order (the kernel's notes), so a stream's values may part from the plain
step's by some ulps, and do not depend on B.

The carry is ``dense_tracker._Carry``'s twelve fields in its order, each
with a leading batch shape (none for one stream).  Each call adds one to
``step_head_cuda.launches`` or ``step_tail_cuda.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from .. import _build
from . import fused_kernels

# _Carry's fields: (per-stream shape, dtype)
CARRY = (
    ((6,), torch.float32),  # x
    ((4, 4), torch.float32),  # T
    ((4, 4), torch.float32),  # initial
    ((4, 4), torch.float32),  # inc_applied
    ((2, 2), torch.float32),  # precision
    ((), torch.float32),  # error
    ((6, 6), torch.float32),  # A
    ((), torch.float32),  # ll
    ((), torch.int32),  # n
    ((), torch.int32),  # iteration
    ((), torch.int32),  # termination
    ((), torch.bool),  # done
)
# the evaluation's fields (n, precision, ll, A, b) and the trace's
# (valid constraints, log-likelihood, precision, increment, information)
EVALUATION = (((), torch.int32), ((2, 2), torch.float32), ((), torch.float32),
              ((6, 6), torch.float32), ((6,), torch.float32))
TRACE = ((), (), (2, 2), (6,), (6, 6))
# a level's start values (x, T, initial, precision): a level's first step
# makes the rest of its initial carry (``step_tail_cuda``'s ``start``)
START = CARRY[:3] + CARRY[4:5]
_POINTERS = len(EVALUATION) + 3 + 2 * len(CARRY) + len(TRACE)


@functools.lru_cache(maxsize=None)
def _library():
    lib = fused_kernels._kernel_library()
    count = lib.dvo_irls_step_pointers()
    if count != _POINTERS:
        raise RuntimeError(f"fused_stats library's step tail takes {count} pointers, not "
                           f"{_POINTERS}")
    return lib


def _check(who, name, t, shape, dtype):
    """``t`` must be a tensor of ``shape`` and ``dtype`` (its device is
    checked once all are: ``_on_one_card``)."""
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{who}: {name} must be a CUDA tensor")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{who}: {name} must be {list(shape)}, got {list(t.shape)}")
    if t.dtype != dtype:
        raise ValueError(f"{who}: {name} must be {dtype}, got {t.dtype}")


def _on_one_card(who, tensors) -> torch.device:
    device = tensors[0].device
    for t in tensors:
        if t is not None and not t.is_cuda:
            raise ValueError(f"{who}: every input must be a CUDA tensor")
        if t is not None and t.device != device:
            raise ValueError(f"{who}: inputs on different devices")
    return device


def _batch_of(who, x) -> Tuple[tuple, int]:
    if not isinstance(x, torch.Tensor) or x.dim() < 1 or x.shape[-1] != 6:
        raise ValueError(f"{who}: x must be a [..., 6] CUDA tensor")
    batch = tuple(x.shape[:-1])
    streams = 1
    for size in batch:
        streams *= size
    if streams < 1:
        raise ValueError(f"{who}: no stream in a batch of shape {list(batch)}")
    return batch, streams


def step_head_cuda(x, T, initial):
    """The head of the step: (inc, T_new, initial_new), new [*batch, 4, 4]
    float32 tensors, from ``x`` [*batch, 6], ``T`` and ``initial`` [*batch,
    4, 4] (float32 CUDA tensors).  One launch on the current stream."""
    who = "step_head_cuda"
    batch, streams = _batch_of(who, x)
    _check(who, "x", x, batch + (6,), torch.float32)
    _check(who, "T", T, batch + (4, 4), torch.float32)
    _check(who, "initial", initial, batch + (4, 4), torch.float32)
    _on_one_card(who, (x, T, initial))
    x, T, initial = x.contiguous(), T.contiguous(), initial.contiguous()
    outs = [torch.empty(batch + (4, 4), dtype=torch.float32, device=x.device) for _ in range(3)]
    err = _library().dvo_irls_step_head(
        x.data_ptr(), T.data_ptr(), initial.data_ptr(), streams,
        *(t.data_ptr() for t in outs), _build.current_stream(x.device))
    if err != 0:
        raise RuntimeError(f"{who}: kernel launch failed, CUDA error {err}")
    step_head_cuda.launches += 1
    return tuple(outs)


step_head_cuda.launches = 0


def _per_stream(who, name, t, batch, shape, dtype):
    """(t as [streams, *shape], the words between two streams' values): a
    view where each stream's values are contiguous, else a copy."""
    _check(who, name, t, batch + shape, dtype)
    flat = t.reshape((-1,) + shape)
    if not flat[0].is_contiguous():
        flat = flat.contiguous()
    return flat, flat.stride(0)


def step_tail_cuda(evaluation: Sequence[torch.Tensor], head: Sequence[torch.Tensor],
                   carry: Sequence[torch.Tensor], out: Sequence[torch.Tensor],
                   trace: Optional[Sequence[torch.Tensor]], *, freeze: bool, smoothing: bool,
                   mu: float, precision: float, max_iterations: int, start: bool = False):
    """The tail of the step, one launch on the current stream, nothing
    returned: the new carry into ``out`` (twelve contiguous tensors in
    ``_Carry``'s order; ``out`` may be ``carry`` itself) and, with
    ``trace`` (five contiguous [max_iterations, *batch, ...] buffers), the
    iteration's row at its iteration.  ``evaluation`` is ``evaluate``'s
    (n, precision, ll, A, b), each field contiguous within a stream;
    ``head`` is ``step_head_cuda``'s.  ``freeze``: a done stream's carry
    stays (the chunk's rule for batches and chunks of several steps);
    ``smoothing`` / ``mu``: the prior; ``precision``: the increment's
    convergence threshold; ``max_iterations``: the level's cap.  With
    ``start`` the step is a level's first: ``carry`` holds the level's four
    start values (``START``) and the kernel makes the rest of the initial
    carry (``dense_tracker._initial_carry``'s, with the head's inc as its
    inc_applied)."""
    who = "step_tail_cuda"
    fields = START if start else CARRY
    if len(carry) != len(fields) or len(out) != len(CARRY) or len(evaluation) != len(EVALUATION):
        raise ValueError(f"{who}: a carry has {len(fields)} fields here, a carry written "
                         f"{len(CARRY)} and an evaluation {len(EVALUATION)}")
    batch, streams = _batch_of(who, carry[0])
    views, strides = [], []
    for name, t, (shape, dtype) in zip(("n", "precision", "ll", "A", "b"), evaluation, EVALUATION):
        flat, stride = _per_stream(who, f"evaluation.{name}", t, batch, shape, dtype)
        views.append(flat)
        strides.append(stride)
    for name, t in zip(("inc", "T_new", "initial_new"), head):
        _check(who, name, t, batch + (4, 4), torch.float32)
        if not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous")
    ins = []
    for k, (t, (shape, dtype)) in enumerate(zip(carry, fields)):
        _check(who, f"carry[{k}]", t, batch + shape, dtype)
        ins.append(t.contiguous())
    if start:
        x, T, initial, precision_start = ins
        ins = [x, T, initial, head[0], precision_start] + [None] * (len(CARRY) - 5)
    for k, (t, (shape, dtype)) in enumerate(zip(out, CARRY)):
        _check(who, f"out[{k}]", t, batch + shape, dtype)
        if not t.is_contiguous():
            raise ValueError(f"{who}: out[{k}] must be contiguous")
    rows = [None] * len(TRACE)
    if trace is not None:
        for k, (t, shape) in enumerate(zip(trace, TRACE)):
            _check(who, f"trace[{k}]", t, (max_iterations,) + batch + shape, torch.float32)
            if not t.is_contiguous():
                raise ValueError(f"{who}: trace[{k}] must be contiguous")
        rows = list(trace)
    tensors = views + list(head) + ins + list(out) + rows
    device = _on_one_card(who, tensors)
    pointers = (ctypes.c_void_p * _POINTERS)(*(None if t is None else t.data_ptr()
                                                for t in tensors))
    eval_strides = (ctypes.c_longlong * len(EVALUATION))(*strides)
    err = _library().dvo_irls_step_tail(
        ctypes.cast(pointers, ctypes.c_void_p), ctypes.cast(eval_strides, ctypes.c_void_p),
        streams, int(max_iterations), int(bool(freeze)), int(bool(smoothing)), int(bool(start)),
        float(mu), float(precision), _build.current_stream(device))
    if err != 0:
        raise RuntimeError(f"{who}: kernel launch failed, CUDA error {err}")
    step_tail_cuda.launches += 1


step_tail_cuda.launches = 0
