"""Checks of the device loops' CUDA graphs (``models/irls_graph``) against
the eager loops, for ``tests_cuda/test_irls_graph_cuda.py``,
``tests_cuda/test_sharded_graph_cuda.py`` and ``chip_smoke.py`` phases 6,
17 and 19.

  * ``loop_mode(graphs, chunk=None, sharded=None)``: run the card's loops
    (the tracker's, the pixel-sharded level's, block-CG's) with or without
    graphs, the tracker's at K = ``chunk`` and the pixel-sharded level's
    at K = ``sharded`` (None: as they are; the module settings are
    restored after; block-CG takes its K as an argument);
  * ``recording()``: every level solve of the calling thread, with its
    final carry, level statistics and trace; ``sharded_recording()`` the
    same for the pixel-sharded levels (carry and iterations);
  * ``differences(a, b)``: the fields in which two recordings part, bit
    for bit (NaNs by their bits);
  * ``counting_reads()``: the host reads of tensors (``bool``, ``tolist``
    and the like) made while open, by this thread;
  * ``counts(level_stats, chunk)``: the loop's iterations, executed steps
    and host reads for levels' statistics at K = ``chunk``.
"""

from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple, Optional

import torch

from ..models import dense_tracker
from ..parallel import sharded_alignment

_READS = ("__bool__", "item", "cpu", "numpy", "tolist", "__int__", "__float__", "__index__")


@contextlib.contextmanager
def loop_mode(graphs: bool, chunk: Optional[int] = None, sharded: Optional[int] = None):
    """The card's device loops as graphs (True) or eager, the tracker's
    IRLS loop at K = ``chunk`` and the pixel-sharded level's at K =
    ``sharded`` (None leaves a K as it is)."""
    modules = (dense_tracker, sharded_alignment)
    saved = dense_tracker.CUDA_GRAPHS, [m.CHUNK_STEPS for m in modules]
    dense_tracker.CUDA_GRAPHS = graphs
    for module, value in zip(modules, (chunk, sharded)):
        if value is not None:
            module.CHUNK_STEPS = value
    try:
        yield
    finally:
        dense_tracker.CUDA_GRAPHS = saved[0]
        for module, value in zip(modules, saved[1]):
            module.CHUNK_STEPS = value


@contextlib.contextmanager
def recording():
    """Yields a list that collects (carry, stats, trace) of each level that
    the calling thread solves while open."""
    levels = []
    me = threading.get_ident()
    original = dense_tracker._match_level

    def match_level(*args, **kwargs):
        out = original(*args, **kwargs)
        if threading.get_ident() == me:
            levels.append(out)
        return out

    dense_tracker._match_level = match_level
    try:
        yield levels
    finally:
        dense_tracker._match_level = original


class ShardedLevel(NamedTuple):
    """What a pixel-sharded level returns beside its carry."""

    iterations: int


@contextlib.contextmanager
def sharded_recording():
    """Yields a list that collects (carry, ``ShardedLevel``, None) of each
    pixel-sharded level that the calling thread solves while open, in the
    form ``differences`` compares."""
    levels = []
    me = threading.get_ident()
    original = sharded_alignment._match_level_sharded

    def match_level(*args, **kwargs):
        carry, iterations = original(*args, **kwargs)
        if threading.get_ident() == me:
            levels.append((carry, ShardedLevel(iterations), None))
        return carry, iterations

    sharded_alignment._match_level_sharded = match_level
    try:
        yield levels
    finally:
        sharded_alignment._match_level_sharded = original


def _bits(t):
    t = torch.as_tensor(t).detach().contiguous()
    if t.is_floating_point():
        return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])
    return t


def _same(a, b) -> bool:
    a, b = _bits(a), _bits(b)
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())


def differences(got, want) -> list:
    """Where two recordings of the same solves part: the level count, or a
    level's carry field, level statistic or trace field that is not
    bit-equal."""
    if len(got) != len(want):
        return [f"{len(got)} levels against {len(want)}"]
    out = []
    for i, ((c_got, s_got, t_got), (c_want, s_want, t_want)) in enumerate(zip(got, want)):
        for name, a, b in ([(f"carry.{f}", getattr(c_got, f), getattr(c_want, f))
                            for f in c_want._fields]
                           + [(f"stats.{f}", getattr(s_got, f), getattr(s_want, f))
                              for f in s_want._fields]):
            if not _same(a, b):
                out.append(f"level solve {i}: {name}")
        if (t_got is None) != (t_want is None):
            out.append(f"level solve {i}: trace present in one recording only")
        elif t_want is not None:
            out += [f"level solve {i}: trace.{f}" for f in t_want._fields
                    if not _same(getattr(t_got, f), getattr(t_want, f))]
    return out


@contextlib.contextmanager
def counting_reads():
    """Yields a list of the names of the host reads of tensors that the
    calling thread makes while open."""
    reads = []
    me = threading.get_ident()
    originals = {name: getattr(torch.Tensor, name) for name in _READS}

    def counted(name, original):
        def read(self, *args, **kwargs):
            if threading.get_ident() == me:
                reads.append(name)
            return original(self, *args, **kwargs)
        return read

    for name, original in originals.items():
        setattr(torch.Tensor, name, counted(name, original))
    try:
        yield reads
    finally:
        for name, original in originals.items():
            setattr(torch.Tensor, name, original)


def slowest(stats) -> int:
    """A level's loop iterations: its slowest stream's in lockstep."""
    its = stats.iterations
    return int(its.max()) if isinstance(its, torch.Tensor) else int(its)


def counts(level_stats, chunk: int):
    """(iterations, executed steps, host reads) of the IRLS loop at K =
    ``chunk`` for an iterable of ``LevelStats``: per level the slowest
    stream's iterations, K * ceil(iterations / K) steps (each one
    evaluation, the kernel's launch) and ceil(iterations / K) reads."""
    its = [slowest(s) for s in level_stats]
    return (sum(its), dense_tracker.executed_steps(its, chunk),
            sum(-(-it // chunk) for it in its))


def stats_of(levels):
    """The ``LevelStats`` of recorded levels."""
    return [stats for _, stats, _ in levels]
