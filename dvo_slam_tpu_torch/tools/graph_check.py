"""Checks of the device loops' CUDA graphs (``models/irls_graph``) against
the eager loops, for ``tests_cuda/test_irls_graph_cuda.py``,
``tests_cuda/test_sharded_graph_cuda.py`` and ``chip_smoke.py`` phases 6,
17 and 19.

  * ``loop_mode(graphs, chunk=None, sharded=None, polled=None)``: run the
    card's loops (the tracker's, the pixel-sharded level's, block-CG's)
    with or without graphs, the tracker's at K = ``chunk`` and the
    pixel-sharded level's at K = ``sharded``, the tracker's levels as
    host-polled chunk replays (``polled`` True) or one while-graph launch
    each (False) (None: as they are; the module settings are restored
    after; block-CG takes its K as an argument);
  * ``recording()``: every level solve of the calling thread, with its
    final carry, level statistics and trace; ``sharded_recording()`` the
    same for the pixel-sharded levels (carry and iterations);
  * ``differences(a, b)``: the fields in which two recordings part, bit
    for bit (NaNs by their bits);
  * ``counting_reads()``: the host reads of tensors (``bool``, ``tolist``
    and the like) made while open, by this thread;
  * ``set_while_check(device)``: the while graph's ``set_while`` kernel
    against its plain version on a loop of known length, with times;
  * ``counts(level_stats, chunk)``: the loop's iterations, executed steps
    and the host-polled form's reads for levels' statistics at K =
    ``chunk`` (the while form reads none; ``dense_tracker.read_done.calls``
    counts the reads a run made).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import NamedTuple, Optional

import torch

from ..models import dense_tracker, irls_graph
from ..parallel import sharded_alignment

_READS = ("__bool__", "item", "cpu", "numpy", "tolist", "__int__", "__float__", "__index__")


@contextlib.contextmanager
def loop_mode(graphs: bool, chunk: Optional[int] = None, sharded: Optional[int] = None,
              polled: Optional[bool] = None):
    """The card's device loops as graphs (True) or eager, the tracker's
    IRLS loop at K = ``chunk`` and the pixel-sharded level's at K =
    ``sharded`` (None leaves a K as it is), the tracker's graph levels
    host-polled (``polled`` True) or as while graphs (False; None leaves
    the form as it is)."""
    modules = (dense_tracker, sharded_alignment)
    saved = (dense_tracker.CUDA_GRAPHS, dense_tracker.WHILE_GRAPHS,
             [m.CHUNK_STEPS for m in modules])
    dense_tracker.CUDA_GRAPHS = graphs
    if polled is not None:
        dense_tracker.WHILE_GRAPHS = not polled
    for module, value in zip(modules, (chunk, sharded)):
        if value is not None:
            module.CHUNK_STEPS = value
    try:
        yield
    finally:
        dense_tracker.CUDA_GRAPHS, dense_tracker.WHILE_GRAPHS = saved[:2]
        for module, value in zip(modules, saved[2]):
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

    iterations: torch.Tensor  # [] int32


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
    return int(torch.as_tensor(stats.iterations).max())


def counts(level_stats, chunk: int):
    """(iterations, executed steps, host-polled reads) of the IRLS loop at
    K = ``chunk`` for an iterable of ``LevelStats``: per level the slowest
    stream's iterations, K * ceil(iterations / K) steps (each one
    evaluation, the kernel's launch) and the ceil(iterations / K) reads of
    the eager and host-polled forms."""
    its = [slowest(s) for s in level_stats]
    return (sum(its), dense_tracker.executed_steps(its, chunk),
            sum(-(-it // chunk) for it in its))


def stats_of(levels):
    """The ``LevelStats`` of recorded levels."""
    return [stats for _, stats, _ in levels]


# set_while_check: the stream counts B and the steps of the timed loop
SET_WHILE_BATCHES = (1, 2, 8, 136)
SET_WHILE_STEPS = 1000


def _set_while_graphs(start, limit, x, done):
    """Head (x = start, done = x >= limit) and tail (x += 1, done again),
    captured with ``keep_graph=True`` on a side stream."""
    side = torch.cuda.Stream(start.device)
    side.wait_stream(torch.cuda.current_stream(start.device))
    head = torch.cuda.CUDAGraph(keep_graph=True)
    tail = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.stream(side):
        x.copy_(start)
        torch.ge(x, limit, out=done)
        side.synchronize()
        head.capture_begin(capture_error_mode="thread_local")
        x.copy_(start)
        torch.ge(x, limit, out=done)
        head.capture_end()
        tail.capture_begin(pool=head.pool(), capture_error_mode="thread_local")
        x.add_(1)
        torch.ge(x, limit, out=done)
        tail.capture_end()
    torch.cuda.current_stream(start.device).wait_stream(side)
    return head, tail


def _plain_loop(start, limit):
    """The same loop eagerly, the condition read on the host each step ->
    (final x, tail steps)."""
    x = start.clone()
    done = x >= limit
    steps = 0
    while bool((~done).any()):
        x.add_(1)
        done = x >= limit
        steps += 1
    return x, steps


def set_while_check(device, batches=SET_WHILE_BATCHES, steps=SET_WHILE_STEPS) -> list:
    """``set_while`` (``csrc/while_graph.cu``) against its plain version on
    the card, for each B of ``batches``: a while graph whose head sets x =
    start and done = x >= limit and whose tail adds one to x and sets done
    again (stream b needs limit_b - start_b tail steps, some none), against
    the same loop run eagerly with a host read of ``(~done).any()`` per
    step.  Per B: the tail chunks ``set_while`` counted and the plain
    loop's steps, the largest difference of the final x (``abs_err``: both
    differences added), and, at ``steps`` steps, ms per step of the while
    graph (CUDA events around one launch) and of the plain loop (host
    clock between two synchronizations)."""
    rows = []
    for batch in batches:
        b = torch.arange(batch, dtype=torch.int32, device=device)
        start = (7 * b) % 5
        limit = start + (5 * b) % 7 * (b % 2)  # the even streams done at the head
        x = torch.zeros(batch, dtype=torch.int32, device=device)
        done = torch.zeros(batch, dtype=torch.bool, device=device)
        runs = torch.zeros(2, dtype=torch.int64, device=device)
        head, tail = _set_while_graphs(start, limit, x, done)
        exec_ = irls_graph.build_while(head, tail, done, runs)
        try:
            irls_graph.launch_while(exec_, device)
            want_x, want_steps = _plain_loop(start, limit)
            heads, tails = runs.tolist()
            err = abs(tails - want_steps) + abs(heads - 1) + int((x - want_x).abs().max())
            limit.copy_(start + steps)  # the timed loop: every stream `steps` steps
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            irls_graph.launch_while(exec_, device)  # warm
            events[0].record()
            irls_graph.launch_while(exec_, device)
            events[1].record()
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            _plain_loop(start, limit)
            torch.cuda.synchronize(device)
            plain_s = time.perf_counter() - t0
            rows.append({"streams": batch, "tail_chunks": tails, "plain_steps": want_steps,
                         "abs_err": err,
                         "ms_per_step": events[0].elapsed_time(events[1]) / (steps + 1),
                         "plain_ms_per_step": 1000.0 * plain_s / steps})
        finally:
            torch.cuda.synchronize(device)
            irls_graph.destroy_while(exec_)
    return rows
