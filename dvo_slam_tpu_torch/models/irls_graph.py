"""The IRLS loop's chunks as CUDA graphs: the card's form of the
reference's device-resident ``lax.while_loop``
(``dvo_slam_tpu/models/dense_tracker.py``).

``dense_tracker`` runs each level's loop in chunks of K steps and reads
its ``done`` flags once per chunk.  On the card a chunk is one CUDA graph
replay instead of K x ~340 launches from the host.  For each key (the
backend, the inputs' shapes and types, K, the configuration fields and
intrinsics that a step bakes in) this module captures two graphs over one
set of static buffers:

  * the *head*: the level's initial carry from the static start values,
    then K steps, the first with ``first = True`` (iteration 0 is always
    the head's step 0, so the kernel's ``first`` launch argument stays a
    constant of the graph);
  * the *tail*: K steps from the carry buffers, ``first = False``.

Each graph's last ops copy the new state into the state buffers, so
replays chain.  A level copies its inputs into the static input buffers,
replays the head, then the tail until ``done``; the caller reads the
state buffers between replays and clones them at the end.

The first level of a key runs its head chunk eagerly on the capture
stream (the warm-up: it settles the caching allocator, cuBLAS and the
kernels' ticket buffer of that stream outside any capture), and that run
is the level's real first chunk.  The two captures follow; they launch
nothing, so the launch counts that capture moves are taken back and
added once per replay instead (``counters``).

The cache is bounded (``CACHE_BYTES``, the captures' pools and the static
buffers of the keys it holds): past it, the least recently used keys that
no thread is solving are dropped, and a key that comes back is captured
anew.  ``release()`` drops every key, for a process that is done with the
card, and ``release(where=...)`` the keys that match.  No tracker calls it:
the cache serves every tracker of the process, and the driver resets its
SLAM between timed runs, which would then capture every key again inside
each run.

The same cache serves the multi-rank loops (the pixel-sharded IRLS level,
block-CG), whose graphs hold NCCL collectives: a captured collective keeps
its communicator baked in.  Their keys carry ``group_key(group)``: the
group's backend, size and rank, and the generation that each
``parallel.distributed.initialize`` starts (``new_generation``), so that a
group made after another never replays the other's graphs; and
``parallel.distributed.shutdown`` releases the group's keys before it
destroys the group.

Threads: the keyframe graph's worker solves validation waves while the
tracker solves its matches, both on the device's default stream.
  * Each key's static buffers are held by its lock from the copy-in to the
    last read (``LevelGraphs.lock``).
  * Warm-ups and captures run under one module lock on one capture stream
    per device, in ``thread_local`` capture mode, so another thread's
    eager launches on the default stream neither join nor break a
    capture.  Replays are enqueued under the same lock, and every warm-up
    waits for the default stream before it starts and makes it wait after,
    so no replay runs beside a warm-up that shares the capture stream's
    ticket buffer or cuBLAS workspace.
  * Graphs replay on the device's default stream only (they share that
    ticket buffer): a call from another stream raises.

There is no fallback: a capture that fails raises, naming the op that
broke it.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# The cache's bound: the bytes that its keys' captures added to the reserved
# memory plus their static buffers.  A full driver run holds less (PERF.md,
# PR 11); the bound keeps a process that meets many shapes, stream counts or
# intrinsics from growing without end.
CACHE_BYTES = 4 << 30

_lock = threading.RLock()  # warm-ups, captures, replay enqueues, counts, the cache
_cache: "OrderedDict[tuple, LevelGraphs]" = OrderedDict()  # least recently used first
_evicted = [0]  # keys dropped to keep the cache within CACHE_BYTES
_capture_streams: Dict[int, torch.cuda.Stream] = {}
_generation = [0]  # process groups started by parallel.distributed.initialize


def new_generation():
    """A new process group was started: the keys ``group_key`` gives from
    now on differ from every earlier group's."""
    _generation[0] += 1


def group_key(group=None) -> tuple:
    """The part of a graph key that names a process group (None: the
    default group): its backend, size, rank and generation."""
    return ("group", str(dist.get_backend(group)), dist.get_world_size(group),
            dist.get_rank(group), _generation[0])


def graph_group(device, group=None, enabled: bool = True) -> Optional[tuple]:
    """How a loop with ``group``'s collectives runs on ``device``, chosen up
    front: as CUDA graphs on the card with graphs ``enabled`` over NCCL
    (then the group part of its keys, ``group_key``), else eagerly (None):
    on the CPU, with graphs off, or over gloo, whose collectives are host
    code that a graph cannot hold."""
    if torch.device(device).type != "cuda" or not enabled or dist.get_backend(group) != "nccl":
        return None
    return group_key(group)


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    stream = _capture_streams.get(device.index)
    if stream is None:
        stream = _capture_streams[device.index] = torch.cuda.Stream(device)
    return stream


def _read_counters(counters) -> list:
    return [getattr(obj, name) for obj, name in counters]


def _add_counters(counters, values):
    for (obj, name), value in zip(counters, values):
        if value:
            setattr(obj, name, getattr(obj, name) + value)


def _require_default_stream(device):
    if torch.cuda.current_stream(device) != torch.cuda.default_stream(device):
        raise RuntimeError(
            "the IRLS graphs replay on the device's default stream (they share its kernels' "
            "ticket buffer); call the tracker outside torch.cuda.stream(...)")


class LevelGraphs:
    """One key's static buffers and its head and tail graphs."""

    def __init__(self, key: tuple, device: torch.device):
        self.key = key
        self.device = device
        self.lock = threading.Lock()  # the static buffers, copy-in to last read
        self.drop()

    def drop(self):
        """Free the graphs, their pool and the static buffers (the caller
        holds ``lock`` and has synchronized the device); the next
        ``run_head`` captures anew."""
        self.inputs: Tuple[torch.Tensor, ...] = ()
        self.state: Tuple[torch.Tensor, ...] = ()
        self.head = self.tail = None
        self.deltas = ([], [])  # counter moves per replay: head, tail
        self.capture_ms = 0.0
        self.pool_bytes = 0  # reserved memory that the two captures added
        self.static_bytes = 0

    @property
    def nbytes(self) -> int:
        return self.pool_bytes + self.static_bytes

    def load(self, inputs: Sequence[torch.Tensor]):
        """Copy a level's inputs into the static input buffers."""
        if not self.inputs:
            self.inputs = tuple(torch.empty(t.shape, dtype=t.dtype, device=self.device)
                                for t in inputs)
            self.static_bytes += sum(t.numel() * t.element_size() for t in self.inputs)
        for buf, t in zip(self.inputs, inputs):
            buf.copy_(t)

    def run_head(self, program: Callable, counters) -> Tuple[torch.Tensor, ...]:
        """The level's first chunk: ``program(inputs, None)``; the first
        call of a key runs it eagerly and captures both graphs."""
        _require_default_stream(self.device)
        with _lock:
            if self.head is None:
                self._build(program, counters)
                _evict(keep=self)
            else:
                self.head.replay()
                _add_counters(counters, self.deltas[0])
        return self.state

    def run_tail(self, counters) -> Tuple[torch.Tensor, ...]:
        """One more chunk: ``program(inputs, state)``."""
        _require_default_stream(self.device)
        with _lock:
            self.tail.replay()
            _add_counters(counters, self.deltas[1])
        return self.state

    def _capture(self, graph, program, state, counters, pool=None):
        """Capture ``program(inputs, state)`` and the copy of its result
        into the state buffers; returns the counter moves of one replay."""
        before = _read_counters(counters)
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            out = program(self.inputs, state)
            for buf, t in zip(self.state, out):
                buf.copy_(t)
            del out
        except Exception as exc:
            try:
                graph.capture_end()
            except RuntimeError:
                pass  # the capture is void; the program's own error names the op
            loop = "CG" if self.key[1] == "cg" else "IRLS"
            raise RuntimeError(
                f"capturing the {loop} chunk as a CUDA graph failed (key {self.key}): {exc}"
            ) from exc
        graph.capture_end()
        after = _read_counters(counters)
        for (obj, name), value in zip(counters, before):
            setattr(obj, name, value)  # capture launched nothing
        return [a - b for a, b in zip(after, before)]

    def _build(self, program, counters):
        side = _capture_stream(self.device)
        default = torch.cuda.current_stream(self.device)
        side.wait_stream(default)
        with torch.cuda.stream(side):
            # the warm-up is the level's first chunk, counted as it launches
            out = program(self.inputs, None)
            self.state = tuple(torch.empty(t.shape, dtype=t.dtype, device=self.device)
                               for t in out)
            for buf, t in zip(self.state, out):
                buf.copy_(t)
            del out
            self.static_bytes += sum(t.numel() * t.element_size() for t in self.state)
            side.synchronize()
            reserved = torch.cuda.memory_reserved(self.device)
            t0 = time.perf_counter()
            head, tail = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
            head_delta = self._capture(head, program, None, counters)
            tail_delta = self._capture(tail, program, self.state, counters, pool=head.pool())
            self.capture_ms = 1000.0 * (time.perf_counter() - t0)
            self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        default.wait_stream(side)
        self.head, self.tail, self.deltas = head, tail, (head_delta, tail_delta)


def graphs_for(key: tuple, device: torch.device) -> LevelGraphs:
    """The cached ``LevelGraphs`` of ``key`` on ``device`` (made empty on
    first use; captured by its first ``run_head``), now the most recently
    used."""
    full = (device.index,) + key
    with _lock:
        graphs = _cache.get(full)
        if graphs is None:
            graphs = _cache[full] = LevelGraphs(full, device)
        _cache.move_to_end(full)
        return graphs


def _drop(victims):
    """Free keys taken out of the cache, each under its lock (held by the
    caller), after the devices finish what they have queued."""
    for index in {g.device.index for g in victims if g.device.type == "cuda"}:
        torch.cuda.synchronize(index)
    for g in victims:
        g.drop()


def _evict(keep: LevelGraphs):
    """Drop the least recently used keys, other than ``keep`` and those a
    thread is solving, until the cache is within ``CACHE_BYTES``."""
    total = sum(g.nbytes for g in _cache.values())
    victims = []
    for full, g in list(_cache.items()):
        if total <= CACHE_BYTES:
            break
        if g is keep or not g.lock.acquire(blocking=False):
            continue
        del _cache[full]
        total -= g.nbytes
        victims.append(g)
    try:
        _drop(victims)
    finally:
        for g in victims:
            g.lock.release()
    _evicted[0] += len(victims)


def release(where: Optional[Callable[[tuple], bool]] = None):
    """Drop every key, or those whose key (the caller's, without the
    device) ``where`` holds for: its graphs, their pool and its static
    buffers (each once no thread is solving it).  A later solve captures
    anew."""
    with _lock:
        graphs = [g for full, g in _cache.items() if where is None or where(full[1:])]
        for g in graphs:
            del _cache[g.key]
    for g in graphs:
        with g.lock:
            _drop([g])


def stats() -> dict:
    """What the process's graph cache holds: keys, graphs, capture ms,
    the captures' reserved memory and the static buffers' bytes, with the
    bound and the keys dropped to keep within it."""
    with _lock:
        built = [g for g in _cache.values() if g.head is not None]
        return {
            "keys": len(built),
            "graphs": 2 * len(built),
            "capture_ms": sum(g.capture_ms for g in built),
            "pool_bytes": sum(g.pool_bytes for g in built),
            "static_bytes": sum(g.static_bytes for g in built),
            "cache_bytes": CACHE_BYTES,
            "evicted": _evicted[0],
        }

