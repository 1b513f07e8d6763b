"""The IRLS loop as CUDA graphs: the card's form of the reference's
device-resident ``lax.while_loop`` (``dvo_slam_tpu/models/dense_tracker.py``).

For each key (the backend, the inputs' shapes and types, K, the
configuration fields and intrinsics that a step bakes in) this module
captures two graphs over one set of static buffers:

  * the *head*: the level's initial carry from the static start values,
    then K steps, the first with ``first = True`` (iteration 0 is always
    the head's step 0, so the kernel's ``first`` launch argument stays a
    constant of the graph);
  * the *tail*: K steps from the carry buffers, ``first = False``.

Each graph's last ops copy the new state into the state buffers, so the
chunks chain.  A level copies its inputs into the static input buffers and
then runs in one of two forms:

  * the *while form* (``run_level``, every tracker level without a process
    group): one launch of a graph built by ``csrc/while_graph.cu`` from the
    two captures, head -> ``set_while`` -> WHILE { tail -> ``set_while`` },
    which loops on the card while a stream's ``done`` flag is false, so the
    level reads nothing back before the caller's clone;
  * the *host-polled form* (``run_head`` / ``run_tail``, the loops whose
    graphs hold NCCL collectives, and the comparison form): one replay per
    chunk, the caller reading the state buffers between replays.

Both forms share the captures (``keep_graph=True``): the while graph is
built at the first ``run_level`` of a key, the PyTorch graphs are
instantiated at the first replay.  The first use of a key runs its head
chunk eagerly on the capture stream (the warm-up: it settles the caching
allocator, cuBLAS and the kernels' ticket buffer of that stream outside
any capture), takes back the launch counts it moved, and captures; the
level itself then runs as every later call of the key does.

Launch counts: a capture launches nothing, so the counts that it moves
are taken back and added once per executed chunk instead: by the host per
replay, and on the card in the while form, where ``set_while`` counts the
heads and tail chunks it ran into the key's ``runs`` buffer.
``fold_counts()`` synchronizes and adds those into the Python counters; a
reader calls it before reading or resetting a count.

The cache is bounded (``CACHE_BYTES``, the captures' pools and the static
buffers of the keys it holds): past it, the least recently used keys that
no thread is solving are dropped (their counts kept for the next fold),
and a key that comes back is captured anew.  ``release()`` drops every
key, for a process that is done with the card, and ``release(where=...)``
the keys that match.  No tracker calls it: the cache serves every tracker
of the process, and the benchmark (``bench.py``) resets its SLAM between
timed runs, which would then capture every key again inside each run.

The same cache serves the multi-rank loops (the pixel-sharded IRLS level,
block-CG), whose graphs hold NCCL collectives: a captured collective keeps
its communicator baked in.  Their keys carry ``group_key(group)``: the
group's backend, size and rank, and the generation that each
``parallel.distributed.initialize`` starts (``new_generation``), so that a
group made after another never replays the other's graphs; and
``parallel.distributed.shutdown`` releases the group's keys before it
destroys the group.  They run host-polled.

Threads: the keyframe graph's worker solves validation waves while the
tracker solves its matches, both on the device's default stream.
  * Each key's static buffers are held by its lock from the copy-in to the
    caller's clone (``LevelGraphs.lock``).
  * Warm-ups and captures run under one module lock on one capture stream
    per device, in ``thread_local`` capture mode, so another thread's
    eager launches on the default stream neither join nor break a
    capture.  Launches and replays are enqueued under the same lock, and
    every warm-up waits for the default stream before it starts and makes
    it wait after, so no launch runs beside a warm-up that shares the
    capture stream's ticket buffer or cuBLAS workspace.
  * Graphs launch on the device's default stream only (they share that
    ticket buffer): a call from another stream raises.

There is no fallback: a capture that fails raises, naming the op that
broke it, and a while graph that CUDA refuses to build or launch raises
with CUDA's text, the key and the node types of the two captures.
"""

from __future__ import annotations

import ctypes
import functools
import threading
import time
import types
from collections import OrderedDict
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .. import _build

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
# the while form's counts: ``launches``, the while graphs launched (counted
# by the host), and ``set_while``, the runs of its kernel inside them
# (counted on the card, one per head and one per tail chunk; up to date
# after ``fold_counts``)
while_counts = types.SimpleNamespace(launches=0, set_while=0)
_dropped_tallies = []  # the tallies of dropped keys, until the next fold_counts


def new_generation():
    """A new process group was started: the keys ``group_key`` gives from
    now on differ from every earlier group's."""
    _generation[0] += 1


def group_key(group=None) -> tuple:
    """The part of a graph key that names a process group (None: the
    default group): its backend, size, rank and generation."""
    return ("group", str(dist.get_backend(group)), dist.get_world_size(group),
            dist.get_rank(group), _generation[0])


def has_group(key: tuple) -> bool:
    """Whether a graph key carries a process group (``group_key``): such a
    loop holds collectives and runs host-polled."""
    return any(isinstance(part, tuple) and part[:1] == ("group",) for part in key)


def graph_group(device, group=None, enabled: bool = True) -> Optional[tuple]:
    """How a loop with ``group``'s collectives runs on ``device``, chosen up
    front: as CUDA graphs on the card with graphs ``enabled`` over NCCL
    (then the group part of its keys, ``group_key``), else eagerly (None):
    on the CPU, with graphs off, or over gloo, whose collectives are host
    code that a graph cannot hold."""
    if torch.device(device).type != "cuda" or not enabled or dist.get_backend(group) != "nccl":
        return None
    return group_key(group)


# cudaGraphNodeType values (CUDA's driver_types.h), for the node census
NODE_TYPES = ("kernel", "memcpy", "memset", "host", "graph", "empty", "wait_event",
              "event_record", "ext_semaphore_signal", "ext_semaphore_wait", "mem_alloc",
              "mem_free", "batch_mem_op", "conditional")
_ERROR_TEXT = 512


@functools.lru_cache(maxsize=None)
def _while_library():
    """The built ``csrc/while_graph.cu`` with its C signatures declared
    (built by nvcc at the first call in a process)."""
    lib = _build.load_library("while_graph").lib
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dvo_while_graph_build.argtypes = [p, p, p, i, p, ctypes.POINTER(p), ctypes.c_char_p, i]
    lib.dvo_while_graph_launch.argtypes = [p, p]
    lib.dvo_while_graph_destroy.argtypes = [p]
    lib.dvo_graph_node_census.argtypes = [p, ctypes.POINTER(ctypes.c_int)]
    for name in ("dvo_while_graph_build", "dvo_while_graph_launch", "dvo_while_graph_destroy",
                 "dvo_graph_node_census"):
        getattr(lib, name).restype = i
    lib.dvo_cuda_error_text.argtypes = [i, ctypes.c_char_p, i]
    lib.dvo_cuda_error_text.restype = None
    return lib


def _cuda_error(code: int) -> str:
    text = ctypes.create_string_buffer(_ERROR_TEXT)
    _while_library().dvo_cuda_error_text(code, text, _ERROR_TEXT)
    return text.value.decode()


def build_while(head: "torch.cuda.CUDAGraph", tail: "torch.cuda.CUDAGraph",
                flags: torch.Tensor, runs: torch.Tensor) -> int:
    """The while graph (a cudaGraphExec_t) over two graphs captured with
    ``keep_graph=True``: head -> ``set_while`` -> WHILE { tail ->
    ``set_while`` }, looping while one of ``flags`` (bool, [B] or [], on the
    card) is false; ``set_while`` adds one to ``runs[0]`` after the head and
    to ``runs[1]`` after each tail (int64 [2] on the card).  Raises with
    CUDA's text where CUDA refuses the graph."""
    if flags.dtype != torch.bool or runs.dtype != torch.int64 or runs.numel() != 2:
        raise ValueError("build_while: flags must be bool and runs int64 [2]")
    exec_ = ctypes.c_void_p()
    err = ctypes.create_string_buffer(_ERROR_TEXT)
    code = _while_library().dvo_while_graph_build(
        head.raw_cuda_graph(), tail.raw_cuda_graph(), flags.data_ptr(), flags.numel(),
        runs.data_ptr(), ctypes.byref(exec_), err, _ERROR_TEXT)
    if code:
        raise RuntimeError(err.value.decode())
    return exec_.value


def launch_while(exec_: int, device: torch.device):
    """One launch of a while graph on ``device``'s current stream."""
    code = _while_library().dvo_while_graph_launch(exec_, _build.current_stream(device))
    if code:
        raise RuntimeError(_cuda_error(code))


def destroy_while(exec_: int):
    """Free a while graph (the device has finished its launches)."""
    _while_library().dvo_while_graph_destroy(exec_)


def node_census(graph: "torch.cuda.CUDAGraph") -> Dict[str, int]:
    """The nodes of a graph captured with ``keep_graph=True``, by type
    (child graphs' nodes counted too), the types it holds only."""
    counts = (ctypes.c_int * 16)()
    code = _while_library().dvo_graph_node_census(graph.raw_cuda_graph(), counts)
    if code:
        raise RuntimeError(f"counting a graph's nodes failed: {_cuda_error(code)}")
    names = NODE_TYPES + tuple(f"type_{k}" for k in range(len(NODE_TYPES), 16))
    return {name: n for name, n in zip(names, counts) if n}


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    stream = _capture_streams.get(device.index)
    if stream is None:
        stream = _capture_streams[device.index] = torch.cuda.Stream(device)
    return stream


def _read_counters(counters) -> list:
    return [getattr(obj, name) for obj, name in counters]


def _set_counters(counters, values):
    for (obj, name), value in zip(counters, values):
        setattr(obj, name, value)


def _add_counters(counters, values, times: int = 1):
    for (obj, name), value in zip(counters, values):
        if value and times:
            setattr(obj, name, getattr(obj, name) + value * times)


def _require_default_stream(device):
    if torch.cuda.current_stream(device) != torch.cuda.default_stream(device):
        raise RuntimeError(
            "the IRLS graphs launch on the device's default stream (they share its kernels' "
            "ticket buffer); call the tracker outside torch.cuda.stream(...)")


class LevelGraphs:
    """One key's static buffers, its head and tail graphs and, once a level
    has run in the while form, the while graph built from them."""

    def __init__(self, key: tuple, device: torch.device):
        self.key = key
        self.device = device
        self.lock = threading.Lock()  # the static buffers, copy-in to the caller's clone
        self.exec = None
        self.drop()

    def drop(self):
        """Free the graphs, their pool and the static buffers (the caller
        holds ``lock`` and has synchronized the device; it keeps the while
        graph's ``tally`` for the next fold); the next run captures anew."""
        if self.exec is not None:
            destroy_while(self.exec)
        self.exec = None  # the while graph (a cudaGraphExec_t)
        self.tally = None  # its chunk counts on the card (``_Tally``)
        self.counters = ()
        self.inputs: Tuple[torch.Tensor, ...] = ()
        self.state: Tuple[torch.Tensor, ...] = ()
        self.head = self.tail = None
        self.instantiated = False  # the PyTorch graphs, for replays
        self.deltas = ([], [])  # counter moves per chunk: head, tail
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

    def run_level(self, program: Callable, counters, done: int) -> Tuple[torch.Tensor, ...]:
        """The whole level in the while form: one launch of the while graph
        over ``program``'s head and tail, looping while a stream's flag in
        ``state[done]`` is false.  Reads nothing back; the launch counts
        reach ``counters`` through ``fold_counts``."""
        _require_default_stream(self.device)
        with _lock:
            if self.head is None:
                self._build(program, counters)
            if self.exec is None:
                self._build_while(done)
            try:
                launch_while(self.exec, self.device)
            except RuntimeError as exc:
                raise RuntimeError(f"launching the IRLS level's while graph failed (key "
                                   f"{self.key}): {exc}; nodes {self.census()}") from None
            while_counts.launches += 1
        return self.state

    def run_head(self, program: Callable, counters) -> Tuple[torch.Tensor, ...]:
        """The level's first chunk, host-polled: ``program(inputs, None)``,
        one replay (the first call of a key captures both graphs first)."""
        _require_default_stream(self.device)
        with _lock:
            if self.head is None:
                self._build(program, counters)
            if not self.instantiated:
                self.head.instantiate()
                self.tail.instantiate()
                self.instantiated = True
            self.head.replay()
            _add_counters(counters, self.deltas[0])
        return self.state

    def run_tail(self, counters) -> Tuple[torch.Tensor, ...]:
        """One more chunk, host-polled: ``program(inputs, state)``."""
        _require_default_stream(self.device)
        with _lock:
            self.tail.replay()
            _add_counters(counters, self.deltas[1])
        return self.state

    def census(self) -> Dict[str, Dict[str, int]]:
        """The node types of the two captures."""
        return {"head": node_census(self.head), "tail": node_census(self.tail)}

    def _capture(self, graph, program, state, counters, pool=None):
        """Capture ``program(inputs, state)`` and the copy of its result
        into the state buffers; returns the counter moves of one chunk."""
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
        _set_counters(counters, before)  # capture launched nothing
        return [a - b for a, b in zip(after, before)]

    def _build(self, program, counters):
        side = _capture_stream(self.device)
        default = torch.cuda.current_stream(self.device)
        side.wait_stream(default)
        before = _read_counters(counters)
        with torch.cuda.stream(side):
            out = program(self.inputs, None)  # the warm-up
            self.state = tuple(torch.empty(t.shape, dtype=t.dtype, device=self.device)
                               for t in out)
            for buf, t in zip(self.state, out):
                buf.copy_(t)
            del out
            _set_counters(counters, before)  # the level runs again below
            self.static_bytes += sum(t.numel() * t.element_size() for t in self.state)
            side.synchronize()
            reserved = torch.cuda.memory_reserved(self.device)
            t0 = time.perf_counter()
            head = torch.cuda.CUDAGraph(keep_graph=True)
            tail = torch.cuda.CUDAGraph(keep_graph=True)
            head_delta = self._capture(head, program, None, counters)
            tail_delta = self._capture(tail, program, self.state, counters, pool=head.pool())
            self.capture_ms = 1000.0 * (time.perf_counter() - t0)
            self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        default.wait_stream(side)
        self.head, self.tail, self.deltas = head, tail, (head_delta, tail_delta)
        self.counters = tuple(counters)
        _evict(keep=self)

    def _build_while(self, done: int):
        runs = torch.zeros(2, dtype=torch.int64, device=self.device)
        try:
            self.exec = build_while(self.head, self.tail, self.state[done], runs)
        except RuntimeError as exc:
            raise RuntimeError(f"building the IRLS level's while graph failed (key {self.key}): "
                               f"{exc}; nodes {self.census()}") from None
        self.tally = _Tally(runs, self.deltas, self.counters)
        self.static_bytes += runs.numel() * runs.element_size()


class _Tally:
    """A while graph's chunk counts on the card (``runs``: heads, tail
    chunks), what one chunk of each moves in the launch counters, and the
    part of the counts already added to them."""

    def __init__(self, runs: torch.Tensor, deltas, counters):
        self.runs, self.deltas, self.counters = runs, deltas, counters
        self.folded = (0, 0)

    def fold(self):
        """Add the chunks run since the last fold into the counters (the
        caller holds ``_lock`` and has synchronized the device)."""
        heads, tails = self.runs.tolist()
        new = (heads - self.folded[0], tails - self.folded[1])
        self.folded = (heads, tails)
        for delta, times in zip(self.deltas, new):
            _add_counters(self.counters, delta, times)
        while_counts.set_while += sum(new)


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
    caller), after the devices finish what they have queued.  Their while
    graphs' tallies wait for the next ``fold_counts``: a solve that drops
    keys to make room reads nothing back."""
    with _lock:
        _synchronize(victims)
        for g in victims:
            if g.tally is not None:
                _dropped_tallies.append(g.tally)
            g.drop()


def _synchronize(graphs):
    for index in {g.device.index for g in graphs if g.device.type == "cuda"}:
        torch.cuda.synchronize(index)


def fold_counts():
    """Bring the launch counters up to date: synchronize the devices of the
    keys that ran in the while form and add the chunks their while graphs
    ran since the last fold (what each chunk's capture moved, times the
    chunks), dropped keys' too.  A reader calls it before reading or
    resetting a count; it is a host read, so no tracker calls it."""
    with _lock:
        built = [g for g in _cache.values() if g.tally is not None]
        _synchronize(built)
        for tally in [g.tally for g in built] + _dropped_tallies:
            tally.fold()
        _dropped_tallies.clear()


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
    """What the process's graph cache holds: keys, captured graphs, while
    graphs built from them, capture ms, the captures' reserved memory and
    the static buffers' bytes, with the bound and the keys dropped to keep
    within it."""
    with _lock:
        built = [g for g in _cache.values() if g.head is not None]
        return {
            "keys": len(built),
            "graphs": 2 * len(built),
            "while_graphs": sum(g.exec is not None for g in built),
            "capture_ms": sum(g.capture_ms for g in built),
            "pool_bytes": sum(g.pool_bytes for g in built),
            "static_bytes": sum(g.static_bytes for g in built),
            "cache_bytes": CACHE_BYTES,
            "evicted": _evicted[0],
        }
