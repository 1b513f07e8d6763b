"""The device loops as CUDA graphs: the card's form of the reference's
device-resident ``lax.while_loop`` (``dvo_slam_tpu/models/dense_tracker.py``
for the IRLS levels, ``models/pose_graph.py`` for block-CG).

For each key (the backend, the inputs' shapes and types, K, the
configuration fields and intrinsics that a step bakes in) this module
captures two graphs over one set of static buffers:

  * the *head*: the level's initial carry from the static start values,
    then K steps, the first with ``first = True`` (iteration 0 is always
    the head's step 0, so the kernel's ``first`` launch argument stays a
    constant of the graph);
  * the *tail*: K steps from the carry buffers, ``first = False``.

Each graph's last ops copy the new state into the state buffers, so the
chunks chain; a program that writes them in place copies nothing: a tail
that continues the state it was given, and a head that writes the state
buffers it is handed (``program(static, None, into=state)``; a program
may ignore ``into``).
This module owns how a device loop runs: ``loop_form`` chooses the form up
front, from the device, the switches ``CUDA_GRAPHS`` and ``WHILE_GRAPHS``
and the loop's process group, and ``run_loop`` runs a loop's chunk program
in it.  Eagerly, the chunks run on the caller's tensors with one host read
each; in the two graph forms a loop copies its inputs into the static
input buffers and then runs as:

  * the *while form* (``LevelGraphs.run_level``): one launch of a graph
    built by ``csrc/while_graph.cu`` from the two captures, head ->
    ``set_while`` -> WHILE { tail -> ``set_while`` }, which loops on the
    card while one of the state's flags has the loop's value (a stream's
    ``done`` false for the IRLS levels, ``active`` true for CG), so the
    loop reads nothing back before the caller's clone;
  * the *host-polled form* (``run_head`` / ``run_tail``: the comparison
    form, and the loops of a process group whose probe was refused): one
    replay per chunk, the runner reading the state buffers between
    replays.

Both forms share the captures (``keep_graph=True``): the while graph is
built at the first ``run_level`` of a key, the PyTorch graphs are
instantiated at the first replay.  The first use of a key runs its head
chunk eagerly on the capture stream (the warm-up: it settles the caching
allocator, cuBLAS and the kernels' ticket buffer of that stream outside
any capture), takes back the launch counts it moved, and captures; the
level itself then runs as every later call of the key does.

A whole tracker match takes the while form once more (``MatchGraph``, built
by ``csrc/while_graph.cu`` too): one graph holds a captured setup (the first
level's start values, written into its static start buffers), then for
each level its head -> ``set_while`` -> WHILE { tail -> ``set_while`` }
over that level key's captures and ``runs``, then a captured link that
writes the next level's start values into its static start buffers, and
after the last level a captured result (one flat row) and a copy of that
row to pinned host memory.  On the card each glue capture is one of the
glue kernels (``ops/match_glue``), which writes the static buffers in
place.  So a match is one launch and one host wait.  A match graph lives
as long as every one of its level keys: dropping or evicting a key
destroys the match graphs built on it.

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
block-CG over the ranks), whose graphs hold NCCL collectives: a captured
collective keeps its communicator baked in.  Their keys carry
``group_key(group)``: the group's backend, size and rank, and the
generation that each ``parallel.distributed.initialize`` starts
(``new_generation``), so that a group made after another never replays the
other's graphs; and ``parallel.distributed.shutdown`` releases the group's
keys before it destroys the group.  Their form is chosen once per group, up
front: ``initialize`` builds a probe on the group (``probe_group``: a while
graph whose body holds the group's all-reduces and kernel 2's clustered
launches) and records its form under the group's key (``group_forms``):
the while form where CUDA admitted and ran the probe, else host-polled,
with CUDA's refusal kept and reported by ``stats()``.  A group that
``initialize`` did not start has no probe and runs host-polled.

Threads: the keyframe graph's worker solves validation waves while the
tracker solves its matches, both on the device's default stream.
  * Each key's static buffers are held by its lock from the copy-in to the
    caller's clone (``LevelGraphs.lock``); a match graph holds the locks of
    all its levels, coarse to fine (``holding``), to the last read of its
    row.
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
with CUDA's text, the key and the node types of the two captures.  The one
choice made from what CUDA admits is the per-group form above, made once
when the group starts and reported.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
import time
import types
from collections import OrderedDict
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .. import _build
from ..utils import timers

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
# the match graphs' counts: ``launches``, the match graphs launched,
# ``per_level``, the matches on the card that ran level by level instead,
# and ``levels``, the level solves of both kinds of match
match_counts = types.SimpleNamespace(launches=0, per_level=0, levels=0)
_matches: "Dict[tuple, MatchGraph]" = {}  # (device index,) + match key -> its graph
_dropped_tallies = []  # the tallies of dropped keys, until the next fold_counts
_group_forms: "Dict[tuple, GroupForm]" = {}  # group_key -> the group's probed form

# Whether the card runs the device loops (a tracker or pixel-sharded IRLS
# level, block-CG) as CUDA graphs; off, it runs the same chunks eagerly (the
# graphs' reference in the checks).
CUDA_GRAPHS = True
# Whether a loop on the card runs as one while-graph launch; off, as
# host-polled chunk replays of the same graphs (the comparison form of the
# checks and probes).  A loop over a process group whose probe was refused
# replays host-polled either way.
WHILE_GRAPHS = True
# ``loop_form``'s group for collectives that name no process group
UNNAMED = object()


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
    loop holds that group's collectives."""
    return any(isinstance(part, tuple) and part[:1] == ("group",) for part in key)


class GroupForm(NamedTuple):
    """How the loops whose graphs hold a process group's collectives run on
    the card, as the group's probe found it (``probe_group``)."""

    form: str  # "while" where the probe was admitted and ran, else "polled"
    refusal: Optional[str]  # why not: CUDA's text, or the probe's mismatch
    census: Dict[str, Dict[str, int]]  # the probe's head and tail node types


def loop_form(device, group=()) -> Tuple[str, Optional[tuple]]:
    """How a device loop runs on ``device``, chosen up front, and the part
    of its graph keys that names its group.  ``group`` is the process group
    whose collectives the loop holds (None: the default group), ``()`` for
    a loop that holds none, or ``UNNAMED`` for collectives that name no
    group:

      * ("eager", None) on the CPU, with ``CUDA_GRAPHS`` off, or where the
        collectives are not an NCCL group's (gloo's are host code that a
        graph cannot hold);
      * ("while", part) with ``WHILE_GRAPHS`` on, where the loop holds no
        collective (part ``()``) or its group's probe was admitted (part
        ``group_key(group)``; ``group_forms``);
      * ("polled", part) everywhere else."""
    if torch.device(device).type != "cuda" or not CUDA_GRAPHS:
        return "eager", None
    if group == ():
        return ("while" if WHILE_GRAPHS else "polled"), ()
    if group is UNNAMED or dist.get_backend(group) != "nccl":
        return "eager", None
    part = group_key(group)
    probed = _group_forms.get(part)
    admitted = probed is not None and probed.form == "while"
    return ("while" if WHILE_GRAPHS and admitted else "polled"), part


def run_loop(form: str, program: Callable, inputs: Sequence[torch.Tensor], key: tuple,
             flag: int, read: Callable, counters=(), loop_on: bool = False,
             spans: bool = False) -> Tuple[torch.Tensor, ...]:
    """Run a device loop in ``form`` (``loop_form``) to its end and return
    its final state.  ``program(static, state, into=None)`` is one chunk
    over the loop's inputs, starting the loop where ``state`` is None (the
    head; a graph's head is handed its state buffers as ``into``, which it
    may write in place) and continuing it from ``state`` otherwise (the
    tail).  The loop goes on
    while the host read ``read(state)`` equals ``loop_on`` and, in the
    while form, while one of the flags in ``state[flag]`` does (a stream's
    ``done`` False, or CG's ``active`` True).

      * eager: the chunks on the caller's own ``inputs``, one read each;
      * polled: ``key``'s ``LevelGraphs`` over static copies of ``inputs``,
        a replay of the head, then of the tail, with a read after each;
      * while: the same graphs as one while-graph launch, reading nothing.

    The graph forms return a clone of the state buffers, made under the
    key's lock; with ``spans`` they open ``dvo.level.copy_in``, ``.graph``
    (with timing events) and ``.out`` around the load, the run and the
    clone.  ``counters`` are the (object, attribute) launch counts that a
    chunk moves (``LevelGraphs.run_level``)."""
    if form == "eager":
        state = program(inputs, None)
        while read(state) == loop_on:
            state = program(inputs, state)
        return state
    span = timers.span if spans else (lambda name, device=False: contextlib.nullcontext())
    graphs = graphs_for(key, inputs[0].device)
    with graphs.lock:
        with span("dvo.level.copy_in"):
            graphs.load(inputs)
        with span("dvo.level.graph", device=True):
            if form == "while":
                state = graphs.run_level(program, counters, flag, loop_on)
            else:
                state = graphs.run_head(program, counters)
                while read(state) == loop_on:
                    state = graphs.run_tail(counters)
        with span("dvo.level.out"):
            return tuple(t.clone() for t in state)


def group_forms() -> Dict[tuple, GroupForm]:
    """The probed form of each process group (by ``group_key``)."""
    with _lock:
        return dict(_group_forms)


def forget_group(part: tuple):
    """Drop a destroyed group's probed form."""
    with _lock:
        _group_forms.pop(part, None)


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
    lib.dvo_while_graph_build.argtypes = [p, p, p, i, i, p, ctypes.POINTER(p), ctypes.c_char_p, i]
    pp = ctypes.POINTER(p)
    lib.dvo_match_graph_build.argtypes = [i, p, pp, pp, pp, i, pp, pp, p, p, p, ctypes.c_longlong,
                                          pp, ctypes.c_char_p, i]
    lib.dvo_while_graph_launch.argtypes = [p, p]
    lib.dvo_while_graph_destroy.argtypes = [p]
    lib.dvo_graph_node_census.argtypes = [p, ctypes.POINTER(ctypes.c_int)]
    for name in ("dvo_while_graph_build", "dvo_match_graph_build", "dvo_while_graph_launch",
                 "dvo_while_graph_destroy", "dvo_graph_node_census"):
        getattr(lib, name).restype = i
    lib.dvo_cuda_error_text.argtypes = [i, ctypes.c_char_p, i]
    lib.dvo_cuda_error_text.restype = None
    return lib


def _cuda_error(code: int) -> str:
    text = ctypes.create_string_buffer(_ERROR_TEXT)
    _while_library().dvo_cuda_error_text(code, text, _ERROR_TEXT)
    return text.value.decode()


def build_while(head: "torch.cuda.CUDAGraph", tail: "torch.cuda.CUDAGraph",
                flags: torch.Tensor, runs: torch.Tensor, loop_on: bool = False) -> int:
    """The while graph (a cudaGraphExec_t) over two graphs captured with
    ``keep_graph=True``: head -> ``set_while`` -> WHILE { tail ->
    ``set_while`` }, looping while one of ``flags`` (bool, [B] or [], on the
    card) equals ``loop_on`` (False: while a stream is not done; True:
    while CG is active); ``set_while`` adds one to ``runs[0]`` after the
    head and to ``runs[1]`` after each tail (int64 [2] on the card).
    Raises with CUDA's text where CUDA refuses the graph."""
    if flags.dtype != torch.bool or runs.dtype != torch.int64 or runs.numel() != 2:
        raise ValueError("build_while: flags must be bool and runs int64 [2]")
    exec_ = ctypes.c_void_p()
    err = ctypes.create_string_buffer(_ERROR_TEXT)
    code = _while_library().dvo_while_graph_build(
        head.raw_cuda_graph(), tail.raw_cuda_graph(), flags.data_ptr(), flags.numel(),
        int(bool(loop_on)), runs.data_ptr(), ctypes.byref(exec_), err, _ERROR_TEXT)
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
        self.matches = set()  # the match graphs built on this key
        self.drop()

    def drop(self):
        """Free the graphs, their pool and the static buffers, and the
        match graphs built on them (the caller holds ``lock`` and
        ``_lock`` and has synchronized the device; it keeps the ``tally``
        for the next fold); the next run captures anew."""
        for match in list(self.matches):
            match.drop()
        if self.exec is not None:
            destroy_while(self.exec)
        self.exec = None  # the while graph (a cudaGraphExec_t)
        self.tally = None  # the chunk counts on the card of its while loops (``_Tally``)
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

    @property
    def loop(self) -> str:
        """The loop's name in messages."""
        return "CG loop" if self.key[1] == "cg" else "IRLS level"

    def run_level(self, program: Callable, counters, flag: int,
                  loop_on: bool = False) -> Tuple[torch.Tensor, ...]:
        """The whole loop in the while form: one launch of the while graph
        over ``program``'s head and tail, looping while one of the flags in
        ``state[flag]`` equals ``loop_on`` (a stream's ``done`` false, or
        CG's ``active`` true).  Reads nothing back; the launch counts reach
        ``counters`` through ``fold_counts``."""
        _require_default_stream(self.device)
        with _lock:
            if self.head is None:
                with timers.span("dvo.graph.capture"):
                    self._build(program, counters)
            if self.exec is None:
                with timers.span("dvo.graph.while_build"):
                    self._build_while(flag, loop_on)
            try:
                launch_while(self.exec, self.device)
            except RuntimeError as exc:
                raise RuntimeError(f"launching the {self.loop}'s while graph failed (key "
                                   f"{self.key}): {exc}; nodes {self.census()}") from None
            while_counts.launches += 1
        return self.state

    def run_head(self, program: Callable, counters) -> Tuple[torch.Tensor, ...]:
        """The level's first chunk, host-polled: ``program(inputs, None)``,
        one replay (the first call of a key captures both graphs first)."""
        _require_default_stream(self.device)
        with _lock:
            if self.head is None:
                with timers.span("dvo.graph.capture"):
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
        """Capture ``program(inputs, state)`` (a head's with ``into`` the
        state buffers) and the copy of its result into the state buffers;
        returns the counter moves of one chunk."""
        before = _read_counters(counters)
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            out = program(self.inputs, state, into=self.state if state is None else None)
            for buf, t in zip(self.state, out):
                if t is not buf:  # a program may write the state buffers in place
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

    def runs(self) -> torch.Tensor:
        """The key's run counters on the card (heads, tail chunks), which
        ``set_while`` adds to in its while graph and in every match graph
        built on it; made with the key's ``tally`` at first use."""
        if self.tally is None:
            runs = torch.zeros(2, dtype=torch.int64, device=self.device)
            self.tally = _Tally(runs, self.deltas, self.counters)
            self.static_bytes += runs.numel() * runs.element_size()
        return self.tally.runs

    def _build_while(self, flag: int, loop_on: bool):
        try:
            self.exec = build_while(self.head, self.tail, self.state[flag], self.runs(), loop_on)
        except RuntimeError as exc:
            raise RuntimeError(f"building the {self.loop}'s while graph failed (key {self.key}): "
                               f"{exc}; nodes {self.census()}") from None


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


def _capture_glue(graph, fn: Callable, pool=None):
    """Capture ``fn()``, which writes a match graph's static buffers; a
    failure raises, naming the op."""
    graph.capture_begin(pool=pool, capture_error_mode="thread_local")
    try:
        fn()
    except Exception as exc:
        try:
            graph.capture_end()
        except RuntimeError:
            pass  # the capture is void; the program's own error names the op
        raise RuntimeError(f"capturing a match graph's glue failed: {exc}") from exc
    graph.capture_end()


class MatchGraph:
    """One match key's graph over its levels' ``LevelGraphs`` (coarse to
    fine): a captured setup, each level's while loop, a captured link
    between two levels, a captured result row and its copy to pinned host
    memory, as one launch (``csrc/while_graph.cu``).  Its static buffers:
    ``init`` (the warm start, or None), ``row`` (the result on the card),
    ``host`` (its pinned copy) and ``staging`` (a pinned warm start on its
    way to ``init``).  The caller holds every level's lock from the loads to
    the last read of ``row`` or ``host``.  The glue captures' launch counts
    are added once per launch (``glue_deltas``)."""

    def __init__(self, key: tuple, device: torch.device, levels: Sequence[LevelGraphs]):
        self.key, self.device, self.levels = key, device, tuple(levels)
        self.exec = None
        self.captures = ()  # setup, links, result (kept: the graph reads their pool)
        self.init = self.staging = self.row = self.host = None
        self.staged = self.fetched = None  # events: the warm start's copy, the row's
        self.counters, self.glue_deltas = (), []
        self.nbytes = 0

    def build(self, frame_inputs, initial: Optional[torch.Tensor], setup: Callable,
              programs: Sequence[Callable], link: Callable, result: Callable, counters,
              flag: int):
        """Warm up and capture, in the order the graph runs them, then build
        the graph.  ``frame_inputs[l]`` are level l's per-frame inputs (its
        static buffers then add the four start values); ``initial`` the warm
        start on the card or None; ``setup(init, out=None)``, the first
        level's start values from the ``init`` buffer; ``programs[l]``
        level l's chunk (``LevelGraphs.run_level``'s); ``link(state,
        out=None)``, the next level's start values from a level's state;
        ``result(states, inputs, out=None)`` the flat result from the
        levels' states and static inputs; each of the three writes ``out``
        (static buffers) in place where it is given (the captures), else
        new tensors (the warm-up); ``state[flag]`` a level's ``done``
        flags.  A refused build raises with CUDA's text."""
        with _lock:
            self._build(frame_inputs, initial, setup, programs, link, result, counters, flag)

    def _build(self, frame_inputs, initial, setup, programs, link, result, counters, flag):
        _require_default_stream(self.device)
        side = _capture_stream(self.device)
        default = torch.cuda.current_stream(self.device)
        saved = _read_counters(counters)
        with timers.span("dvo.graph.capture"):
            side.wait_stream(default)
            with torch.cuda.stream(side):
                if initial is not None:
                    self.init = torch.empty_like(initial)
                    self.init.copy_(initial)
                start = setup(self.init)
            for level, (graphs, inputs) in enumerate(zip(self.levels, frame_inputs)):
                with torch.cuda.stream(side):
                    graphs.load(tuple(inputs) + tuple(start))
                if graphs.head is None:
                    graphs._build(programs[level], counters)
                    side.wait_stream(default)
                with torch.cuda.stream(side):
                    if level + 1 < len(self.levels):
                        start = link(graphs.state)
                    else:
                        out = result([g.state for g in self.levels],
                                     [g.inputs for g in self.levels])
                        self.row = torch.empty_like(out)
                        del out
            with torch.cuda.stream(side):
                side.synchronize()
                reserved = torch.cuda.memory_reserved(self.device)
                before = _read_counters(counters)
                setup_graph = torch.cuda.CUDAGraph(keep_graph=True)
                starts = [g.inputs[-4:] for g in self.levels]
                _capture_glue(setup_graph, lambda: setup(self.init, starts[0]))
                pool = setup_graph.pool()
                links = []
                for level in range(len(self.levels) - 1):
                    links.append(torch.cuda.CUDAGraph(keep_graph=True))
                    _capture_glue(links[-1], functools.partial(
                        link, self.levels[level].state, starts[level + 1]), pool)
                result_graph = torch.cuda.CUDAGraph(keep_graph=True)
                _capture_glue(result_graph, lambda: result(
                    [g.state for g in self.levels], [g.inputs for g in self.levels], self.row),
                    pool)
                glue = [a - b for a, b in zip(_read_counters(counters), before)]
                pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
            default.wait_stream(side)
        _set_counters(counters, saved)  # the launches add the glue's counts
        self.counters, self.glue_deltas = tuple(counters), glue
        self.captures = (setup_graph, *links, result_graph)
        self.host = torch.empty(self.row.shape, dtype=self.row.dtype, pin_memory=True)
        if self.init is not None:
            self.staging = torch.empty(self.init.shape, dtype=self.init.dtype, pin_memory=True)
        self.staged, self.fetched = torch.cuda.Event(), torch.cuda.Event()
        with timers.span("dvo.graph.while_build"):
            try:
                self._build_graph(flag)
            except RuntimeError:
                self.drop()
                raise
        self.nbytes = pool_bytes + sum(t.numel() * t.element_size() for t in (
            self.init, self.row) if t is not None)
        for graphs in self.levels:
            graphs.matches.add(self)

    def _build_graph(self, flag: int):
        levels = len(self.levels)
        p = ctypes.c_void_p

        def pointers(values):
            return (p * max(levels, 1))(*values)

        heads = pointers(g.head.raw_cuda_graph() for g in self.levels)
        tails = pointers(g.tail.raw_cuda_graph() for g in self.levels)
        dones = pointers(g.state[flag].data_ptr() for g in self.levels)
        runs = pointers(g.runs().data_ptr() for g in self.levels)
        links = pointers(c.raw_cuda_graph() for c in self.captures[1:-1])
        batch = self.levels[0].state[flag].numel()
        exec_ = ctypes.c_void_p()
        err = ctypes.create_string_buffer(_ERROR_TEXT)
        code = _while_library().dvo_match_graph_build(
            levels, self.captures[0].raw_cuda_graph(), heads, tails, dones, batch, runs, links,
            self.captures[-1].raw_cuda_graph(), self.row.data_ptr(), self.host.data_ptr(),
            self.row.numel() * self.row.element_size(), ctypes.byref(exec_), err, _ERROR_TEXT)
        if code:
            raise RuntimeError(f"building the match graph of {levels} IRLS levels failed (key "
                               f"{self.key}): {err.value.decode()}; level nodes "
                               f"{[g.census() for g in self.levels]}")
        self.exec = exec_.value

    def load_initial(self, initial):
        """Copy the warm start into ``init``: on the card, a device copy;
        from the host, through the pinned ``staging`` buffer once its last
        copy has left it."""
        if isinstance(initial, torch.Tensor) and initial.device == self.device:
            self.init.copy_(initial)
            return
        self.staged.synchronize()
        self.staging.copy_(torch.as_tensor(initial))
        self.init.copy_(self.staging, non_blocking=True)
        self.staged.record()

    def launch(self):
        """One launch of the match; ``fetched`` records when ``host`` holds
        the row.  Counts one while-loop launch per level."""
        _require_default_stream(self.device)
        with _lock:
            try:
                launch_while(self.exec, self.device)
            except RuntimeError as exc:
                raise RuntimeError(f"launching the match graph failed (key {self.key}): "
                                   f"{exc}") from None
            self.fetched.record()
            match_counts.launches += 1
            match_counts.levels += len(self.levels)
            while_counts.launches += len(self.levels)
            _add_counters(self.counters, self.glue_deltas)

    def census(self) -> Dict[str, Dict[str, int]]:
        """The node types of the graph's parts outside its levels' loops:
        ``glue`` (the setup, link and result captures, and the row's copy
        to the host) and of each part alone (``setup``, ``link_<l>``,
        ``result``); the levels' own are their ``LevelGraphs.census``."""
        setup, *links, result = self.captures
        parts = {"setup": node_census(setup), "result": node_census(result)}
        parts.update({f"link_{l}": node_census(c) for l, c in enumerate(links)})
        glue = {"memcpy": 1}
        for part in parts.values():
            for kind, n in part.items():
                glue[kind] = glue.get(kind, 0) + n
        return {"glue": glue, **parts}

    def host_row(self):
        """The result row as a NumPy array of its own (waits for the copy)."""
        self.fetched.synchronize()
        return self.host.numpy().copy()

    def drop(self):
        """Free the graph and its captures (the device has finished with
        them; the caller holds ``_lock``)."""
        if self.exec is not None:
            destroy_while(self.exec)
        self.exec = None
        self.captures = ()
        self.init = self.staging = self.row = self.host = None
        for graphs in self.levels:
            graphs.matches.discard(self)
        full = (self.device.index,) + self.key
        if _matches.get(full) is self:
            del _matches[full]


def match_graph_for(key: tuple, device: torch.device, levels: Sequence[LevelGraphs]) -> MatchGraph:
    """The ``MatchGraph`` of ``key`` over ``levels`` (made empty on first
    use: ``build`` it), whose locks the caller holds."""
    full = (device.index,) + key
    with _lock:
        match = _matches.get(full)
        if match is None or match.levels != tuple(levels):
            if match is not None:
                torch.cuda.synchronize(device)
                match.drop()
            match = _matches[full] = MatchGraph(key, device, levels)
        return match


@contextlib.contextmanager
def holding(levels: Sequence[LevelGraphs]):
    """Hold the locks of a match's levels, in their order (coarse to fine:
    every match orders the keys it shares with another alike)."""
    with contextlib.ExitStack() as stack:
        for graphs in levels:
            stack.enter_context(graphs.lock)
        yield


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
    total = sum(g.nbytes for g in _cache.values()) + sum(m.nbytes for m in _matches.values())
    victims = []
    for full, g in list(_cache.items()):
        if total <= CACHE_BYTES:
            break
        if g is keep or not g.lock.acquire(blocking=False):
            continue
        del _cache[full]
        total -= g.nbytes
        victims.append(g)
    if not victims:
        return
    try:
        with timers.span("dvo.graph.evict"):
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


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two tensors hold the same bits (NaNs by their bits)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        view = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        a, b = a.contiguous().view(view), b.contiguous().view(view)
    return torch.equal(a, b)


def _all_ranks(ok: bool, group, device) -> bool:
    """Whether ``ok`` holds on every rank of ``group`` (an eager all-reduce)."""
    flag = torch.full((1,), int(ok), dtype=torch.int32, device=device)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=group)
    return bool(flag.item())


def probe_group(device, program: Callable, inputs: Sequence[torch.Tensor], flag: int,
                tail_chunks: int, counters=(), group=None) -> GroupForm:
    """Choose, once per process group, the form of the loops whose graphs
    hold its collectives (``parallel.distributed.initialize`` calls it when
    the group starts).  Builds a while graph of ``program`` on ``device``
    (its head and tail over static copies of ``inputs``, holding the
    group's collectives; ``state[flag]`` is a ``done`` flag that ends the
    loop after ``tail_chunks`` tail chunks), launches it, and holds it to
    the same chunks run eagerly: the tail chunks ``set_while`` counted, and
    every state tensor bit-equal.  Every rank of the group calls it, and
    the ranks agree on each verdict (an eager all-reduce) before any of
    them launches, so that they all take one form.  Records and returns
    the ``GroupForm``: "while" where the probe was admitted and agreed,
    else "polled" with CUDA's text (or the mismatch), and the captures'
    node census.  The probe's launches are taken back from ``counters``."""
    device = torch.device(device)
    part = group_key(group)
    saved = _read_counters(counters), (while_counts.launches, while_counts.set_while)
    graphs = LevelGraphs((device.index, "probe", part), device)
    refusal, census = None, {}
    with graphs.lock:
        graphs.load(inputs)
        try:
            with _lock:
                graphs._build(program, counters)
                census = graphs.census()
                graphs._build_while(flag, False)
        except RuntimeError as exc:
            refusal = str(exc)
        if not _all_ranks(refusal is None, group, device):
            refusal = refusal or "another rank's probe was refused"
        if refusal is None:
            got = tuple(t.clone() for t in graphs.run_level(program, counters, flag))
            heads, tails = graphs.tally.runs.tolist()
            want = program(graphs.inputs, None)
            for _ in range(tail_chunks):
                want = program(graphs.inputs, want)
            if (heads, tails) != (1, tail_chunks) or not all(
                    _same_bits(a, b) for a, b in zip(got, want)):
                refusal = (f"the probe's while graph ran {heads} head and {tails} tail chunks "
                           f"(expected 1 and {tail_chunks}) or its state differs from the "
                           f"same chunks run eagerly")
            if not _all_ranks(refusal is None, group, device):
                refusal = refusal or "another rank's probe disagreed with its eager run"
        torch.cuda.synchronize(device)
        graphs.tally = None  # the probe's launches are not the loops' launches
        graphs.drop()
    _set_counters(counters, saved[0])
    while_counts.launches, while_counts.set_while = saved[1]
    form = GroupForm("while" if refusal is None else "polled", refusal, census)
    with _lock:
        _group_forms[part] = form
    return form


def stats() -> dict:
    """What the process's graph cache holds: keys, captured graphs, while
    graphs and match graphs built from them, capture ms, the captures'
    reserved memory and the static buffers' bytes, with the bound and the
    keys dropped to keep within it; the match graphs launched and the
    matches on the card that ran level by level (``match_counts``); and the
    form of each process group's loops
    (``group_forms``: "while", or "polled" with the reason).  The spans
    ``dvo.graph.capture``, ``.while_build`` and ``.evict`` say when a key
    was made or dropped."""
    with _lock:
        built = [g for g in _cache.values() if g.head is not None]
        return {
            "keys": len(built),
            "graphs": 2 * len(built),
            "while_graphs": sum(g.exec is not None for g in built),
            "match_graphs": sum(m.exec is not None for m in _matches.values()),
            "match_graph_launches": match_counts.launches,
            "per_level_matches": match_counts.per_level,
            "capture_ms": sum(g.capture_ms for g in built),
            "pool_bytes": sum(g.pool_bytes for g in built),
            "static_bytes": sum(g.static_bytes for g in built),
            "cache_bytes": CACHE_BYTES,
            "evicted": _evicted[0],
            "group_forms": {repr(part): form.form if form.refusal is None
                            else f"{form.form}: {form.refusal}"
                            for part, form in _group_forms.items()},
        }
