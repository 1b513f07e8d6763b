"""Phase timers with rolling means, and the program's span recorder.

The phase timers stand in for the reference's stopwatch/stopwatch_collection
(dvo_core/include/dvo/util/stopwatch.h:37-115: tick-count timers with a
rolling mean).  The phase taxonomy mirrors the reference's instrumentation
sites so numbers are comparable: per-frame ``match``/``callback``
(benchmark_slam.cpp:446,483), back-end ``constraint_search``/
``constraint_validation``/``constraint_insert``/``constraint_optimization``
(keyframe_graph.cpp:438-443).  They take host wall time, launches and
copies included.

The span recorder is off by default.  ``enable(device)`` turns it on for
the process; then each ``span(name)`` records its name, the span open
around it on this thread (its parent), the frame it belongs to (given by
the outermost span of a frame, ``models/frames.Frame.frame_id``, and
inherited by the spans inside it), its host start and end
(``time.perf_counter_ns``) and the name of the thread it ran on (the
SLAM back end's worker records beside the front end).  A span with
``device=True`` on a CUDA device also records a pair of timing events on
the current stream around its body (not while the stream is being
captured into a CUDA graph): an upper
bound on the device time of the work it enqueued, since the pair also
holds the launch latency where the stream was idle when it opened.  Only
a launch that returns before its work ends (a graph's) is timed so: on
an idle stream, a pair around many small launches times the host issuing
them.  The events are the port's own (``csrc/while_graph.cu``, through
``ctypes``: a record costs about a microsecond, a third of PyTorch's
``Event.record``), pooled and read back once the stream has passed them.
``drain()`` returns the finished spans whose events have completed, with
their device ms, and never synchronises.  Off, ``span`` returns one shared
null context: no allocation, no event.  Every span name starts with
``dvo.``.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
import time
from collections import deque
from typing import Dict, List, NamedTuple, Optional

import torch

# finished spans kept for ``drain`` (the oldest go first past it): a minute
# of frames at a few hundred frames a second
KEEP = 1 << 19


class Stopwatch:
    """Wall-clock timer with rolling statistics."""

    def __init__(self, name: str):
        self.name = name
        self.samples: List[float] = []
        self._start = None

    def start(self):
        self._start = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._start
        self.samples.append(dt)
        return dt

    @contextlib.contextmanager
    def timing(self):
        self.start()
        try:
            yield self
        finally:
            self.stop()

    @property
    def mean(self) -> float:
        return sum(self.samples) / len(self.samples) if self.samples else 0.0

    @property
    def total(self) -> float:
        return sum(self.samples)


class PhaseTimers:
    """Named stopwatch registry using the reference phase taxonomy."""

    PHASES = (
        "prepare",
        "match",
        "callback",
        "constraint_search",
        "constraint_validation",
        "constraint_insert",
        "constraint_optimization",
        "final_optimization",
    )

    def __init__(self):
        self._timers: Dict[str, Stopwatch] = {}

    def __getitem__(self, name: str) -> Stopwatch:
        if name not in self._timers:
            self._timers[name] = Stopwatch(name)
        return self._timers[name]

    def timing(self, name: str):
        return self[name].timing()

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "mean_ms": t.mean * 1000.0,
                "total_s": t.total,
                "count": len(t.samples),
            }
            for name, t in self._timers.items()
            if t.samples
        }


class Span(NamedTuple):
    """A finished span."""

    name: str
    parent: Optional[str]  # the span open around it on its thread
    frame: Optional[int]  # the frame it belongs to
    start_ns: int  # host clock, ``time.perf_counter_ns``
    end_ns: int
    device_ms: Optional[float]  # between its events; None without events
    thread: Optional[str] = None  # the name of the thread it ran on

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6


_NOT_READY = 600  # cudaErrorNotReady


@functools.lru_cache(maxsize=None)
def _event_library():
    """The port's CUDA library with the event functions' C signatures
    declared (built by nvcc at the first call in a process)."""
    from .. import _build

    lib = _build.load_library("while_graph").lib
    p = ctypes.c_void_p
    lib.dvo_event_create.argtypes = [ctypes.POINTER(p)]
    lib.dvo_event_record.argtypes = [p, p]
    lib.dvo_event_elapsed.argtypes = [p, p, ctypes.POINTER(ctypes.c_float)]
    lib.dvo_event_destroy.argtypes = [p]
    for name in ("dvo_event_create", "dvo_event_record", "dvo_event_elapsed",
                 "dvo_event_destroy"):
        getattr(lib, name).restype = ctypes.c_int
    return lib


def _check(code: int, what: str):
    if code:
        raise RuntimeError(f"{what} failed with CUDA error {code}")


class _Event:
    """A CUDA timing event (``cudaEventCreate``'s default: timing on)."""

    __slots__ = ("handle",)
    lib = None  # the port's CUDA library, loaded by the first event
    _ms = ctypes.c_float()  # ``since``'s result (read under the recorder's lock)

    def __init__(self):
        if _Event.lib is None:
            _Event.lib = _event_library()
        handle = ctypes.c_void_p()
        _check(self.lib.dvo_event_create(ctypes.byref(handle)), "cudaEventCreate")
        self.handle = handle

    def record(self, stream: int):
        code = self.lib.dvo_event_record(self.handle, stream)
        if code:
            _check(code, "cudaEventRecord")

    def since(self, start: "_Event") -> Optional[float]:
        """ms from ``start`` to this event; None until both have completed."""
        code = self.lib.dvo_event_elapsed(start.handle, self.handle, ctypes.byref(self._ms))
        if code == _NOT_READY:
            return None
        _check(code, "cudaEventElapsedTime")
        return self._ms.value

    def __del__(self):
        try:
            self.lib.dvo_event_destroy(self.handle)
        except (AttributeError, TypeError):  # the interpreter is shutting down
            pass


def _new_event():
    return _Event()


def _stream(device: torch.device) -> int:
    from .. import _build

    return _build.current_stream(device)


def _capturing() -> bool:
    return torch.cuda.is_current_stream_capturing()


class _Open:
    """A span being recorded (the context manager ``span`` returns when the
    recorder is on).  Its hot path builds no named tuple and takes no lock:
    ``drain`` makes the ``Span`` records."""

    __slots__ = ("rec", "name", "device", "frame", "parent", "events", "stream", "start_ns")

    def __init__(self, rec: "SpanRecorder", name: str, device: bool, frame: Optional[int]):
        self.rec, self.name, self.device, self.frame = rec, name, device, frame

    def __enter__(self):
        rec = self.rec
        stack = rec._stack()
        parent = self.parent = stack[-1] if stack else None
        if parent is None:
            if rec._pending:
                rec._collect(front_only=True)  # keep the event pool small
        elif self.frame is None:
            self.frame = parent.frame
        stack.append(self)
        self.events = None
        if self.device and rec.events and not _capturing():
            try:
                self.events = (rec._pool.pop(), rec._pool.pop())
            except IndexError:
                self.events = (_new_event(), _new_event())
            self.stream = _stream(rec.device)
            self.events[0].record(self.stream)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.perf_counter_ns()
        events = self.events
        if events is not None:
            events[1].record(self.stream)
        rec = self.rec
        local = rec._local
        local.stack.pop()
        parent = self.parent
        entry = (self.name, None if parent is None else parent.name, self.frame, self.start_ns,
                 end_ns)
        if events is None:
            rec._done.append(entry + (None, local.thread))
        else:
            rec._pending.append((entry + (local.thread,), events))
        return False


class SpanRecorder:
    """The process's spans: the open ones per thread, the finished ones
    whose events may not have completed (``pending``), the finished and
    completed ones (``done``, as ``Span`` fields) and a pool of timing
    events.  Threads append to the deques and pop the pool without a lock
    (each of those is atomic); one thread at a time collects."""

    def __init__(self):
        self.on = False
        self.events = False  # record device events (a CUDA device)
        self.device = torch.device("cpu")
        self._local = threading.local()
        self._lock = threading.Lock()
        self._pool: list = []
        self._pending: deque = deque()  # (Span fields without device_ms, (start, end) events)
        self._done: deque = deque(maxlen=KEEP)

    def enable(self, device):
        device = torch.device(device)
        self.events = device.type == "cuda"
        if self.events and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device()
                                  if torch.cuda.is_available() else 0)
        self.device = device
        self.on = True

    def disable(self):
        """Turn recording off and forget every recorded span."""
        self.on = False
        with self._lock:
            self._pending.clear()
            self._done.clear()
            self._pool.clear()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
            self._local.thread = threading.current_thread().name
        return stack

    def _collect(self, front_only: bool):
        """Move the pending spans whose end event has completed to ``done``
        with their device ms and pool their events; ``front_only`` stops at
        the first that has not (stream order)."""
        with self._lock:
            pending = self._pending
            for _ in range(len(pending)):
                item = pending.popleft()
                entry, (start, end) = item
                ms = end.since(start)
                if ms is None:
                    if front_only:
                        pending.appendleft(item)
                        return
                    pending.append(item)
                    continue
                self._done.append(entry[:-1] + (ms, entry[-1]))
                self._pool += (start, end)

    def drain(self) -> List[Span]:
        """The finished spans whose events have completed, in the order they
        completed; the others stay for the next call.  Never synchronises."""
        self._collect(front_only=False)
        with self._lock:
            out = [Span(*fields) for fields in self._done]
            self._done.clear()
        return out


_recorder = SpanRecorder()
_NULL = contextlib.nullcontext()


def enable(device):
    """Record spans from now on; with events on ``device``'s current stream
    where it is a CUDA device."""
    _recorder.enable(device)


def disable():
    _recorder.disable()


def enabled() -> bool:
    return _recorder.on


def span(name: str, device: bool = False, frame: Optional[int] = None):
    """A context manager that records the span ``name`` while the recorder
    is on (timing events around its body with ``device``; ``frame`` names
    the frame it belongs to, else its parent's), and does nothing while it
    is off."""
    if not _recorder.on:
        return _NULL
    return _Open(_recorder, name, device, frame)


def drain() -> List[Span]:
    return _recorder.drain()
