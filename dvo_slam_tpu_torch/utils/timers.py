"""Phase timers with rolling means (a copy of
``dvo_slam_tpu.utils.timers``: standard library only).

They stand in for the reference's stopwatch/stopwatch_collection
(dvo_core/include/dvo/util/stopwatch.h:37-115: tick-count timers with a
rolling mean printed every N samples).  The phase taxonomy mirrors the
reference's instrumentation sites so numbers are comparable: per-frame
``match``/``callback`` (benchmark_slam.cpp:446,483), back-end
``constraint_search``/``constraint_validation``/``constraint_insert``/
``constraint_optimization`` (keyframe_graph.cpp:438-443).

For device-side detail, wrap regions in ``torch.profiler``; these host
timers take wall time, launches and copies included.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List


class Stopwatch:
    """Wall-clock timer with rolling statistics."""

    def __init__(self, name: str, print_every: int = 0):
        self.name = name
        self.print_every = print_every
        self.samples: List[float] = []
        self._start = None

    def start(self):
        self._start = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._start
        self.samples.append(dt)
        if self.print_every and len(self.samples) % self.print_every == 0:
            print(f"[{self.name}] mean {self.mean * 1000:.2f} ms over {len(self.samples)}")
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

    def __init__(self, print_every: int = 0):
        self._timers: Dict[str, Stopwatch] = {}
        self.print_every = print_every

    def __getitem__(self, name: str) -> Stopwatch:
        if name not in self._timers:
            self._timers[name] = Stopwatch(name, self.print_every)
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
