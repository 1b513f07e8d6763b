"""The traced slice of a run: ``torch.profiler`` over a bounded number of
frames, reduced to what the per-layer readers and the result's ``device``
and ``breakdown`` need.  The Chrome trace goes to a temporary file under
``TMPDIR`` and is deleted once read.

* device intervals: every ``kernel``, ``gpu_memcpy`` and ``gpu_memset``
  event (start, end in microseconds, name);
* the slice: the ``slam_bench.slice`` annotation around the profiled
  frames, whose length is ``window_s``;
* busy: the union of the device intervals inside the slice (``busy_s``);
* idle gaps: the stretches of the slice with no device interval, each
  named by the harness span and the innermost host operation running at
  its middle.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from collections import defaultdict
from typing import List, NamedTuple, Optional, Tuple

import torch

SLICE = "slam_bench.slice"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
BREAKDOWN_ENTRIES = 10


class Event(NamedTuple):
    name: str
    start: float  # microseconds
    end: float


class Trace(NamedTuple):
    device: List[Event]  # device intervals inside the slice, by start
    host: List[Event]  # host operations and annotations
    window: Tuple[float, float]  # the slice


def profiler():
    """The profiler of the slice.  One session a process: a second session
    on the card records no kernel that a CUDA graph launches, so the
    slice's own start pays CUPTI's start-up (seconds), outside the window's
    clock."""
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])


def read(prof) -> Optional[Trace]:
    """The stopped profiler's trace; None where the slice's annotation is
    missing."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    device, host, window = [], [], None
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        ev = Event(str(e.get("name", "")), float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        cat = e.get("cat", "")
        if cat in DEVICE_CATEGORIES:
            device.append(ev)
        elif cat in HOST_CATEGORIES:
            host.append(ev)
            if ev.name == SLICE:
                window = (ev.start, ev.end)
    if window is None:
        return None
    device = sorted((ev for ev in device if ev.end > window[0] and ev.start < window[1]),
                    key=lambda ev: ev.start)
    return Trace(device=device, host=host, window=window)


def merged(trace: Trace) -> List[Tuple[float, float]]:
    """The union of the device intervals, clipped to the slice."""
    lo, hi = trace.window
    out: List[List[float]] = []
    for ev in trace.device:
        s, e = max(ev.start, lo), min(ev.end, hi)
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def window_s(trace: Trace) -> float:
    return (trace.window[1] - trace.window[0]) * 1e-6


def busy_s(trace: Trace) -> float:
    return sum(e - s for s, e in merged(trace)) * 1e-6


def _host_at(trace: Trace, t: float) -> str:
    """The innermost harness span and host operation running at ``t``."""
    spans = [ev for ev in trace.host if ev.start <= t <= ev.end and ev.name != SLICE]
    ours = [ev for ev in spans if ev.name.startswith("slam_bench.")]
    ops = [ev for ev in spans if not ev.name.startswith("slam_bench.")]
    inner = lambda evs: min(evs, key=lambda ev: ev.end - ev.start).name if evs else "-"  # noqa: E731
    return f"{inner(ours)} > {inner(ops)}"


def breakdown(trace: Trace) -> dict:
    """The device operations that took most time and the longest idle gaps,
    ``BREAKDOWN_ENTRIES`` each, in seconds."""
    per_op = defaultdict(float)
    for ev in trace.device:
        per_op[ev.name[:160]] += (ev.end - ev.start) * 1e-6
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]
    lo, hi = trace.window
    edges = [lo] + [t for iv in merged(trace) for t in iv] + [hi]
    gaps = sorted(((edges[k + 1] - edges[k], edges[k]) for k in range(0, len(edges) - 1, 2)
                   if edges[k + 1] > edges[k]), reverse=True)[:BREAKDOWN_ENTRIES]
    return {"device_ops": [[name, seconds] for name, seconds in ops],
            "idle_gaps": [[_host_at(trace, start + length / 2), length * 1e-6]
                          for length, start in gaps]}


def device_events(trace: Trace, kernel: str) -> List[Event]:
    """Device events of the kernel named ``kernel`` (whatever its return
    type, namespace and template arguments)."""
    pattern = re.compile(r"(^|[\s:])" + re.escape(kernel) + r"[<(]")
    return [ev for ev in trace.device if pattern.search(ev.name)]
