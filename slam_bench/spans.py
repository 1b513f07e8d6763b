"""The program's own spans (``dvo_slam_tpu_torch.utils.timers``), per frame of
the window, for the readers of the ``program_span`` metrics.

The harness imports the per-layer readers only for a ``--trace 1`` run,
before the program's set-up.  Each span reader calls ``arm()`` as it is
imported: that turns the program's span recorder on (with timing events on
the card around each level's while-graph launch), where the program has
one, so the warm-up is recorded too and ``frames`` leaves it out.  A
program without a recorder records nothing, and the readers return None.
A ``--trace 0`` run imports no per-layer reader, so its window runs with
the recorder off.

``frames(run)`` drains the recorder once a run, after the window: every
frame's pose is on the host by then, so every event has completed.  It
pairs the window's frames with the program's: the window hands each frame
to ``make_frame_raw`` once, in order, after the warm-up, so the window's
frames are the last ``len(run.frames)`` frames (``Frame.frame_id``) that
have a ``dvo.ingest`` span.  Then it turns the recorder off.  Once a run it
prints on standard error what the program built inside the window (the
spans ``dvo.graph.capture``, ``.while_build`` and ``.evict`` of the
window's frames: a nonzero count is a stall that no metric shows), each
span's host ms a frame (and the event ms of those with events), and the
profiled slice's ``dvo.level.graph`` event ms beside the busy ms that
CUPTI recorded over the same frames.
"""

from __future__ import annotations

import sys
import weakref
from typing import Dict, List, NamedTuple

from slam_bench import program, trace

BUILDS = ("dvo.graph.capture", "dvo.graph.while_build", "dvo.graph.evict")


class FrameSpans(NamedTuple):
    record: object  # the harness's FrameRecord
    host_ms: Dict[str, float]  # each span name's host ms, summed over the frame
    device_ms: Dict[str, float]  # ... event ms, the spans with events only
    count: Dict[str, int]


_last = {"run": None, "frames": []}


def _timers():
    from dvo_slam_tpu_torch.utils import timers

    return timers if hasattr(timers, "enable") else None


def arm():
    """Turn the program's recorder on, where it has one and it is off."""
    timers = _timers()
    if timers is None or timers.enabled():
        return
    import torch

    timers.enable("cuda" if torch.cuda.is_available() else "cpu")


def _pair(run, spans) -> List[FrameSpans]:
    """The window's frames with the spans of each (``spans``: the drained
    ``timers.Span`` list), those that have any."""
    ids = sorted({s.frame for s in spans if s.name == "dvo.ingest" and s.frame is not None})
    n = min(len(ids), len(run.frames))
    by_id = {i: FrameSpans(f, {}, {}, {}) for i, f in zip(ids[len(ids) - n:],
                                                          run.frames[len(run.frames) - n:])}
    for s in spans:
        f = by_id.get(s.frame)
        if f is None:
            continue
        f.host_ms[s.name] = f.host_ms.get(s.name, 0.0) + s.host_ms
        f.count[s.name] = f.count.get(s.name, 0) + 1
        if s.device_ms is not None:
            f.device_ms[s.name] = f.device_ms.get(s.name, 0.0) + s.device_ms
    return list(by_id.values())


def frames(run) -> List[FrameSpans]:
    """``_pair(run, the drained spans)``, drained and reported once a run."""
    if _last["run"] is not None and _last["run"]() is run:
        return _last["frames"]
    timers = _timers()
    out = []
    if timers is not None and timers.enabled():
        out = _pair(run, timers.drain())
        timers.disable()
        _report(run, out)
    _last["run"], _last["frames"] = weakref.ref(run), out
    return out


def untraced(run) -> List[FrameSpans]:
    """The frames outside the profiled slice whose pose came back."""
    return [f for f in frames(run) if not f.record.traced and f.record.pose is not None]


def _report(run, out: List[FrameSpans]):
    built = {name: sum(f.count.get(name, 0) for f in out) for name in BUILDS}
    print("slam_bench: built inside the window (program spans over "
          f"{len(out)} frames): graph captures {built['dvo.graph.capture']}, while graphs "
          f"{built['dvo.graph.while_build']}, cache evictions {built['dvo.graph.evict']}",
          file=sys.stderr, flush=True)
    kept = [f for f in out if not f.record.traced and f.record.pose is not None]
    if kept:
        names = sorted({name for f in kept for name in f.host_ms})
        print("slam_bench: program spans, ms a frame over the frames outside the slice (host, "
              "events): " + ", ".join(
                  f"{name} {sum(f.host_ms.get(name, 0.0) for f in kept) / len(kept):.4f} "
                  + (f"{sum(f.device_ms.get(name, 0.0) for f in kept) / len(kept):.4f}"
                     if any(name in f.device_ms for f in kept) else "-")
                  for name in names), file=sys.stderr, flush=True)
    sliced = [f for f in out if f.record.traced]
    if run.trace is None or not sliced:
        return
    graph_ms = sum(f.device_ms.get("dvo.level.graph", 0.0) for f in sliced)
    kernel1 = trace.device_events(run.trace, program.KERNEL_NAMES[0]) + \
        trace.device_events(run.trace, program.KERNEL_NAMES[1])
    print(f"slam_bench: profiled slice, {len(sliced)} frames: dvo.level.graph event ms "
          f"{graph_ms:.4f}; CUPTI busy ms "
          f"{trace.busy_s(run.trace) * 1e3:.4f}, of it kernel 1 "
          f"{sum(ev.end - ev.start for ev in kernel1) * 1e-3:.4f}", file=sys.stderr, flush=True)

