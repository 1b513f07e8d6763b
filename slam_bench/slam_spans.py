"""The SLAM path's spans (``dvo_slam_tpu_torch.utils.timers``) for the
``program_span`` readers of the keyframe-session cell: the front end's
``dvo.kf.update`` (around ``dvo.kf.dual_match`` and ``dvo.kf.decision``)
with the frame's id, and the back end's, recorded on its worker thread:
``dvo.graph.keyframe`` with its keyframe's frame id (around
``dvo.localmap.optimize``, ``dvo.graph.search``, each ``dvo.graph.wave``
and ``dvo.graph.optimize``), and ``dvo.graph.final``, a session's final
pass, with the id of the session's last frame, on the thread that ends the
session.

``frames(run)`` drains the recorder once a run, pairs the spans with the
window's frames as ``spans`` does (a worker span goes to its keyframe's
frame, a final pass to its session's last frame), prints ``spans``'s lines
(what was built inside the window among them) and, per SLAM span, its
count, host ms and threads; then turns the recorder off.  A program
without the recorder or these spans gives nothing, and the readers None.
"""

from __future__ import annotations

import sys
import weakref
from collections import defaultdict
from typing import List

from slam_bench import spans

SLAM_SPANS = ("dvo.kf.update", "dvo.kf.dual_match", "dvo.kf.decision", "dvo.localmap.optimize",
              "dvo.graph.keyframe", "dvo.graph.search", "dvo.graph.wave", "dvo.graph.optimize",
              "dvo.graph.final")

_last = {"run": None, "frames": []}

arm = spans.arm


def frames(run) -> List[spans.FrameSpans]:
    if _last["run"] is not None and _last["run"]() is run:
        return _last["frames"]
    timers = spans._timers()
    out = []
    if timers is not None and timers.enabled():
        drained = timers.drain()
        timers.disable()
        out = spans._pair(run, drained)
        spans._report(run, out)
        _report(out, drained)
    _last["run"], _last["frames"] = weakref.ref(run), out
    return out


def _report(out, drained):
    window = {f.record.k for f in out}
    threads = defaultdict(set)
    for s in drained:
        if s.name in SLAM_SPANS:
            threads[s.name].add(getattr(s, "thread", None) or "-")
    parts = []
    for name in SLAM_SPANS:
        ms = [f.host_ms[name] for f in out if name in f.host_ms]
        if ms:
            count = sum(f.count[name] for f in out if name in f.count)
            parts.append(f"{name} {count} spans {sum(ms):.4f} ms ({', '.join(sorted(threads[name]))})")
    if parts:
        print(f"slam_bench: SLAM spans over the window's {len(window)} frames (count, host ms, "
              "threads): " + "; ".join(parts), file=sys.stderr, flush=True)


def session_finals(run) -> List[float]:
    """Host ms of each session's final pass that ended inside the window:
    those paired with a window frame other than its last (the session open
    when the window closes ends after it, outside the timing)."""
    last = run.frames[-1] if run.frames else None
    return [f.host_ms["dvo.graph.final"] for f in frames(run)
            if "dvo.graph.final" in f.host_ms and f.record is not last]
