"""ms per keyframe of the program's ``dvo.graph.keyframe`` span on the
back end's worker thread: one keyframe's insertion (its local map's
optimisation among it), candidate search, validation wave and
optimisation, over the keyframes of the window's frames outside the
profiled slice.  None where the program records no such span
(``slam_spans``)."""
import numpy as np

from slam_bench import slam_spans

slam_spans.arm()


def read(run):
    ms = [f.host_ms["dvo.graph.keyframe"] for f in slam_spans.frames(run)
          if not f.record.traced and "dvo.graph.keyframe" in f.host_ms]
    return float(np.mean(ms)) if ms else None
