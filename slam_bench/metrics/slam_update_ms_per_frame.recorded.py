"""ms per frame of the program's ``dvo.kf.update`` span on the host
(``KeyframeTracker.update``: the dual match, its wait for the card and
the keyframe decision, or a session's first match), over the window's
frames outside the profiled slice.  None where the program records no
such span (``slam_spans``)."""
import numpy as np

from slam_bench import slam_spans

slam_spans.arm()


def read(run):
    ms = [f.host_ms["dvo.kf.update"] for f in slam_spans.frames(run)
          if not f.record.traced and f.record.pose is not None and "dvo.kf.update" in f.host_ms]
    return float(np.mean(ms)) if ms else None
