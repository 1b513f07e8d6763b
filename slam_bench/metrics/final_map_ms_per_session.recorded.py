"""ms per session of the program's ``dvo.graph.final`` span: the final
pass from the worker queue's drain to the last pruning, over the sessions
that ended inside the window.  None where the program records no such
span or no session ended inside the window (``slam_spans``)."""
import numpy as np

from slam_bench import slam_spans

slam_spans.arm()


def read(run):
    ms = slam_spans.session_finals(run)
    return float(np.mean(ms)) if ms else None
