"""Arithmetic that several metric readers share."""

import math

import numpy as np

from slam_bench import trace


def latency_percentile(run, q: float):
    """Percentile ``q`` of (pose on the host - due time) in ms over every
    frame due in the window; a failed frame counts as never arriving."""
    if not run.frames:
        return None
    lat = [(f.end - f.due) * 1e3 if f.pose is not None else math.inf for f in run.frames]
    return float(np.percentile(lat, q))


def idle_pct(run):
    if run.trace is None:
        return None
    window = trace.window_s(run.trace)
    return 100.0 * (1.0 - trace.busy_s(run.trace) / window) if window > 0 else None
