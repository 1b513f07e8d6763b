"""The card's idle share of the profiled slice (%): 1 - the union of its
kernels, copies and sets over the slice's wall time."""
from slam_bench.metrics_common import idle_pct


def read(run):
    return idle_pct(run)
