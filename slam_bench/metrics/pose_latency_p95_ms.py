"""95th percentile, over every frame due in the window, of the time from
the frame's due time until its pose is on the host (ms); a failed frame
never arrives."""
from slam_bench.metrics_common import latency_percentile


def read(run):
    return latency_percentile(run, 95)
