"""95th percentile of the service time (ms): from handing a frame to
``ingest`` until its pose is on the host, without the wait in the queue;
the frames outside the profiled slice."""
import numpy as np


def read(run):
    frames = run.untraced()
    return float(np.percentile([f.end - f.start for f in frames], 95)) * 1e3 if frames else None
