"""ms per frame of the program's ``dvo.ingest`` span on the host
(``Frame.from_raw``: issuing the upload, the pyramid and the prepare, with
no synchronise inside it); the frames outside the profiled slice.  None
where the program records no span (``spans``)."""
import numpy as np

from slam_bench import spans

spans.arm()


def read(run):
    ms = [f.host_ms["dvo.ingest"] for f in spans.untraced(run) if "dvo.ingest" in f.host_ms]
    return float(np.mean(ms)) if ms else None
