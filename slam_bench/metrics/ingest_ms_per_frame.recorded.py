"""ms per frame in ``ingest`` (the program's ``make_frame_raw``: upload,
pyramid, prepare), the span synchronised with the card on both sides; the
frames outside the profiled slice."""
import numpy as np


def read(run):
    frames = run.untraced()
    return float(np.mean([f.ingested - f.start for f in frames])) * 1e3 if frames else None
