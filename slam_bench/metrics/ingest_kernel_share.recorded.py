"""Share of the window's frames, outside the profiled slice, whose
``dvo.ingest`` span holds a ``dvo.ingest.kernel`` span: the raw frame became
its pyramid and prepared tables through the program's ingest kernels (one
staged copy and two launches, ``ops/ingest``) and not through the plain
chain of tensor ops.  None where the program records no span or has no
ingest kernels (no ``dvo_slam_tpu_torch.ops.ingest``).

The recorder is drained once a run, by ``spans`` in the odometry cell and by
``slam_spans`` in the SLAM cell, whichever reader comes first; this reader
takes the frames from the one that drained it."""
import importlib.util

from slam_bench import slam_spans, spans

spans.arm()


def _has_ingest_kernels() -> bool:
    return importlib.util.find_spec("dvo_slam_tpu_torch.ops.ingest") is not None


def _frames(run):
    for module in (spans, slam_spans):
        last = module._last["run"]
        if last is not None and last() is run:
            return module._last["frames"]
    return spans.frames(run)


def read(run):
    if not _has_ingest_kernels():
        return None
    frames = [f for f in _frames(run) if not f.record.traced and f.record.pose is not None
              and "dvo.ingest" in f.count]
    if not frames:
        return None
    return sum("dvo.ingest.kernel" in f.count for f in frames) / len(frames)
