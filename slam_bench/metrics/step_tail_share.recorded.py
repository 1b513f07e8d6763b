"""Share of the window's frames, outside the profiled slice, whose spans hold
a ``dvo.match.graph`` span, that also hold a ``dvo.match.fused_tail`` span:
the match graph's IRLS levels ran each step around the evaluation as the
program's step kernels (``ops/irls_step``: a head and a tail launch) and
not as a chain of captured tensor ops.  None where no such frame holds a
``dvo.match.graph`` span or the program has no step kernels (no
``dvo_slam_tpu_torch.ops.irls_step``).

The recorder is drained once a run, by ``spans`` in the odometry cell and by
``slam_spans`` in the SLAM cell, whichever reader comes first; this reader
takes the frames from the one that drained it."""
import importlib.util

from slam_bench import slam_spans, spans

spans.arm()


def _has_step_kernels() -> bool:
    return importlib.util.find_spec("dvo_slam_tpu_torch.ops.irls_step") is not None


def _frames(run):
    for module in (spans, slam_spans):
        last = module._last["run"]
        if last is not None and last() is run:
            return module._last["frames"]
    return spans.frames(run)


def read(run):
    if not _has_step_kernels():
        return None
    frames = [f for f in _frames(run) if not f.record.traced and f.record.pose is not None
              and "dvo.match.graph" in f.count]
    if not frames:
        return None
    return sum("dvo.match.fused_tail" in f.count for f in frames) / len(frames)
