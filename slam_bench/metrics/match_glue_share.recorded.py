"""Share of the window's frames, outside the profiled slice, whose spans hold
a ``dvo.match.graph`` span, that also hold a ``dvo.match.glue_kernels``
span: the match graph's setup, links between levels and result row ran as
the program's glue kernels (``ops/match_glue``: one kernel node each) and
not as chains of captured tensor ops.  None where no such frame holds a
``dvo.match.graph`` span or the program has no glue kernels (no
``dvo_slam_tpu_torch.ops.match_glue``).

The recorder is drained once a run, by ``spans`` in the odometry and rig
cells and by ``slam_spans`` in the SLAM cell, whichever reader comes first;
this reader takes the frames from the one that drained it."""
import importlib.util

from slam_bench import slam_spans, spans

spans.arm()


def _has_glue_kernels() -> bool:
    return importlib.util.find_spec("dvo_slam_tpu_torch.ops.match_glue") is not None


def _frames(run):
    for module in (spans, slam_spans):
        last = module._last["run"]
        if last is not None and last() is run:
            return module._last["frames"]
    return spans.frames(run)


def read(run):
    if not _has_glue_kernels():
        return None
    frames = [f for f in _frames(run) if not f.record.traced and f.record.pose is not None
              and "dvo.match.graph" in f.count]
    if not frames:
        return None
    return sum("dvo.match.glue_kernels" in f.count for f in frames) / len(frames)
