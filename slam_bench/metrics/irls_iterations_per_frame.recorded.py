"""IRLS iterations per frame: the sum over the solved levels of the
program's ``level_stats[*].iterations`` (the frames outside the profiled
slice)."""
import numpy as np


def read(run):
    frames = [f for f in run.untraced() if f.info.get("levels")]
    return float(np.mean([sum(f.info["levels"]) for f in frames])) if frames else None
