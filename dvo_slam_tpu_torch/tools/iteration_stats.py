"""Per-level IRLS iterations and terminations over the bench trajectory,
and the steps each chunk size K of the IRLS loop would execute (port of
the reference's ``tools/iteration_stats.py``).

The per-frame cost is per level (steps x the cost of a step) plus one host
read per chunk; a level's loop runs K * ceil(iterations / K) steps, of which
the last K - 1 at most are inert.  These counts are the data behind
``dense_tracker.CHUNK_STEPS``.

Run from the repository root (the card by default):

    python -m dvo_slam_tpu_torch.tools.iteration_stats [--frames 12] [--device cpu]

Renders the easy 640x480 loop of the benchmark (``bench.py``'s noise,
frame i from seed i), tracks it frame to frame with a constant-velocity
guess at ``benchmark_config().tracker``, prints one line per frame (per
level: iterations, termination, valid constraints), then one JSON line:
per level the iterations' mean and histogram, and per K the steps, the
inert steps and the host reads per frame.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import Counter

import numpy as np
import torch

from .. import benchmark_config, default_device
from ..models.dense_tracker import executed_steps, match_pyramids
from ..odometry import build_frame, render_sequence, upload_sequence
from ..ops.camera import TUM_FR1
from ..utils import synthetic

CHUNKS = (1, 2, 3, 4)


def track_levels(cfg, intrinsics, intensity, depth):
    """Frame-to-frame matches over device frames [N, H, W] (u8 / u16), each
    from the last relative transform -> per frame [(level, iterations,
    termination, valid constraints)] from the first level to the last."""
    levels = list(range(cfg.first_level, cfg.last_level - 1, -1))
    eye = torch.eye(4, dtype=torch.float32, device=intensity.device)
    prev, rel, out = build_frame(cfg, intensity[0], depth[0]), eye, []
    for k in range(1, intensity.shape[0]):
        cur = build_frame(cfg, intensity[k], depth[k])
        r = match_pyramids(cfg, intrinsics, prev, cur, rel)
        out.append([(lv, int(s.iterations), int(s.termination), int(s.valid_constraints))
                    for lv, s in zip(levels, r.level_stats)])
        rel, prev = r.transformation, cur
    return out


def summarize(per_frame, chunks=CHUNKS) -> dict:
    """Per level the iterations' mean and histogram; per K the executed
    steps, the inert steps and the host reads, each per frame."""
    frames = len(per_frame)
    its = [it for rows in per_frame for _, it, _, _ in rows]
    by_level = {}
    for rows in per_frame:
        for lv, it, term, _ in rows:
            entry = by_level.setdefault(f"L{lv}", {"iterations": [], "terminations": Counter()})
            entry["iterations"].append(it)
            entry["terminations"][term] += 1
    return {
        "frames": frames,
        "iterations_per_frame": sum(its) / frames,
        "levels": {name: {"mean_iterations": float(np.mean(e["iterations"])),
                          "histogram": dict(sorted(Counter(e["iterations"]).items())),
                          "terminations": dict(sorted(e["terminations"].items()))}
                   for name, e in by_level.items()},
        "per_chunk": {f"K={k}": {"steps_per_frame": executed_steps(its, k) / frames,
                                 "inert_steps_per_frame": (executed_steps(its, k) - sum(its))
                                 / frames,
                                 "reads_per_frame": sum(-(-it // k) for it in its) / frames}
                      for k in chunks},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--device", default=None, help="cpu, or the card when omitted")
    args = ap.parse_args(argv)
    device = default_device(args.device)
    cfg = benchmark_config().tracker
    poses = synthetic.circular_trajectory(args.frames, radius=0.05, rot_amplitude=0.02)
    d_i, d_d = upload_sequence(*render_sequence(poses, (480, 640), TUM_FR1), device)
    per_frame = track_levels(cfg, TUM_FR1, d_i, d_d)
    for i, rows in enumerate(per_frame, start=1):
        print(f"frame {i:2d}: " + "  ".join(
            f"L{lv}: it={it:3d} term={term} n={n}" for lv, it, term, n in rows))
    print(json.dumps(summarize(per_frame)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
