"""ms per solver iteration of the pixel-sharded matcher against
``match_pyramids`` on one rank (the timing of ``chip_smoke.py``'s phase 6,
alone in its process).

Run on a machine with a CUDA card, from the repository root:

    python -m dvo_slam_tpu_torch.tools.sharded_bench [--pairs 20] [--reps 3]

The pairs are consecutive frames of phase 6's easy sequence (640x480,
``TUM_FR1``, radius 0.05, rotation amplitude 0.02, seed 0), prepared on the
card at ``benchmark_config().tracker``.  On a one-rank NCCL group, after one
untimed pair through each path, every round times the sharded matcher and
then ``match_pyramids`` over all pairs on the host clock, each ending in a
synchronise.  Prints one JSON object per line: the device, one per round,
then the median of the rounds.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import tempfile
import time

import numpy as np
import torch

from .. import benchmark_config
from ..models.dense_tracker import match_pyramids
from ..odometry import build_frame, render_sequence, upload_sequence
from ..ops.camera import TUM_FR1
from ..parallel import distributed, mesh as mesh_lib, sharded_alignment
from ..utils import synthetic

SHAPE = (480, 640)
SEQUENCE_FRAMES = 100  # phase 6 takes its pairs from the head of this trajectory


def _timed(fn, device):
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda _: None)
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


def bench(pairs: int, reps: int, device="cuda"):
    """The rounds' summaries: seconds and ms per solver iteration of both
    paths, with their iteration counts.  The card over NCCL unless the
    caller asks for the CPU (over gloo), as the tests do."""
    cfg = benchmark_config().tracker
    poses = synthetic.circular_trajectory(SEQUENCE_FRAMES, radius=0.05, rot_amplitude=0.02)
    intensity, depth = render_sequence(poses[:pairs + 1], SHAPE, TUM_FR1, seed0=0)
    device = torch.device(device)
    d_i, d_d = upload_sequence(intensity, depth, device)
    frames = [build_frame(cfg, d_i[k], d_d[k]) for k in range(pairs + 1)]
    eye = torch.eye(4, dtype=torch.float32, device=device)
    iterations = lambda results: sum(s.iterations for r in results for s in r.level_stats)  # noqa: E731
    rounds = []
    with tempfile.TemporaryDirectory() as store:
        distributed.initialize(init_method=f"file://{store}/rendezvous", world_size=1,
                               rank=0, backend="nccl" if device.type == "cuda" else "gloo")
        try:
            run = sharded_alignment.make_pixel_sharded_matcher(cfg, TUM_FR1, mesh_lib.make_mesh(1))
            run(frames[0], frames[1], eye)  # warm-up (the communicator), not timed
            match_pyramids(cfg, TUM_FR1, frames[0], frames[1], eye)
            for _ in range(reps):
                sharded, sharded_s = _timed(
                    lambda: [run(frames[k], frames[k + 1], eye) for k in range(pairs)], device)
                single, single_s = _timed(lambda: [
                    match_pyramids(cfg, TUM_FR1, frames[k], frames[k + 1], eye)
                    for k in range(pairs)], device)
                n_sharded, n_single = iterations(sharded), iterations(single)
                rounds.append({
                    "pairs": pairs, "sharded_s": sharded_s, "single_s": single_s,
                    "sharded_iterations": n_sharded, "single_iterations": n_single,
                    "sharded_ms_per_iteration": 1000.0 * sharded_s / n_sharded,
                    "single_ms_per_iteration": 1000.0 * single_s / n_single,
                })
        finally:
            distributed.shutdown()
    return rounds


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=20)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sharded_bench: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}), flush=True)
    rounds = bench(args.pairs, args.reps)
    for r in rounds:
        print(json.dumps(r), flush=True)
    print(json.dumps({key: float(np.median([r[key] for r in rounds]))
                      for key in ("sharded_ms_per_iteration", "single_ms_per_iteration")}),
          flush=True)


if __name__ == "__main__":
    main()
