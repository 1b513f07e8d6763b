"""Aggregate tracked frames/s per card with B camera streams on one card
(port of the reference's ``tools/multistream_bench.py``).

Run on a machine with a CUDA card, from the repository root:

    python -m dvo_slam_tpu_torch.tools.multistream_bench [--streams 8] [--frames 50]
        [--reps 2] [--schedule both]

Each stream is a rendered 640x480 trajectory (``TUM_FR1``, radius 0.05 +
0.005 b, rotation amplitude 0.02, the benchmark's sensor noise, seed 31 b +
t), sent to the card as u8 intensity and u16 depth, and tracked by
``make_multistream_tracker`` at ``benchmark_config().tracker``.  After one
untimed run, ``--reps`` runs are timed on the host clock, each ending in a
synchronise.  Prints one JSON object per line: the device, then per
schedule the aggregate frames/s = B (T-1) / seconds, the per-stream rate,
the solver loop iterations and ms per loop iteration, and the worst
per-stream ATE-RMSE against the ground truth.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from .. import benchmark_config
from ..odometry import render_sequence
from ..ops.camera import TUM_FR1
from ..parallel.multistream import SCHEDULES, as_frames, make_multistream_tracker
from ..utils import synthetic, trajectory

SHAPE = (480, 640)


def render_streams(streams: int, frames: int, shape=SHAPE, intrinsics=TUM_FR1, workers=1):
    """The benchmark's B streams: (u8 intensity [B, T, H, W], u16 depth
    [B, T, H, W], ground-truth poses [B, T, 4, 4]), each stream rendered by
    ``workers`` threads."""
    intensity = np.zeros((streams, frames) + tuple(shape), np.uint8)
    depth = np.zeros((streams, frames) + tuple(shape), np.uint16)
    gt = np.zeros((streams, frames, 4, 4))
    for b in range(streams):
        gt[b] = synthetic.circular_trajectory(frames, radius=0.05 + 0.005 * b, rot_amplitude=0.02)
        intensity[b], depth[b] = render_sequence(gt[b], shape, intrinsics, seed0=31 * b,
                                                   workers=workers)
    return intensity, depth, gt


def stream_ates(poses, gt):
    """ATE-RMSE of each stream: tracked poses [B, T-1, 4, 4] (frame 0 at the
    identity) against the ground truth [B, T, 4, 4]."""
    poses = np.asarray(poses, np.float64)
    streams, frames = gt.shape[:2]
    est = np.concatenate([np.tile(np.eye(4), (streams, 1, 1, 1)), poses], axis=1)
    stamps = np.arange(frames) / 30.0
    return [trajectory.ate_rmse(stamps, est[b], stamps, gt[b]) for b in range(streams)]


def bench(schedule: str, intensity, depth, gt, reps: int = 2):
    """One schedule on the card -> its summary dict."""
    cfg = benchmark_config().tracker
    streams, frames = intensity.shape[:2]
    run = make_multistream_tracker(cfg, TUM_FR1, schedule=schedule)
    tracks = run.tracks(intensity, depth)  # untimed first run
    seconds = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tracks = run.tracks(intensity, depth)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    elapsed = float(np.median(seconds))
    fps = streams * (frames - 1) / elapsed
    ates = stream_ates(tracks.poses.cpu().numpy(), gt)
    return {
        "metric": "aggregate_tracked_frames_per_second_per_card",
        "schedule": schedule, "streams": streams, "frames": frames,
        "value": fps, "unit": "frames/s", "per_stream_fps": fps / streams,
        "seconds": seconds, "loop_iterations": tracks.loop_iterations,
        "ms_per_loop_iteration": 1000.0 * elapsed / tracks.loop_iterations,
        "worst_ate_rmse_m": float(max(ates)),
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--schedule", default="both", choices=("both",) + SCHEDULES)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("multistream_bench: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}), flush=True)
    intensity, depth, gt = render_streams(args.streams, args.frames)
    d_i, d_d = as_frames(intensity, depth, "cuda")
    schedules = SCHEDULES if args.schedule == "both" else (args.schedule,)
    for schedule in schedules:
        print(json.dumps(bench(schedule, d_i, d_d, gt, args.reps)), flush=True)


if __name__ == "__main__":
    main()
