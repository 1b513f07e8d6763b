"""The IRLS loop's chunk size K on the card: frames/s, ms per iteration,
executed steps and host reads per frame for K = 1-4 under CUDA graphs,
beside the eager loop at K = 1 (the loop before the graphs: one read and
~340 launches per iteration).

Run on a machine with a CUDA card, from the repository root:

    python -m dvo_slam_tpu_torch.tools.chunk_sweep [--frames 100] [--streams 8]
        [--stream-frames 30] [--chunks 1,2,3,4]

Renders ``chip_smoke.py``'s phase 4 sequence (the easy 640x480 loop) and
phase 7's B streams, then for each mode tracks the sequence frame to frame
(``odometry.track_sequence``) and the B streams in lockstep
(``make_multistream_tracker``) at ``benchmark_config().tracker``, each
after a 3-frame warm-up that captures the mode's graphs.  Every mode's
per-level carries are held bit-equal to the eager loop's.  Prints one JSON
line per mode and workload, then the graph cache's size.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from ..models import irls_graph
from . import graph_check


def _seconds(fn):
    """(fn(), host seconds between two synchronizations of the card)."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - start


def one_stream(cfg, intrinsics, d_i, d_d, graphs: bool, chunk: int, warm: bool = True):
    """Frame-to-frame odometry over device frames [N, H, W] in one mode,
    after a 3-frame warm-up unless ``warm`` is off -> (row, recorded
    levels)."""
    from ..odometry import track_sequence

    with graph_check.loop_mode(graphs, chunk):
        if warm:
            track_sequence(cfg, intrinsics, d_i[:3], d_d[:3])  # this mode's captures
        with graph_check.recording() as levels:
            _, _, seconds = track_sequence(cfg, intrinsics, d_i, d_d)
    its, steps, reads = graph_check.counts(graph_check.stats_of(levels), chunk)
    frames = d_i.shape[0] - 1
    return {"frames": d_i.shape[0], "tracked_frames_per_s": frames / seconds, "seconds": seconds,
            "iterations": its, "executed_steps": steps, "ms_per_iteration": 1000.0 * seconds / its,
            "irls_reads_per_frame": reads / frames}, levels


def lockstep(cfg, intrinsics, s_i, s_d, graphs: bool, chunk: int, warm: bool = True):
    """B streams [B, T, H, W] in lockstep in one mode, after a 3-frame
    warm-up unless ``warm`` is off -> (row, levels)."""
    from ..parallel.multistream import make_multistream_tracker

    with graph_check.loop_mode(graphs, chunk):
        run = make_multistream_tracker(cfg, intrinsics)
        if warm:
            run.tracks(s_i[:, :3], s_d[:, :3])  # this mode's captures
        with graph_check.recording() as levels:
            _, seconds = _seconds(lambda: run.tracks(s_i, s_d))
    its, steps, reads = graph_check.counts(graph_check.stats_of(levels), chunk)
    streams, frames = s_i.shape[:2]
    return {"streams": streams, "frames": frames,
            "aggregate_frames_per_s": streams * (frames - 1) / seconds, "seconds": seconds,
            "lockstep_iterations": its, "executed_steps": steps,
            "ms_per_lockstep_iteration": 1000.0 * seconds / its,
            "irls_reads_per_frame": reads / (frames - 1)}, levels


def sweep(cfg, intrinsics, d_i, d_d, s_i, s_d, chunks=(1, 2, 3, 4)):
    """The eager loop at K = 1, then the graph loop at each K, on one
    stream and on B streams in lockstep -> {(workload, mode): row}, each
    graph row with ``bit_equal_to_eager`` (its levels against the eager
    loop's) and ``differences`` where they part."""
    rows = {}
    for workload, fn, args in (("one_stream", one_stream, (d_i, d_d)),
                               ("lockstep", lockstep, (s_i, s_d))):
        row, eager = fn(cfg, intrinsics, *args, graphs=False, chunk=1)
        rows[workload, "eager K=1"] = row
        for chunk in chunks:
            row, levels = fn(cfg, intrinsics, *args, graphs=True, chunk=chunk)
            diffs = graph_check.differences(levels, eager)
            row.update(bit_equal_to_eager=not diffs, differences=diffs[:5])
            rows[workload, f"graphs K={chunk}"] = row
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--stream-frames", type=int, default=30)
    ap.add_argument("--chunks", default="1,2,3,4")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chunk_sweep: no CUDA device; the sweep measures the card", file=sys.stderr)
        return 2
    from .. import benchmark_config
    from ..odometry import render_sequence, upload_sequence
    from ..ops.camera import TUM_FR1
    from ..parallel.multistream import as_frames
    from ..utils import synthetic
    from .multistream_bench import render_streams

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    workers = min(8, os.cpu_count() or 1)
    cfg = benchmark_config().tracker
    poses = synthetic.circular_trajectory(args.frames, radius=0.05, rot_amplitude=0.02)
    d_i, d_d = upload_sequence(*render_sequence(poses, (480, 640), TUM_FR1, seed0=0,
                                                workers=workers), device)
    intensity, depth, _ = render_streams(args.streams, args.stream_frames, (480, 640), TUM_FR1,
                                         workers=workers)
    s_i, s_d = as_frames(intensity, depth, device)
    chunks = tuple(int(k) for k in args.chunks.split(","))
    rows = sweep(cfg, TUM_FR1, d_i, d_d, s_i, s_d, chunks)
    for (workload, mode), row in rows.items():
        print(json.dumps({"workload": workload, "mode": mode, **row}), flush=True)
    print(json.dumps({"graph_cache": irls_graph.stats(),
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0 if all(r.get("bit_equal_to_eager", True) for r in rows.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
