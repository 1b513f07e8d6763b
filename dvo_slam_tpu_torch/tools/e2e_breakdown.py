"""Wall-clock breakdown of the driver's e2e SLAM run (port of the
reference's ``tools/e2e_breakdown.py``).

Run from the repository root (the card by default):

    python -m dvo_slam_tpu_torch.tools.e2e_breakdown [--frames 200] [--device cpu]

Renders the driver's e2e sequence (``bench.e2e``: the hard-scene loop,
seeds 2000 + i, 640x480), makes one warm run of ``StreamingSLAM`` and
then times the same sequence with row 0 perturbed, twice:

  * pipelined, as the driver's ``slam_e2e_fps`` times it
    (``track_sequence(..., pipeline_chunk=50)``: chunk k's records feed the
    back end while chunk k + 1 runs);
  * split, stage by stage as the reference's tool splits it: the host's
    ingest reduction, the upload, the front end's scan, the record copy and
    decode, the replay into the keyframe graph until its worker's queue is
    empty, and the final pass.

The split's total less the pipelined run's seconds is the back-end time
the pipelined form hides.  Prints one JSON line with the seconds of each
stage, both totals and frames/s, the hidden seconds, whether the split's
records equal the pipelined run's bit for bit, both ATEs, the graph's size
and the worker's phase totals.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from .. import bench, benchmark_config, default_device
from ..config import SlamConfig
from ..models.streaming import StreamingSLAM, _decode, host_reduce_ingest
from ..ops.camera import TUM_FR1, Intrinsics
from ..utils import synthetic, trajectory


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device):
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0


def breakdown(cfg: SlamConfig, intrinsics: Intrinsics, intensity_u8, depth_u16, poses, device,
              pipeline_chunk: int = bench.PIPELINE_CHUNK) -> dict:
    """The pipelined run's seconds and the stage-by-stage split of the same
    sequence (u8 / u16 [T, H, W], ground truth ``poses``) on ``device``."""
    frames = intensity_u8.shape[0]
    stamps = np.arange(frames) / 30.0
    slam = StreamingSLAM(intrinsics, cfg, device=device)
    try:
        slam.track_sequence(intensity_u8, depth_u16, stamps, pipeline_chunk=pipeline_chunk)
        iv = intensity_u8.copy()
        iv[:, 0, :] += 1

        slam.reset()
        _, pipelined_s = _timed(lambda: slam.track_sequence(
            iv, depth_u16, stamps, pipeline_chunk=pipeline_chunk), device)
        pipelined_ate = trajectory.ate_rmse(*slam.graph.trajectory(), stamps, poses)
        pipelined_records = slam.records

        slam.reset()
        split = {}
        t0 = time.perf_counter()
        if slam.ingest_level:
            iu_r, du_r = host_reduce_ingest(iv, depth_u16, slam.ingest_level)
        else:
            iu_r, du_r = iv, depth_u16
        split["reduce_s"] = time.perf_counter() - t0
        (d_i, d_d), split["upload_s"] = _timed(lambda: tuple(
            torch.from_numpy(np.require(a, requirements=("C", "W"))).to(device)
            for a in (iu_r, du_r)), device)
        force = torch.zeros(frames, dtype=torch.bool)
        force[-1] = True
        raw, split["scan_s"] = _timed(lambda: slam._run(
            d_i, d_d, force.to(device), slam._init_T(None)).cpu().numpy(), device)
        t0 = time.perf_counter()
        records = [_decode(raw[i]) for i in range(frames)]
        online = np.stack([r.pose for r in records])
        split["decode_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        slam.records = records
        slam._replay(records, iv, depth_u16, stamps)
        slam.graph.wait_for_queue()
        split["replay_s"] = time.perf_counter() - t0
        _, split["final_s"] = _timed(slam.graph.final_optimization, device)
        ate = trajectory.ate_rmse(*slam.graph.trajectory(), stamps, poses)
        records_equal = len(records) == len(pipelined_records) and all(
            np.array_equal(x, y) for a, b in zip(records, pipelined_records) for x, y in zip(a, b))
        online_ate = trajectory.ate_rmse(stamps, online, stamps, poses)
        frontend_s = split["reduce_s"] + split["upload_s"] + split["scan_s"] + split["decode_s"]
        total_s = frontend_s + split["replay_s"] + split["final_s"]
        graph = slam.graph
        return {
            "frames": frames, "device": str(device), **split, "frontend_s": frontend_s,
            "total_s": total_s, "fps": frames / total_s,
            "pipelined_s": pipelined_s, "pipelined_fps": frames / pipelined_s,
            "hidden_by_pipelining_s": total_s - pipelined_s,
            "records_equal_to_pipelined": bool(records_equal),
            "ate_online_m": float(online_ate), "ate_optimized_m": float(ate),
            "pipelined_ate_optimized_m": float(pipelined_ate),
            "keyframes": len(graph.keyframes), "edges": graph.graph.num_edges,
            "vertices": graph.graph.num_vertices,
            "worker_phase_totals_s": {name: s["total_s"]
                                      for name, s in graph.timers.summary().items()},
        }
    finally:
        slam.graph.shutdown()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=bench.E2E_FRAMES)
    ap.add_argument("--device", default=None, help="cpu, or the card when omitted")
    args = ap.parse_args(argv)
    device = default_device(args.device)
    poses = synthetic.circular_trajectory(args.frames, radius=0.15, rot_amplitude=0.12,
                                          z_amplitude=0.05)
    t0 = time.perf_counter()
    iu, du = bench.render_sequence(poses, bench.SHAPE, scene=synthetic.occluded_scene(),
                                   seed0=2000, workers=min(8, os.cpu_count() or 1))
    render_s = time.perf_counter() - t0
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False  # as the driver runs
    out = breakdown(benchmark_config(), TUM_FR1, iu, du, poses, device)
    print(json.dumps({"render_s": render_s, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
