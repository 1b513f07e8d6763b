"""ms per solver iteration of the pixel-sharded matcher against
``match_pyramids`` on one rank (the timing of ``chip_smoke.py``'s phase 6,
alone in its process).

Run on a machine with a CUDA card, from the repository root:

    python -m dvo_slam_tpu_torch.tools.sharded_bench [--pairs 20] [--reps 3] [--world 1]

The pairs are consecutive frames of phase 6's easy sequence (640x480,
``TUM_FR1``, radius 0.05, rotation amplitude 0.02, seed 0), prepared on the
card at ``benchmark_config().tracker``.  On a one-rank NCCL group, after one
untimed pair through each path, every round times the sharded matcher and
then ``match_pyramids`` over all pairs on the host clock, each ending in a
synchronise.  Then, so that no profiler is attached to the timed rounds,
the device kernels per solver iteration of both paths over three pairs
under ``torch.profiler``.  Prints one JSON object per line: the device, one
per round, the median of the rounds, the kernel counts.  With ``--world
N`` the script starts N ranks of itself (``tcp://localhost`` rendezvous on
a free port, rank r on card r over NCCL; ``--device cpu``: CPU ranks over
gloo), every rank runs both paths, and rank 0 reports.
"""

from __future__ import annotations

import argparse
import json
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from .. import benchmark_config, default_device
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


def kernels_per_iteration(run):
    """``run()`` -> a list of ``TrackingResult``, under ``torch.profiler``:
    {device kernels, solver iterations, kernels per iteration, host
    read-backs per iteration}.  The kernel counts are None where the
    profiler recorded no device event (not measured)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        results = run()
        torch.cuda.synchronize()
    events = prof.events()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))]
    iterations = sum(s.iterations for r in results for s in r.level_stats)
    readbacks = sum(1 for e in events if e.name == "aten::_local_scalar_dense")
    return {
        "device_kernels": len(kernels) or None, "solver_iterations": iterations,
        "kernels_per_iteration": len(kernels) / iterations if kernels else None,
        "host_readbacks_per_iteration": readbacks / iterations,
    }


def bench(pairs: int, reps: int, device=None, profiled_pairs: int = 0, world: int = 1,
          rank: int = 0, init_method=None):
    """The rounds' summaries: seconds and ms per solver iteration of both
    paths, with their iteration counts; with ``profiled_pairs``, a last
    entry with both paths' device kernels per iteration over that many
    pairs.  The card over NCCL unless the caller asks for the CPU (over
    gloo), as the tests do.  One of ``world`` ranks when ``init_method``
    names their rendezvous (rank r on card r); alone otherwise."""
    cfg = benchmark_config().tracker
    poses = synthetic.circular_trajectory(SEQUENCE_FRAMES, radius=0.05, rot_amplitude=0.02)
    intensity, depth = render_sequence(poses[:pairs + 1], SHAPE, TUM_FR1, seed0=0)
    device = mesh_lib.rank_device(rank, device) if world > 1 else default_device(device)
    d_i, d_d = upload_sequence(intensity, depth, device)
    frames = [build_frame(cfg, d_i[k], d_d[k]) for k in range(pairs + 1)]
    eye = torch.eye(4, dtype=torch.float32, device=device)
    iterations = lambda results: sum(s.iterations for r in results for s in r.level_stats)  # noqa: E731
    rounds = []
    with tempfile.TemporaryDirectory() as store:
        distributed.initialize(init_method=init_method or f"file://{store}/rendezvous",
                               world_size=world, rank=rank, device=device)
        try:
            run = sharded_alignment.make_pixel_sharded_matcher(
                cfg, TUM_FR1, mesh_lib.make_mesh(world, device=device))
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
                    "pairs": pairs, "ranks": world, "sharded_s": sharded_s, "single_s": single_s,
                    "sharded_iterations": n_sharded, "single_iterations": n_single,
                    "sharded_ms_per_iteration": 1000.0 * sharded_s / n_sharded,
                    "single_ms_per_iteration": 1000.0 * single_s / n_single,
                })
            if profiled_pairs:
                rounds.append({
                    "profiled_pairs": profiled_pairs,
                    "sharded": kernels_per_iteration(
                        lambda: [run(frames[k], frames[k + 1], eye) for k in range(profiled_pairs)]),
                    "single": kernels_per_iteration(lambda: [
                        match_pyramids(cfg, TUM_FR1, frames[k], frames[k + 1], eye)
                        for k in range(profiled_pairs)]),
                })
        finally:
            distributed.shutdown()
    return rounds


def _launch_ranks(args) -> int:
    """Start ``args.world`` ranks of this script and wait for them; the
    ranks' output passes through (rank 0 reports).  Returns the worst exit
    code; a rank that fails takes the others down."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    command = [sys.executable, "-m", "dvo_slam_tpu_torch.tools.sharded_bench",
               "--pairs", str(args.pairs), "--reps", str(args.reps), "--world", str(args.world),
               "--init-method", f"tcp://localhost:{port}"]
    if args.device:
        command += ["--device", args.device]
    procs = [subprocess.Popen(command + ["--rank", str(rank)]) for rank in range(args.world)]
    codes = []
    try:
        for proc in procs:
            codes.append(proc.wait(timeout=1800))
            if codes[-1] != 0:
                break
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return max(codes, key=abs) if codes else 1


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=20)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--world", type=int, default=1, help="ranks, one process each")
    ap.add_argument("--device", default=None, help="'cpu' for CPU ranks over gloo")
    ap.add_argument("--rank", type=int, default=None, help="(set by the launcher)")
    ap.add_argument("--init-method", default=None, help="(set by the launcher)")
    args = ap.parse_args()
    on_card = args.device != "cpu"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("sharded_bench: no CUDA device")
    if args.world > 1 and args.rank is None:
        raise SystemExit(_launch_ranks(args))
    torch.backends.cuda.matmul.allow_tf32 = False
    rank = args.rank or 0
    if on_card and rank == 0:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()
        print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}), flush=True)
    profiled_pairs = min(3, args.pairs) if on_card else 0  # the profiler counts device kernels
    rounds = bench(args.pairs, args.reps, device=args.device, world=args.world, rank=rank,
                   init_method=args.init_method, profiled_pairs=profiled_pairs)
    if rank != 0:
        return
    profiled = rounds.pop() if profiled_pairs else None
    for r in rounds:
        print(json.dumps(r), flush=True)
    print(json.dumps({key: float(np.median([r[key] for r in rounds]))
                      for key in ("sharded_ms_per_iteration", "single_ms_per_iteration")}),
          flush=True)
    if profiled is not None:
        print(json.dumps(profiled), flush=True)


if __name__ == "__main__":
    main()
