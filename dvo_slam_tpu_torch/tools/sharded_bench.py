"""ms per solver iteration of the pixel-sharded matcher, as while graphs,
as host-polled graphs and eagerly, against ``match_pyramids`` (the timing
of ``chip_smoke.py``'s phase 6, alone in its process).

Run on a machine with a CUDA card, from the repository root:

    python -m dvo_slam_tpu_torch.tools.sharded_bench [--pairs 20] [--reps 3] [--world 1]
        [--sweep 1,2,3,4]

The pairs are consecutive frames of phase 6's easy sequence (640x480,
``TUM_FR1``, radius 0.05, rotation amplitude 0.02, seed 0), prepared on the
card at ``benchmark_config().tracker``.  Every round reports the form that
the NCCL group's probe chose for its loops (``irls_graph.stats()
["group_forms"]``: "while", or "polled" with CUDA's refusal).  After one
untimed pair through each path, every round times, over all pairs on the
host clock, each ending in a synchronise: the sharded matcher with each level one
launch of a while graph (the all-reduces in its WHILE body), the same with
each chunk a host-polled graph replay (``irls_graph.WHILE_GRAPHS``
off), the same eagerly (``irls_graph.CUDA_GRAPHS`` off) and
``match_pyramids``, with the host reads of ``done`` each made.  Then the
K sweep: the sharded matcher in the group's form at each K of ``--sweep``
(``sharded_alignment.CHUNK_STEPS``), one untimed pair first, then each
round over all pairs: ms per iteration, executed steps and host reads.
Then the graph cache's ``stats()``, and, so that no profiler is attached
to the timed rounds, the device kernels per solver iteration of both
paths over three pairs under ``torch.profiler`` (None where it records no
device event).  Prints one JSON object per line: the device, one per
round, the medians, the sweep, the cache, the kernel counts.  With
``--world N`` the script starts N ranks of itself (``tcp://localhost``
rendezvous on a free port, rank r on card r over NCCL, the captures on
every rank; ``--device cpu``: CPU ranks over gloo, which run eagerly),
every rank runs every path, and rank 0 reports.
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
from ..models import dense_tracker, irls_graph
from ..models.dense_tracker import executed_steps, match_pyramids
from ..odometry import build_frame, render_sequence, upload_sequence
from ..ops.camera import TUM_FR1
from ..parallel import distributed, mesh as mesh_lib, sharded_alignment
from ..utils import synthetic
from . import graph_check

SHAPE = (480, 640)
SEQUENCE_FRAMES = 100  # phase 6 takes its pairs from the head of this trajectory


def _timed(fn, device):
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda _: None)
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


def _timed_reads(fn, device):
    """(``_timed(fn)``, the host reads of ``done`` that ``fn`` made)."""
    reads = dense_tracker.read_done.calls
    out = _timed(fn, device)
    return out, dense_tracker.read_done.calls - reads


# the sharded matcher's timed forms: (name, loop_mode arguments)
FORMS = (("sharded", dict(graphs=True, polled=False)),
         ("sharded_polled", dict(graphs=True, polled=True)),
         ("sharded_eager", dict(graphs=False)))


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
    iterations = int(sum(s.iterations for r in results for s in r.level_stats))
    readbacks = sum(1 for e in events if e.name == "aten::_local_scalar_dense")
    return {
        "device_kernels": len(kernels) or None, "solver_iterations": iterations,
        "kernels_per_iteration": len(kernels) / iterations if kernels else None,
        "host_readbacks_per_iteration": readbacks / iterations,
    }


def bench(pairs: int, reps: int, device=None, profiled_pairs: int = 0, world: int = 1,
          rank: int = 0, init_method=None, sweep=(), cache_stats: bool = False):
    """The rounds' summaries: per round the group's form and the
    seconds, ms per solver iteration and ``done`` reads of the sharded path
    as while graphs (``sharded``), host-polled graphs (``sharded_polled``)
    and eagerly (``sharded_eager``) and of ``match_pyramids``, with their
    iteration counts; then one entry per K of ``sweep`` (the sharded path
    in the group's form at that K, the median of ``reps`` rounds); with
    ``cache_stats``, the graph cache's stats before the group's shutdown
    releases its keys; with ``profiled_pairs``, a last entry with both
    paths' device kernels per iteration over that many pairs.  The card
    over NCCL unless the caller asks for the CPU (over gloo), as the tests
    do.  One of ``world`` ranks when ``init_method`` names their
    rendezvous (rank r on card r); alone otherwise."""
    cfg = benchmark_config().tracker
    poses = synthetic.circular_trajectory(SEQUENCE_FRAMES, radius=0.05, rot_amplitude=0.02)
    intensity, depth = render_sequence(poses[:pairs + 1], SHAPE, TUM_FR1, seed0=0)
    device = mesh_lib.rank_device(rank, device) if world > 1 else default_device(device)
    d_i, d_d = upload_sequence(intensity, depth, device)
    frames = [build_frame(cfg, d_i[k], d_d[k]) for k in range(pairs + 1)]
    eye = torch.eye(4, dtype=torch.float32, device=device)
    iterations = lambda results: int(sum(s.iterations for r in results for s in r.level_stats))  # noqa: E731
    rounds = []
    with tempfile.TemporaryDirectory() as store:
        distributed.initialize(init_method=init_method or f"file://{store}/rendezvous",
                               world_size=world, rank=rank, device=device)
        try:
            run = sharded_alignment.make_pixel_sharded_matcher(
                cfg, TUM_FR1, mesh_lib.make_mesh(world, device=device))
            forms = irls_graph.stats()["group_forms"]
            sharded = lambda: [run(frames[k], frames[k + 1], eye) for k in range(pairs)]  # noqa: E731
            for _, mode in FORMS:  # warm-up (the communicator, the captures), not timed
                with graph_check.loop_mode(**mode):
                    run(frames[0], frames[1], eye)
            match_pyramids(cfg, TUM_FR1, frames[0], frames[1], eye)
            for _ in range(reps):
                row = {"pairs": pairs, "ranks": world, "chunk": sharded_alignment.CHUNK_STEPS,
                       "group_forms": forms}
                for name, mode in FORMS:
                    with graph_check.loop_mode(**mode):
                        (results, seconds), reads = _timed_reads(sharded, device)
                    n = iterations(results)
                    row.update({f"{name}_s": seconds, f"{name}_iterations": n,
                                f"{name}_ms_per_iteration": 1000.0 * seconds / n,
                                f"{name}_done_reads": reads})
                single, single_s = _timed(lambda: [
                    match_pyramids(cfg, TUM_FR1, frames[k], frames[k + 1], eye)
                    for k in range(pairs)], device)
                n_single = iterations(single)
                row.update({"single_s": single_s, "single_iterations": n_single,
                            "single_ms_per_iteration": 1000.0 * single_s / n_single})
                rounds.append(row)
            for chunk in sweep:  # the captures of each K, not timed
                with graph_check.loop_mode(True, sharded=chunk):
                    run(frames[0], frames[1], eye)
            timed = {chunk: [] for chunk in sweep}
            for rep in range(reps):  # in turns: K forward, then backward
                for chunk in (sweep if rep % 2 == 0 else sweep[::-1]):
                    with graph_check.loop_mode(True, sharded=chunk):
                        timed[chunk].append(_timed_reads(sharded, device))
            for chunk, runs in timed.items():
                its = [int(s.iterations) for r in runs[0][0][0] for s in r.level_stats]
                n = sum(its)
                seconds = float(np.median([t for (_, t), _ in runs]))
                rounds.append({
                    "sweep_chunk": chunk, "iterations": n,
                    "executed_steps": executed_steps(its, chunk),
                    "host_reads": runs[0][1],
                    "seconds": seconds, "ms_per_iteration": 1000.0 * seconds / n,
                })
            if cache_stats:
                rounds.append({"graph_cache": irls_graph.stats()})
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
               "--sweep", args.sweep, "--init-method", f"tcp://localhost:{port}"]
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
    ap.add_argument("--sweep", default="1,2,3,4",
                    help="chunk sizes K of the sharded level under graphs ('' for none)")
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
    sweep = [int(k) for k in args.sweep.split(",") if k]
    rounds = bench(args.pairs, args.reps, device=args.device, world=args.world, rank=rank,
                   init_method=args.init_method, profiled_pairs=profiled_pairs, sweep=sweep,
                   cache_stats=True)
    if rank != 0:
        return
    timed = [r for r in rounds if "sharded_s" in r]
    for r in rounds:
        if r in timed:
            print(json.dumps(r), flush=True)
    print(json.dumps({key: float(np.median([r[key] for r in timed])) for key in (
        "sharded_ms_per_iteration", "sharded_polled_ms_per_iteration",
        "sharded_eager_ms_per_iteration", "single_ms_per_iteration")}), flush=True)
    for r in rounds:
        if r not in timed:
            print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
