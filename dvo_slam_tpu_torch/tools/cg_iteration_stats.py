"""CG iteration counts on loopy pose graphs (port of the reference's
``tools/cg_iteration_stats.py``).

Run from the repository root (the card by default):

    python -m dvo_slam_tpu_torch.tools.cg_iteration_stats [--sizes 512,2048]
        [--gn-steps 8] [--loop-every 7] [--cap 8192] [--device cpu]
        [--sweep 1,8,32,128] [--profile]

The distributed block-CG back end (``parallel/distributed_ba``) pays one
[N, 6] all-reduce per CG iteration, so the communication cost of a GN step
on a real loopy graph is the CG iteration count.  For each size N this
builds the final-optimization shape, a drifty odometry chain of N + 1
vertices with a robust loop closure every ``--loop-every`` vertices
(keyframe_graph.cpp:257-281's dense graph), runs ``--gn-steps`` GN steps
whose block-Jacobi preconditioned CG solve (tol 1e-6, at most ``--cap``
iterations) runs in float64 on the device, as ``distributed_ba`` runs it,
and records each step's CG iterations and the chi2 before it.  The CG
loop runs in chunks of K steps (``pose_graph.CG_CHUNK_STEPS`` on the
card, 1 on the CPU).  On the card the steps run three times: as one
while-graph launch per solve (``while``), as one graph replay per chunk
with a host read of ``active`` after each (``polled``,
``irls_graph.WHILE_GRAPHS`` off) and eagerly (``eager``,
``irls_graph.CUDA_GRAPHS`` off), each after one untimed GN step that
captures its graphs: for each, ms per CG iteration (the
solve's time between two synchronises over its iterations, the
preconditioner's set-up included) and host reads per GN step (the live
edges' compaction, then the loop's reads of ``active``: none in the while
form; the caller's read of k, the result, is not counted), and whether
the three runs gave the same iterations and bits.  With ``--sweep``, the
while form again at each K listed (its graphs captured first, untimed),
in turns, each held to the eager run's bits.  Then the ``auto`` route on
the same
graph (host-pinned, the port's ``PoseGraph``): its Schur separator count,
the route the reference's policy names and the one taken, its seconds
and chi2 history.  One JSON line per size, the reference's keys plus the
device, the runs and ``auto_route``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import default_device
from ..models import pose_graph as pg
from ..ops import se3
from . import graph_check


def _exp(xi):
    return se3.exp_se3(torch.as_tensor(np.asarray(xi, np.float64))).numpy()


def _rel(a, b):
    return np.linalg.inv(a) @ b


def loopy_graph(n: int, loop_every: int):
    """The odometry chain of n + 1 vertices (noisy measurements, seed 11)
    with a robust loop closure every ``loop_every`` vertices: (graph, loop
    edges)."""
    rng = np.random.default_rng(11)
    step = [0.4, 0.0, 0.0, 0.0, 0.0, 2 * np.pi / n]
    true = [np.eye(4)]
    for _ in range(n):
        true.append(true[-1] @ _exp(step))
    g = pg.PoseGraph(dtype=np.float64)
    pose = np.eye(4)
    g.add_vertex(0, pose, fixed=True)
    for i in range(n):
        meas = _rel(true[i], true[i + 1]) @ _exp(rng.normal(0, 0.02, 6))
        pose = pose @ meas
        g.add_vertex(i + 1, pose)
        g.add_edge(i, i + 1, meas, np.eye(6))
    n_loops = 0
    for i in range(0, n - loop_every, loop_every):
        g.add_edge(i, i + loop_every, _rel(true[i], true[i + loop_every]), 50.0 * np.eye(6),
                   robust=True)
        n_loops += 1
    return g, n_loops


def gn_step_counted(arrays: pg.GraphArrays, cap: int, chunk=None):
    """One GN step with the block-CG solve -> (arrays, CG iterations, chi2
    before the step, the solve's seconds between two synchronises, its
    host reads (the live edges' compaction and the loop's reads of
    ``active``), the step dx)."""
    H_ii, H_ij, H_jj, b_i, b_j, chi2 = pg.edge_blocks(arrays)
    nv = arrays.poses.shape[0]
    free = arrays.vertex_mask & ~arrays.fixed_mask
    b = torch.zeros((nv, 6), dtype=b_i.dtype, device=b_i.device)
    pg._scatter_add(pg._scatter_add(b, arrays.edge_i, b_i), arrays.edge_j, b_j)
    # the solve's host reads: the live edges' compaction, then the loop's
    reads, read, live = [], pg._cg_read, pg._live_edges
    pg._cg_read = lambda carry: reads.append(1) or read(carry)
    pg._live_edges = lambda *edges: reads.append(1) or live(*edges)
    try:
        _synchronize(b.device)
        t0 = time.perf_counter()
        dx, k = pg.solve_blocks_cg(nv, arrays.edge_i, arrays.edge_j, H_ii, H_ij, H_jj, -b, free,
                                   iterations=cap, return_iterations=True, chunk=chunk)
        _synchronize(b.device)
        seconds = time.perf_counter() - t0
    finally:
        pg._cg_read, pg._live_edges = read, live
    dx = torch.where(free[:, None], dx, torch.zeros_like(dx))
    out = arrays._replace(poses=arrays.poses @ se3.exp_se3(dx))
    chi2 = float(torch.sum(torch.where(arrays.edge_mask, chi2, torch.zeros_like(chi2))))
    return out, k, chi2, seconds, len(reads), dx


def _synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cg_run(arrays: pg.GraphArrays, gn_steps: int, cap: int, chunk=None):
    """``gn_steps`` GN steps from ``arrays``: per step the CG iterations,
    chi2 before it, solve seconds, host reads and dx."""
    steps = []
    for _ in range(gn_steps):
        arrays, *step = gn_step_counted(arrays, cap, chunk)
        steps.append(step)
    return steps


# the timed forms on the card: (name, loop_mode arguments)
FORMS = (("while", dict(graphs=True, polled=False)), ("polled", dict(graphs=True, polled=True)),
         ("eager", dict(graphs=False)))


def _same_steps(a, b) -> bool:
    """Whether two runs took the same CG iterations and dx bits at every GN step."""
    return all(x[0] == y[0] and torch.equal(x[4], y[4]) for x, y in zip(a, b))


def _summary(steps, chunk):
    """A run's numbers: iterations per step, ms per CG iteration, host
    reads per GN step."""
    iterations = sum(s[0] for s in steps)
    seconds = sum(s[2] for s in steps)
    return {
        "chunk": chunk,
        "cg_iterations_per_gn_step": [s[0] for s in steps],
        "cg_seconds": seconds,
        "ms_per_cg_iteration": 1000.0 * seconds / iterations if iterations else None,
        "host_reads_per_gn_step": [s[3] for s in steps],
    }


PROFILE_CAP = 256  # CG iterations of the profiled solve: enough for a per-iteration mean


def kernel_profile(arrays: pg.GraphArrays, cap: int, chunk: int, top: int = 8):
    """One GN step's CG solve, cut to ``PROFILE_CAP`` iterations, run
    eagerly under ``torch.profiler``: its CG iterations, device ms per CG
    iteration (the step's few kernels outside the loop included), and the
    ``top`` kernels by device time per CG iteration (None where the
    profiler records no device event)."""
    from torch.profiler import ProfilerActivity, profile

    with graph_check.loop_mode(False):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, k, *_ = gn_step_counted(arrays, min(cap, PROFILE_CAP), chunk)
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    if not by_name or not k:
        return None
    ranked = sorted(by_name.items(), key=lambda item: -item[1])[:top]
    return {
        "cg_iterations": k,
        "device_ms_per_cg_iteration": sum(by_name.values()) / 1000.0 / k,
        "top_kernels_ms_per_cg_iteration": [[name[:96], us / 1000.0 / k] for name, us in ranked],
    }


def main(argv=None):
    """Run the probe; prints one JSON line per size and returns them."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--sizes", default="512,2048")
    ap.add_argument("--gn-steps", type=int, default=8)
    ap.add_argument("--loop-every", type=int, default=7)
    ap.add_argument("--cap", type=int, default=8192)
    ap.add_argument("--device", default=None,
                    help="device of the CG solves (default: the card; 'cpu')")
    ap.add_argument("--sweep", default="", help="more chunk sizes to time under graphs, e.g. 1,8,32")
    ap.add_argument("--profile", action="store_true",
                    help="device time per CG iteration by kernel, one eager GN step under torch.profiler")
    args = ap.parse_args(argv)
    device = default_device(args.device)
    chunk = pg.CG_CHUNK_STEPS if device.type == "cuda" else 1

    records = []
    for n in [int(s) for s in args.sizes.split(",")]:
        g, n_loops = loopy_graph(n, args.loop_every)
        arrays = pg.GraphArrays(*(t.to(device) for t in g.to_arrays()))
        forms = FORMS if device.type == "cuda" else FORMS[2:]
        runs = {}
        for name, mode in forms:
            with graph_check.loop_mode(**mode):
                gn_step_counted(arrays, args.cap, chunk)  # the captures, untimed
                runs[name] = cg_run(arrays, args.gn_steps, args.cap, chunk)
        main_run = next(iter(runs.values()))
        counts = [s[0] for s in main_run]
        chi2s = [s[1] for s in main_run]
        record_runs = {name: _summary(steps, chunk) for name, steps in runs.items()}
        if len(runs) > 1:
            record_runs["forms_bit_equal"] = all(
                _same_steps(steps, runs["eager"]) for steps in runs.values())
        chunks = [int(c) for c in args.sweep.split(",") if c]
        sweep_runs = {k: [] for k in chunks}
        for k in chunks:  # the captures, untimed
            with graph_check.loop_mode(True, polled=False):
                gn_step_counted(arrays, args.cap, k)
        for order in (chunks, chunks[::-1]):  # in turns, so that drift reaches every K alike
            for k in order:
                with graph_check.loop_mode(True, polled=False):
                    sweep_runs[k].append(cg_run(arrays, args.gn_steps, args.cap, k))
        sweep = []
        for k, both in sweep_runs.items():
            row = _summary(both[0], k)
            row["cg_seconds"] = float(np.mean([sum(s[2] for s in steps) for steps in both]))
            row["ms_per_cg_iteration"] = 1000.0 * row["cg_seconds"] / sum(
                row["cg_iterations_per_gn_step"])
            row["bit_equal_to_eager"] = all(_same_steps(steps, runs["eager"]) for steps in both)
            sweep.append(row)
        profile = kernel_profile(arrays, args.cap, chunk) if args.profile else None

        # the auto path on the same problem: chain elimination reduces the
        # loopy graph onto its separator set (loop-closure endpoints) and
        # factorizes the reduced dense system exactly, no Krylov iteration
        struct = g._chain_structure(0)
        t0 = time.perf_counter()
        hist = g.optimize(iterations=args.gn_steps, solver="auto")
        auto_s = time.perf_counter() - t0
        record = {
            "vertices": n + 1,
            "odometry_edges": n,
            "loop_edges": n_loops,
            "tol": 1e-6,
            "cg_iterations_per_gn_step": counts,
            "chi2_before_each_step": chi2s,
            "allreduces_per_gn_step_distributed": counts,
            "schur_separators": g._real_sep_count if struct is not None else None,
            "auto_solver": "schur" if (
                struct is not None
                and g._real_sep_count <= pg.PoseGraph.SCHUR_SEPARATOR_MAX_VERTICES
            ) else "cg",
            "auto_route": g.last_solver,
            "auto_wall_s": auto_s,
            "auto_chi2_history": [float(c) for c in hist],
            "device": str(device),
            "runs": record_runs,
            "sweep": sweep,
            "profile": profile,
        }
        print(json.dumps(record), flush=True)
        records.append(record)
    return records


if __name__ == "__main__":
    main()
