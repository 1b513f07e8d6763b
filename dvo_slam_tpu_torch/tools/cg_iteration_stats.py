"""CG iteration counts on loopy pose graphs (port of the reference's
``tools/cg_iteration_stats.py``).

Run from the repository root (the card by default):

    python -m dvo_slam_tpu_torch.tools.cg_iteration_stats [--sizes 512,2048]
        [--gn-steps 8] [--loop-every 7] [--cap 8192] [--device cpu]

The distributed block-CG back end (``parallel/distributed_ba``) pays one
[N, 6] all-reduce per CG iteration, so the communication cost of a GN step
on a real loopy graph is the CG iteration count.  For each size N this
builds the final-optimization shape, a drifty odometry chain of N + 1
vertices with a robust loop closure every ``--loop-every`` vertices
(keyframe_graph.cpp:257-281's dense graph), runs ``--gn-steps`` GN steps
whose block-Jacobi preconditioned CG solve (tol 1e-6, at most ``--cap``
iterations) runs in float64 on the device, as ``distributed_ba`` runs it,
and records each step's CG iterations and the chi2 before it.  Then the
``auto`` route on the same graph (host-pinned, the port's ``PoseGraph``):
its Schur separator count, the route the reference's policy names and the
one taken, its seconds and chi2 history.  One JSON line per size, the
reference's keys plus the device and ``auto_route``.
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


def gn_step_counted(arrays: pg.GraphArrays, cap: int):
    """One GN step with the block-CG solve -> (arrays, CG iterations, chi2
    before the step)."""
    H_ii, H_ij, H_jj, b_i, b_j, chi2 = pg.edge_blocks(arrays)
    nv = arrays.poses.shape[0]
    free = arrays.vertex_mask & ~arrays.fixed_mask
    b = torch.zeros((nv, 6), dtype=b_i.dtype, device=b_i.device)
    b = b.index_add(0, arrays.edge_i, b_i).index_add(0, arrays.edge_j, b_j)
    dx, k = pg.solve_blocks_cg(nv, arrays.edge_i, arrays.edge_j, H_ii, H_ij, H_jj, -b, free,
                               iterations=cap, return_iterations=True)
    dx = torch.where(free[:, None], dx, torch.zeros_like(dx))
    out = arrays._replace(poses=arrays.poses @ se3.exp_se3(dx))
    return out, k, float(torch.sum(torch.where(arrays.edge_mask, chi2, torch.zeros_like(chi2))))


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
    args = ap.parse_args(argv)
    device = default_device(args.device)

    records = []
    for n in [int(s) for s in args.sizes.split(",")]:
        g, n_loops = loopy_graph(n, args.loop_every)
        arrays = pg.GraphArrays(*(t.to(device) for t in g.to_arrays()))
        counts, chi2s = [], []
        for _ in range(args.gn_steps):
            arrays, k, chi2 = gn_step_counted(arrays, args.cap)
            counts.append(int(k))
            chi2s.append(chi2)

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
        }
        print(json.dumps(record), flush=True)
        records.append(record)
    return records


if __name__ == "__main__":
    main()
