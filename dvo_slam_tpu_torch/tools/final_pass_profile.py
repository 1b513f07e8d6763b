"""Profile the dense final-optimization schedule at the e2e operating
point (port of the reference's ``tools/final_pass_profile.py``).

Run from the repository root (the card's machine by default):

    python -m dvo_slam_tpu_torch.tools.final_pass_profile [--device cpu]

Builds a graph shaped like the 200-frame e2e state (odometry chain +
keyframe edges + loop closures, 200 vertices / about 400 edges), promotes
every edge to level 0 and times the 10-round optimize + outlier-prune
schedule, the loop of ``KeyframeGraph.final_optimization``, once warm (a
second graph of the same shape runs it first).  The solves are
host-pinned float64, where the port's ``PoseGraph`` runs them as the
reference runs g2o + CSparse beside the tracker (``models/pose_graph``'s
docstring), so the device only names the machine measured: the probe asks
for the card unless told ``cpu``, as every entry point does.  Prints the
reference's three JSON lines (the graph's size; each round's optimize and
prune ms and edges removed; the total, ms per frame at 200 frames and the
edges removed) and adds the device and the route of each round's solve.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import default_device
from ..models.pose_graph import PoseGraph
from ..ops import se3


def _exp(x):
    """exp(x) in float32, as the reference's probe computes it (JAX without
    x64 truncates its float64 request)."""
    return se3.exp_se3(torch.as_tensor(np.asarray(x, np.float32))).numpy()


def build_graph(n: int = 200, n_kf: int = 6) -> PoseGraph:
    """The e2e bench's final-pass shape: every frame has an odometry edge
    to its predecessor AND a keyframe edge to its segment's keyframe
    vertex (LocalMap emits both per frame), plus robust loop-closure
    edges between keyframe pairs: about 2 edges per vertex with keyframe
    hubs of degree about n / n_kf."""
    rng = np.random.default_rng(11)
    step = np.array([0.02, 0.0, 0.0, 0.0, 0.0, 2 * np.pi / n])
    true = [np.eye(4)]
    for _ in range(n - 1):
        true.append(true[-1] @ _exp(step))
    g = PoseGraph(vertex_capacity=256, edge_capacity=512)
    g.add_vertex(0, np.eye(4), fixed=True)
    est = np.eye(4)
    rel = lambda a, b: np.linalg.inv(true[a]) @ true[b]  # noqa: E731
    seg = n // n_kf
    kf_ids = list(range(0, n, seg))
    for i in range(1, n):
        noisy = rel(i - 1, i) @ _exp(rng.normal(0, 2e-3, 6))
        est = est @ noisy
        g.add_vertex(i, est)
        g.add_edge(i - 1, i, noisy, np.eye(6) * 100.0)
        kf = (i // seg) * seg  # this segment's keyframe vertex
        if kf != i and kf != i - 1:
            g.add_edge(kf, i, rel(kf, i) @ _exp(rng.normal(0, 1e-3, 6)), np.eye(6) * 50.0)
    for a in kf_ids:
        for b in kf_ids:
            if b > a + seg:
                g.add_edge(a, b, rel(a, b) @ _exp(rng.normal(0, 1e-3, 6)), np.eye(6) * 20.0,
                           robust=True)
    return g


def run_schedule(g: PoseGraph, iterations: int = 60, rounds: int = 10, threshold: float = 0.02):
    """The final pass's rounds: optimize, then prune outliers.  Returns
    (per-round records, edges removed in all)."""
    per_round = []
    removed_total = 0
    for r in range(rounds):
        t0 = time.perf_counter()
        g.optimize(max(iterations // rounds, 1), max_level=0)
        t1 = time.perf_counter()
        removed = g.remove_outlier_edges(threshold)
        t2 = time.perf_counter()
        removed_total += removed
        per_round.append({"round": r, "opt_ms": (t1 - t0) * 1e3, "prune_ms": (t2 - t1) * 1e3,
                          "removed": removed, "route": g.last_solver})
    return per_round, removed_total


def main(device=None):
    """Run the probe; prints the three JSON lines and returns them as
    (size, rounds, totals)."""
    device = default_device(device)
    g = build_graph()
    size = {"vertices": g.num_vertices, "edges": g.num_edges, "device": str(device)}
    print(json.dumps(size), flush=True)
    g.set_all_edge_levels(0)
    warm = build_graph()
    warm.set_all_edge_levels(0)
    run_schedule(warm)

    t0 = time.perf_counter()
    rounds, removed = run_schedule(g)
    total = time.perf_counter() - t0
    print(json.dumps({"rounds": rounds}), flush=True)
    totals = {"total_s": total, "ms_per_frame_at_200": total / 200 * 1e3,
              "removed_edges": removed}
    print(json.dumps(totals), flush=True)
    return size, rounds, totals


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None,
                    help="the machine measured (default: the card's; 'cpu' on a machine without one)")
    main(ap.parse_args().device)
