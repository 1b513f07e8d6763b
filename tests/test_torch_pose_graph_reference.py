"""The port's pose graph (``models/pose_graph.PoseGraph``) against the
benchmark's plain pose-graph reference (``slam_bench/reference/pose_graph``,
float64 ``torch``, Levenberg-Marquardt with Marquardt's scaling), on the
CPU.

Graphs of 12 to 40 vertices drawn from the seed: a ring of odometry edges
with noise, loop edges (some Cauchy-robust), and one gross outlier among
the robust edges; the first vertex fixed.  The port's dense route and the
route ``auto`` picks (dense at these sizes) each reach the reference's
minimum from the same start: one optimisation, and the keyframe graph's
final schedule (10 rounds of an optimisation and the pruning of robust
edges whose Cauchy weight is below 0.1), which prunes the same edges.
"""

import numpy as np
import pytest
import torch

from dvo_slam_tpu_torch.models.pose_graph import PoseGraph
from slam_bench.reference import pose_graph as ref_pg
from slam_bench.reference import tracker as ref_tracker

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

SIZES = (12, 24, 40)
ROUTES = ("dense", "auto")
INFO = np.diag([1e4] * 3 + [1e5] * 3)
ROUNDS, ROUND_ITERATIONS, THRESHOLD, TOL = 10, 100, 0.1, 1e-7  # GraphConfig's final pass
POSE_ATOL = 1e-7  # metres and radians: the port stops at a relative change of chi2 of 1e-7


def _exp(xi):
    return ref_tracker.exp_se3(torch.tensor(xi, dtype=torch.float64)).numpy()


def _noise(rng, t, r):
    return _exp(np.concatenate([rng.normal(0, t, 3), rng.normal(0, r, 3)]))


def _graph(n: int, seed: int) -> PoseGraph:
    """A float64 ring of ``n`` vertices at odometry's dead reckoning."""
    rng = np.random.default_rng(seed)
    truth = [np.eye(4)]
    for k in range(1, n):
        a = 2 * np.pi * k / n
        truth.append(_exp([0.5 * np.cos(a), 0.5 * np.sin(a), 0.05 * np.sin(3 * a), 0.0,
                           0.1 * np.sin(a), a]))
    edges, est = [], [truth[0]]
    for k in range(1, n):
        meas = np.linalg.inv(truth[k - 1]) @ truth[k] @ _noise(rng, 3e-3, 1e-3)
        edges.append((k - 1, k, meas, INFO, False))
        est.append(est[-1] @ meas)
    for e in range(n // 2):
        a, b = sorted(int(v) for v in rng.choice(n, 2, replace=False))
        if b - a >= 2:
            meas = np.linalg.inv(truth[a]) @ truth[b] @ _noise(rng, 2e-3, 1e-3)
            edges.append((a, b, meas, 0.5 * INFO, bool(e % 2)))
    outlier = np.linalg.inv(truth[1]) @ truth[n // 2] @ _exp([0.4, -0.3, 0.2, 0.1, 0.2, -0.3])
    edges.append((1, n // 2, outlier, INFO, True))
    g = PoseGraph(dtype=np.float64)
    for k in range(n):
        g.add_vertex(k, est[k], fixed=k == 0)
    for i, j, meas, info, robust in edges:
        g.add_edge(i, j, meas, info, robust=robust)
    return g


def _reference(g: PoseGraph) -> ref_pg.Graph:
    n, e = g.num_vertices, g.num_edges
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return ref_pg.Graph(t(g.poses[:n]), t(g.fixed[:n]), t(g.edge_i[:e].astype(np.int64)),
                        t(g.edge_j[:e].astype(np.int64)), t(g.measurements[:e]),
                        t(g.information[:e]), t(g.robust[:e]))


def _gap(g: PoseGraph, poses: torch.Tensor) -> float:
    t, r = ref_pg.pose_gaps(torch.from_numpy(g.poses[:g.num_vertices].copy()), poses)
    return max(float(t.max()), float(r.max()))


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("n", SIZES)
def test_one_optimisation_reaches_the_reference_minimum(n, route):
    g = _graph(n, seed=n)
    want = ref_pg.optimize(_reference(g))
    g.optimize(ROUND_ITERATIONS, solver=route, tol=TOL)
    assert g.last_solver == "dense"
    assert _gap(g, want.poses) < POSE_ATOL
    assert float(ref_pg.cost(_reference(g), torch.from_numpy(g.poses[:n].copy()))) == \
        pytest.approx(want.cost, rel=1e-9)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("n", SIZES)
def test_final_schedule_prunes_alike_and_reaches_the_minimum(n, route):
    g = _graph(n, seed=100 + n)
    start = _reference(g)
    want_poses, kept = ref_pg.final_pass(start, ROUNDS, ROUND_ITERATIONS, THRESHOLD)
    for _ in range(ROUNDS):
        g.optimize(ROUND_ITERATIONS, solver=route, tol=TOL)
        g.remove_outlier_edges(THRESHOLD)
    active = g.edge_active[:g.num_edges]
    np.testing.assert_array_equal(active, kept.numpy())
    assert not active[-1]  # the gross outlier went
    assert _gap(g, want_poses) < POSE_ATOL
    # the port's poses sit at the minimum of the edges it kept
    final = ref_pg.optimize(_reference(g)._replace(
        i=start.i[kept], j=start.j[kept], measurement=start.measurement[kept],
        information=start.information[kept], robust=start.robust[kept]),
        torch.from_numpy(g.poses[:n].copy()))
    assert _gap(g, final.poses) < POSE_ATOL


def test_the_reference_fixes_its_gauge_and_prunes_only_robust_edges():
    g = _graph(12, seed=7)
    start = _reference(g)
    out = ref_pg.optimize(start)
    np.testing.assert_array_equal(out.poses[0].numpy(), start.poses[0].numpy())
    _, pruned = ref_pg.prune(start, out.poses, 1.0)  # every robust edge weighs below 1
    np.testing.assert_array_equal(pruned.numpy(), start.robust.numpy())
