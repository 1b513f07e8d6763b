"""The port's block-CG, Schur-chain and sparse-direct pose-graph routes,
the ``auto`` policy beyond the dense cap, the degrade path, the
convergence memo and the outlier diagnostics, against the reference on the
CPU.

Each graph is built in the reference's ``PoseGraph`` (the graphs of
``tests/test_pose_graph.py``) and copied into the port's with
``convert.pose_graph_from_reference``.  The reference solves its CG, Schur
and sparse routes in float64 on the CPU, as the port does, so a float32
graph's poses are held within 1e-6 (its float32 storage) and the chi2
history within rtol 1e-9.  On the LM stress graph the reference's own
compiled and op-by-op runs differ by 3.2e-5 (sparse) and 1.0e-5 (Schur)
in the poses and land on different minima by CG (5.4 apart): the port is
held to 1e-4 and the final chi2 within rtol 1e-5 on the first two, and to
the reference test's own gate on CG.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvo_slam_tpu.models import pose_graph as j_pg
from dvo_slam_tpu.ops import se3 as j_se3

from dvo_slam_tpu_torch.convert import pose_graph_from_reference, pose_graph_to_numpy
from dvo_slam_tpu_torch.models import pose_graph as t_pg

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

POSE_ATOL = 1e-6  # float32 storage
HISTORY_RTOL = 1e-9
STRESS_POSE_ATOL = 1e-4
STRESS_CHI2_RTOL = 1e-5
ROUTES = ("cg", "schur", "sparse")


_exp_jit = jax.jit(j_se3.exp_se3)


def _exp(xi):
    return np.asarray(_exp_jit(jnp.asarray(np.asarray(xi, np.float32))))


def _rel(Ta, Tb):
    return np.linalg.inv(Ta) @ Tb


def _pose_err(Ta, Tb):
    rel = _rel(np.asarray(Ta, np.float64), np.asarray(Tb, np.float64))
    return np.abs(np.asarray(j_se3.log_se3(jnp.asarray(rel, jnp.float32)))).max()


# ------------------------------------------------------------ the graphs
# (tests/test_pose_graph.py)


def loopy_graph(n, seed=0, noise=0.02, loop_every=7):
    """Drifty odometry ring with periodic robust loop closures."""
    rng = np.random.default_rng(seed)
    step = [0.4, 0.0, 0.0, 0.0, 0.0, 2 * np.pi / n]
    true = [np.eye(4)]
    for _ in range(n):
        true.append(true[-1] @ _exp(step))
    g = j_pg.PoseGraph()
    pose = np.eye(4)
    g.add_vertex(0, pose, fixed=True)
    for i in range(n):
        meas = _rel(true[i], true[i + 1]) @ _exp(rng.normal(0, noise, 6))
        pose = pose @ meas
        g.add_vertex(i + 1, pose)
        g.add_edge(i, i + 1, meas, np.eye(6))
    for i in range(0, n - loop_every, loop_every):
        g.add_edge(i, i + loop_every, _rel(true[i], true[i + loop_every]), 50.0 * np.eye(6),
                   robust=True)
    return g, true


def pure_ring(n=24):
    """A degree-2 ring: the Schur route's cycle cut (test_schur_pure_ring_cycle_cut)."""
    rng = np.random.default_rng(5)
    step = [0.3, 0.0, 0.0, 0.0, 0.0, 2 * np.pi / n]
    true = [np.eye(4)]
    for _ in range(n):
        true.append(true[-1] @ _exp(step))
    g = j_pg.PoseGraph()
    g.add_vertex(0, np.eye(4), fixed=True)
    pose = np.eye(4)
    for i in range(n - 1):
        meas = _rel(true[i], true[i + 1]) @ _exp(rng.normal(0, 0.01, 6))
        pose = pose @ meas
        g.add_vertex(i + 1, pose)
        g.add_edge(i, i + 1, meas, np.eye(6))
    g.add_edge(n - 1, 0, _rel(true[n - 1], true[n]), np.eye(6))
    return g


def lm_stress_graph():
    """tests/test_pose_graph.py::_lm_stress_graph (float64)."""
    rng = np.random.default_rng(1)
    n = 40
    true = [np.eye(4)]
    step = _exp([0.5, 0, 0, 0, 0, 0.0])
    for _ in range(n - 1):
        true.append(true[-1] @ step)
    g = j_pg.PoseGraph(vertex_capacity=64, edge_capacity=64, dtype=np.float64)
    g.add_vertex(0, true[0], fixed=True)
    for i in range(1, n):
        g.add_vertex(i, true[i] @ _exp(rng.normal(0, 0.8, 6)))
    info = np.diag([1.0, 1.0, 1.0, 1e-4, 1e-4, 1e-4])
    for i in range(n - 1):
        g.add_edge(i, i + 1, _rel(true[i], true[i + 1]), info)
    g.add_edge(2, 37, _exp([3.0, -2.0, 1.5, 1.2, -0.9, 1.4]), np.eye(6) * 1e4)
    g.add_edge(5, 35, _exp([-2.5, 1.8, -1.2, -1.0, 1.1, -0.8]), np.eye(6) * 1e4)
    return g


def ring_graph(n, loops=(), dtype=np.float32):
    """tests/test_pose_graph.py::_ring_graph."""
    rng = np.random.default_rng(7)
    step = _exp([0.4, 0.0, 0.0, 0.0, 0.0, 2 * np.pi / n])
    true = [np.eye(4)]
    for _ in range(n - 1):
        true.append(true[-1] @ step)
    g = j_pg.PoseGraph(dtype=dtype)
    g.add_vertex(0, np.eye(4), fixed=True)
    est = np.eye(4)
    for i in range(1, n):
        noisy = _rel(true[i - 1], true[i]) @ _exp(rng.normal(0, 5e-3, 6))
        est = est @ noisy
        g.add_vertex(i, est)
        g.add_edge(i - 1, i, noisy, np.eye(6))
    g.add_edge(n - 1, 0, _rel(true[-1], true[0]), np.eye(6))
    for a, b in loops:
        g.add_edge(a, b, _rel(true[a], true[b]), np.eye(6))
    return g, true


def slam_graph(frames, per_keyframe=3, seed=2):
    """A keyframe graph's dense final pass in miniature: an odometry edge per
    frame, a keyframe edge to most frames and a few robust loop edges, so
    that more than 60 % of the vertices are separators."""
    rng = np.random.default_rng(seed)
    step = _exp([0.05, 0.0, 0.01, 0.0, 0.0, 2 * np.pi / frames])
    true = [np.eye(4)]
    for _ in range(frames - 1):
        true.append(true[-1] @ step)
    g = j_pg.PoseGraph()
    for i in range(frames):
        g.add_vertex(i, true[i] @ _exp(rng.normal(0, 1e-3, 6)), fixed=i == 0)
    noisy = lambda a, b: _rel(true[a], true[b]) @ _exp(rng.normal(0, 2e-3, 6))  # noqa: E731
    for i in range(1, frames):
        g.add_edge(i - 1, i, noisy(i - 1, i), 1e2 * np.eye(6))
        kf = (i - 1) // per_keyframe * per_keyframe
        if kf != i - 1:
            g.add_edge(kf, i, noisy(kf, i), 1e2 * np.eye(6))
    for a in range(0, frames - 12, 9):
        g.add_edge(a, a + 12, noisy(a, a + 12), 50.0 * np.eye(6), robust=True)
    return g, true


def ladder_graph(n):
    """n vertices, each joined to the next two and the last to the first
    (degree >= 3 everywhere: no chain to eliminate)."""
    g = j_pg.PoseGraph(vertex_capacity=n, edge_capacity=2 * n)
    step = np.eye(4)
    step[0, 3] = 0.1
    for i in range(n):
        pose = np.eye(4)
        pose[0, 3] = 0.1 * i
        g.add_vertex(i, pose, fixed=i == 0)
    for i in range(n - 1):
        g.add_edge(i, i + 1, step, np.eye(6))
        if i + 2 < n:
            g.add_edge(i, i + 2, step @ step, np.eye(6))
    back = np.eye(4)
    back[0, 3] = -0.1 * (n - 1)
    g.add_edge(n - 1, 0, back, np.eye(6))
    return g


# ------------------------------------------------------------ helpers


def _solve_both(build, **kw):
    """(reference graph, port graph, reference history, port history) of
    ``optimize(**kw)`` on the same graph; a float64 graph under x64."""
    ref = build()
    with jax.enable_x64(ref.dtype == np.float64):
        port = pose_graph_from_reference(ref)
        h_ref = ref.optimize(**kw)
    h_port = port.optimize(**kw)
    return ref, port, np.asarray(h_ref), h_port


def _assert_same_solve(ref, port, h_ref, h_port, pose_atol=POSE_ATOL, rtol=HISTORY_RTOL):
    assert h_port.dtype == np.float64 and h_port.shape == h_ref.shape
    np.testing.assert_allclose(h_port, h_ref, rtol=rtol, atol=rtol * abs(h_ref[0]))
    a, b = pose_graph_to_numpy(port), pose_graph_to_numpy(ref)
    assert a["keys"] == b["keys"]
    np.testing.assert_allclose(a["poses"], b["poses"], atol=pose_atol, rtol=0)


class _Routed(Exception):
    """Raised by a patched ``_solve_compact``: the route is decided."""


def _route(graph, package, **kw):
    """The route ``graph.optimize(**kw)`` takes, without solving."""
    seen = []

    def record(self, sub, chain, iterations, delta, solver, *args):
        seen.append(solver)
        raise _Routed()

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(package.PoseGraph, "_solve_compact", record)
        with pytest.raises(_Routed):
            graph.optimize(**kw)
    return seen[0]


# ------------------------------------------------------------ the tests


@pytest.mark.parametrize("algorithm", ["lm", "gn"])
@pytest.mark.parametrize("route", ROUTES)
def test_route_matches_reference_route(route, algorithm):
    """Each route against the reference's same route on the loopy graph
    (float32, both solved in float64), and tests/test_pose_graph.py's gate:
    within 1e-3 of the dense solve (test_cg_solver_matches_dense,
    test_sparse_direct_matches_dense)."""
    ref, port, h_ref, h_port = _solve_both(lambda: loopy_graph(24, seed=3)[0], iterations=15,
                                           solver=route, algorithm=algorithm)
    _assert_same_solve(ref, port, h_ref, h_port)
    assert port.last_solver == route
    dense = pose_graph_from_reference(loopy_graph(24, seed=3)[0])
    dense.optimize(iterations=15, solver="dense", algorithm=algorithm)
    errs = [_pose_err(dense.vertex_pose(i), port.vertex_pose(i)) for i in range(25)]
    assert max(errs) < 1e-3, max(errs)


def test_schur_matches_dense_small():
    """tests/test_pose_graph.py::test_schur_chain_matches_dense_small on the
    port, and the port's Schur solve against the reference's."""
    ref, port, h_ref, h_port = _solve_both(lambda: loopy_graph(30, seed=3)[0], iterations=12,
                                           solver="schur")
    _assert_same_solve(ref, port, h_ref, h_port)
    dense = pose_graph_from_reference(loopy_graph(30, seed=3)[0])
    h_d = dense.optimize(iterations=12, solver="dense")
    assert h_port[-1] < h_port[0] * 1e-2
    np.testing.assert_allclose(h_port[0], h_d[0], rtol=1e-5)
    errs = [_pose_err(dense.vertex_pose(i), port.vertex_pose(i)) for i in range(31)]
    assert max(errs) < 1e-4, max(errs)


def test_schur_pure_ring_cycle_cut():
    """A pure degree-2 ring: one vertex is demoted to a separator and the
    ring solves as one a == b segment; the same structure and solve as the
    reference's."""
    ref, port, h_ref, h_port = _solve_both(pure_ring, iterations=10, solver="schur")
    _assert_same_solve(ref, port, h_ref, h_port)
    struct = port._chain_structure(max_level=0)
    ref_struct = ref._chain_structure(max_level=0)
    assert len(struct.seg_len) == 1 and struct.seg_a[0] == struct.seg_b[0]
    assert ref._real_sep_count == port._real_sep_count == len(struct.sep_ids)
    assert int(struct.seg_len.sum()) == int(np.asarray(ref_struct.seg_len).sum())
    dense = pose_graph_from_reference(pure_ring())
    dense.optimize(iterations=10, solver="dense")
    errs = [_pose_err(dense.vertex_pose(i), port.vertex_pose(i)) for i in range(24)]
    assert max(errs) < 1e-4, max(errs)


def test_chain_partition_matches_reference():
    """The elimination structure of a graph with chains, loops and a fixed
    vertex: the reference's unpadded structure, array by array."""
    g, _ = loopy_graph(30, seed=3)
    port = pose_graph_from_reference(g)
    n = g.num_vertices
    args = (n, g.edge_i[: g.num_edges], g.edge_j[: g.num_edges], g.edge_active[: g.num_edges],
            np.ones(n, bool), ~g.fixed[:n])
    want = j_pg.chain_partition(*args)
    got = t_pg.chain_partition(*args)
    for name in t_pg.ChainStructure._fields:
        np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert t_pg.chain_partition(3, [0, 1, 2], [1, 2, 0], np.ones(3, bool), np.ones(3, bool),
                                np.zeros(3, bool)) is None
    assert port._chain_structure(0) is not None


def test_edge_matvec_matches_dense_hessian():
    """tests/test_pose_graph.py::test_edge_matvec_matches_dense_hessian on
    the port (float64: to 1e-12), and the same product as the
    reference's."""
    g, _ = loopy_graph(12, seed=7)
    arrays = pose_graph_from_reference(g).to_arrays()
    arrays = arrays._replace(**{k: getattr(arrays, k).to(torch.float64)
                                for k in ("poses", "measurements", "information")})
    H_ii, H_ij, H_jj, b_i, b_j, _ = t_pg.edge_blocks(arrays)
    n = arrays.poses.shape[0]
    free = arrays.vertex_mask & ~arrays.fixed_mask
    H, _ = t_pg._assemble_dense(n, arrays.edge_i, arrays.edge_j, H_ii, H_ij, H_jj, b_i, b_j, free)
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 1, (n, 6)))
    got = t_pg.edge_matvec(arrays.edge_i, arrays.edge_j, H_ii, H_ij, H_jj, free, x)
    want = (H @ x.reshape(-1)).reshape(n, 6)
    # free rows agree to rounding; a gauge row is the identity in the matvec
    # and identity plus the 1e-6 damping in the dense system, in both
    # packages alike
    np.testing.assert_allclose(got[free].numpy(), want[free].numpy(), rtol=1e-12,
                               atol=1e-12 * float(H.abs().max()))
    np.testing.assert_allclose(got[~free].numpy(), want[~free].numpy(), rtol=1.1e-6)
    with jax.enable_x64(True):
        want = j_pg.edge_matvec(*(jnp.asarray(t.numpy()) for t in (
            arrays.edge_i, arrays.edge_j, H_ii, H_ij, H_jj, free, x)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12 * float(H.abs().max()))


def test_cg_iterations_and_tolerance():
    """solve_blocks_cg: the same iteration count as the reference's
    while_loop on the same system, and the same solution."""
    g, _ = loopy_graph(24, seed=3)
    arrays = pose_graph_from_reference(g)._compact_subgraph(0).to_graph_arrays()
    H_ii, H_ij, H_jj, b_i, b_j, _ = t_pg.edge_blocks(arrays)
    n = arrays.poses.shape[0]
    free = arrays.vertex_mask & ~arrays.fixed_mask
    b = t_pg._gradient(arrays, b_i, b_j)
    blocks = (arrays.edge_i, arrays.edge_j, H_ii, H_ij, H_jj, -b, free)
    for iterations, tol in ((256, 1e-6), (5, 1e-6), (256, 1e-10)):
        x, k = t_pg.solve_blocks_cg(n, *blocks, iterations=iterations, tol=tol,
                                    return_iterations=True)
        with jax.enable_x64(True):
            x_ref, k_ref = j_pg.solve_blocks_cg(n, *(jnp.asarray(t.numpy()) for t in blocks),
                                                iterations=iterations, tol=tol,
                                                return_iterations=True)
        assert k == int(k_ref), (iterations, tol, k, int(k_ref))
        np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), rtol=0,
                                   atol=1e-9 * float(x.abs().max()))


@pytest.mark.parametrize("route", ROUTES)
def test_lm_stress_every_route(route):
    """tests/test_pose_graph.py::test_lm_stress_all_solver_paths on the port
    (finite history, final chi2 < 1), against the reference's route where it
    is reproducible (module docstring)."""
    ref, port, h_ref, h_port = _solve_both(lm_stress_graph, iterations=60, solver=route,
                                           algorithm="lm")
    assert np.isfinite(h_port).all() and h_port[-1] < 1.0, h_port[-5:]
    assert h_port.shape == h_ref.shape == (60,)
    assert (np.diff(h_port) <= 1e-9 * np.maximum(h_port[:-1], 1.0)).all()
    if route == "cg":
        return
    np.testing.assert_allclose(h_port[-1], h_ref[-1], rtol=STRESS_CHI2_RTOL)
    a, b = pose_graph_to_numpy(port), pose_graph_to_numpy(ref)
    np.testing.assert_allclose(a["poses"], b["poses"], atol=STRESS_POSE_ATOL, rtol=0)


def test_device_fault_degrades_to_host_sparse(monkeypatch):
    """tests/test_pose_graph.py::test_device_fault_degrades_to_host_sparse on
    both packages: a RuntimeError of the solve warns and degrades to the
    sparse route, which gives the reference's poses."""
    ref, true = ring_graph(10)
    port = pose_graph_from_reference(ref)

    def boom(*a, **k):
        raise RuntimeError("solver fault")

    monkeypatch.setattr(j_pg.PoseGraph, "_solve_compact", boom)
    monkeypatch.setattr(t_pg.PoseGraph, "_solve_compact", boom)
    with pytest.warns(UserWarning, match="falling back"):
        h_ref = ref.optimize(iterations=20)
    with pytest.warns(UserWarning, match="falling back"):
        h_port = port.optimize(iterations=20)
    assert port.last_solver == "sparse"
    _assert_same_solve(ref, port, h_ref, h_port)
    assert h_port[-1] < h_port[0]
    for i in range(10):
        assert _pose_err(port.vertex_pose(i), true[i]) < 2e-2, i
    # the sparse route itself does not degrade
    monkeypatch.setattr(t_pg.PoseGraph, "_optimize_sparse_direct", boom)
    with pytest.raises(RuntimeError, match="solver fault"):
        port.optimize(iterations=2, solver="sparse", tol=0.0)


@pytest.mark.parametrize("route", ROUTES)
def test_early_exit_matches_reference(route):
    """A tol-terminated solve on each route: the same history (the sparse
    route's ends where its loop does, plus the final chi2) and poses as the
    reference's."""
    ref, port, h_ref, h_port = _solve_both(lambda: ring_graph(12, loops=[(2, 8)])[0],
                                           iterations=60, solver=route, tol=1e-8)
    _assert_same_solve(ref, port, h_ref, h_port)
    assert (port._converged_memo is None) == (ref._converged_memo is None)


def test_memo_defect_kept():
    """The reference's convergence memo trusts the last two history entries
    (pose_graph.py:1631): a budget that ends in a rejected LM step is
    memoized as converged, and a later optimize() of the same state, even
    with a larger budget, returns that history without solving.  The port
    keeps the defect (ROADMAP queue C): on the stress graph both packages
    memoize optimize(6) (chi2 136.5, the optimum is below 1e-3) and answer
    optimize(60) from the memo."""
    ref, port, h_ref, h_port = _solve_both(lm_stress_graph, iterations=6, solver="dense",
                                           tol=1e-8)
    np.testing.assert_allclose(h_port, h_ref, rtol=STRESS_CHI2_RTOL)
    assert h_port[-1] == h_port[-2] > 100.0
    for graph, package in ((ref, j_pg), (port, t_pg)):
        assert graph._converged_memo is not None
        solves = []
        original = package.PoseGraph._solve_compact
        with pytest.MonkeyPatch.context() as mp, jax.enable_x64(graph is ref):
            mp.setattr(package.PoseGraph, "_solve_compact",
                       lambda self, *a, **k: (solves.append(1), original(self, *a, **k))[1])
            again = graph.optimize(60, solver="dense", tol=1e-8)
        assert solves == [] and len(again) == 6


def test_edge_diagnostics_and_outlier_removal_match_reference():
    """test_robust_kernel_downweights_bad_edge on both packages: after the
    solve the weights and chi2 agree (rtol 1e-4, the graph's float32), the
    bogus loop edge is flagged and removed in both; the diagnostics are
    memoized until the state changes."""
    n = 6
    true = [np.eye(4)]
    for _ in range(n):
        true.append(true[-1] @ _exp([0.3, 0.0, 0.0, 0.0, 0.0, 0.1]))
    ref = j_pg.PoseGraph()
    ref.add_vertex(0, np.eye(4), fixed=True)
    for i in range(n):
        ref.add_vertex(i + 1, true[i + 1])
        ref.add_edge(i, i + 1, _rel(true[i], true[i + 1]), 1e4 * np.eye(6))
    bogus = ref.add_edge(0, n, _exp([5.0, 3.0, -2.0, 0.5, 0.5, 0.5]), 1e4 * np.eye(6),
                         robust=True)
    ref.optimize(iterations=15)
    port = pose_graph_from_reference(ref)  # the same poses into both diagnostics
    w, chi2 = port.edge_diagnostics()
    w_ref, chi2_ref = ref.edge_diagnostics()
    assert w.dtype == np.float32 and w.shape == w_ref.shape == (n + 1,)
    np.testing.assert_allclose(w, w_ref, rtol=1e-4)
    np.testing.assert_allclose(chi2, chi2_ref, rtol=1e-4, atol=1e-6)
    assert w[bogus] < 0.01 and w[:n].min() > 0.9
    w2, _ = port.edge_diagnostics()
    assert port._diag_memo is not None and np.array_equal(w, w2)
    assert port.remove_outlier_edges(0.1) == ref.remove_outlier_edges(0.1) == 1
    assert not port.edge_active[bogus]
    np.testing.assert_array_equal(port.edge_active, ref.edge_active)
    assert port.remove_outlier_edges(0.1) == 0


def test_outlier_removal_worst_first_and_capped():
    """remove_outlier_edges(n_max): the worst-weighted robust edges go
    first, as the reference picks them."""
    ref, _ = loopy_graph(24, seed=3)
    for k in range(ref.num_edges):
        if ref.robust[k]:
            ref.measurements[k] = ref.measurements[k] @ _exp([0.3 * k, 0, 0, 0, 0.1, 0])
    port = pose_graph_from_reference(ref)
    assert port.remove_outlier_edges(0.99, n_max=2) == ref.remove_outlier_edges(0.99, n_max=2) == 2
    np.testing.assert_array_equal(port.edge_active, ref.edge_active)


def test_auto_routes_like_the_reference():
    """``auto`` beyond the dense cap decides as the reference does: a ring of
    chains with few separators -> schur, a SLAM-like graph (most vertices
    separators) -> sparse, past SPARSE_DIRECT_MAX_VERTICES -> cg (the cap
    lowered to 140 in both packages, to keep the graph small); the dense
    final pass's shape at 150 frames solves like the reference's sparse
    route."""
    cases = {
        "schur": lambda: ring_graph(140)[0],
        "sparse": lambda: slam_graph(150)[0],
        "cg": lambda: ladder_graph(150),
    }
    for want, build in cases.items():
        ref = build()
        port = pose_graph_from_reference(ref)
        assert port.num_vertices > t_pg.PoseGraph.DENSE_SOLVER_MAX_VERTICES
        with pytest.MonkeyPatch.context() as mp:
            if want == "cg":
                for package in (j_pg, t_pg):
                    mp.setattr(package.PoseGraph, "SPARSE_DIRECT_MAX_VERTICES", 140)
            assert _route(ref, j_pg, iterations=3) == _route(port, t_pg, iterations=3) == want
        assert port._real_sep_count == ref._real_sep_count
    ref, port, h_ref, h_port = _solve_both(lambda: slam_graph(150)[0], iterations=10)
    assert port.last_solver == "sparse"
    _assert_same_solve(ref, port, h_ref, h_port)


def test_forced_schur_without_chains_takes_dense_or_cg():
    """solver="schur" on a graph with nothing to eliminate takes the dense
    route (cg beyond the cap), as the reference's policy does."""
    for frames, want in ((40, "dense"), (150, "cg")):
        ref = ladder_graph(frames)
        port = pose_graph_from_reference(ref)
        assert _route(ref, j_pg, iterations=2, solver="schur") == want
        assert _route(port, t_pg, iterations=2, solver="schur") == want
    with pytest.raises(ValueError, match="unknown solver"):
        pose_graph_from_reference(ring_graph(12)[0]).optimize(2, solver="qr")


def test_schur_structure_cached_with_the_subgraph():
    """The chain structure is computed once per structure version and
    reused by later rounds (the final pass's ten rounds)."""
    port = pose_graph_from_reference(ring_graph(140)[0])
    calls = []
    original = t_pg._Subgraph.chain_structure
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_pg._Subgraph, "chain_structure",
                   lambda self: (calls.append(1), original(self))[1])
        for _ in range(3):
            port.optimize(2, tol=0.0)
        assert len(calls) == 1 and port.last_solver == "schur"
        port.set_all_edge_levels(0)
        port.optimize(2, tol=0.0)
        assert len(calls) == 2
    g = copy.deepcopy(port)
    assert g.optimize(1, solver="schur").shape == (1,)
