"""The port's pose graph (the container and the dense route) against the
reference, on the CPU (the other routes: test_torch_pose_graph_solvers.py).

Each case of ``tests/test_pose_graph.py`` that the dense route serves is
built in the reference's ``PoseGraph``, copied into the port's with
``convert.pose_graph_from_reference``, and optimized by both.  The port
solves in float64 on the CPU, the branch the reference takes on an
accelerator; so a float64 graph is held against the reference under
``jax.enable_x64(True)``: poses within 1e-9, chi2 history within rtol
1e-9 and the same number of solver steps (the reference's counted op by
op under ``jax.disable_jit``, where its ``lax.while_loop`` is a Python
loop).  A float32 graph is held against the reference's float32 CPU run:
poses within 1e-5.  Each case keeps its reference test's own assertions on
the port.  Every ``solver`` name runs; an unknown one raises.
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

POSE_ATOL_F64 = 1e-9
HISTORY_RTOL_F64 = 1e-9
POSE_ATOL_F32 = 1e-5
# the LM stress graph (rotation information 1e-4 beside loop edges of 1e4)
# is conditioned so that the reference's compiled and op-by-op runs differ
# by 1.8e-7 in the poses and 8.6e-7 relative in the history: the port is
# held to 1e-6 and rtol 1e-5 there
STRESS_TOLERANCES = (1e-6, 1e-5)
STRESS_CASES = ("lm-stress", "gn-stress")


def _exp(xi):
    return np.asarray(j_se3.exp_se3(jnp.asarray(np.asarray(xi, np.float32))))


def _rel(Ta, Tb):
    return np.linalg.inv(Ta) @ Tb


def _pose_err(Ta, Tb):
    rel = _rel(np.asarray(Ta, np.float64), np.asarray(Tb, np.float64))
    return np.abs(np.asarray(j_se3.log_se3(jnp.asarray(rel, jnp.float32)))).max()


# ------------------------------------------------------------ the graphs
# (tests/test_pose_graph.py, each with the graph's dtype as a parameter)


def two_vertex_chain(dtype):
    g = j_pg.PoseGraph(dtype=dtype)
    g.add_vertex(0, np.eye(4), fixed=True)
    g.add_vertex(1, np.eye(4))
    g.add_edge(0, 1, _exp([0.3, -0.1, 0.2, 0.05, -0.02, 0.1]), np.eye(6))
    return g


def noise_averaging(dtype):
    true = [np.eye(4)]
    for _ in range(4):
        true.append(true[-1] @ _exp([0.2, 0.0, 0.1, 0.0, 0.05, 0.0]))
    g = j_pg.PoseGraph(dtype=dtype)
    g.add_vertex(0, np.eye(4), fixed=True)
    for i in range(1, 5):
        g.add_vertex(i, np.eye(4))
    for i in range(4):
        g.add_edge(i, i + 1, _rel(true[i], true[i + 1]), np.eye(6))
    g.add_edge(0, 4, _rel(true[0], true[4]), np.eye(6))
    return g


def loop_closure(dtype):
    n = 8
    true = [np.eye(4)]
    for _ in range(n):
        true.append(true[-1] @ _exp([0.5, 0.0, 0.0, 0.0, 0.0, 2 * np.pi / n]))
    rng = np.random.default_rng(1)
    g = j_pg.PoseGraph(dtype=dtype)
    pose = np.eye(4)
    g.add_vertex(0, pose, fixed=True)
    for i in range(n):
        meas = _rel(true[i], true[i + 1]) @ _exp(rng.normal(0, 0.02, 6))
        pose = pose @ meas
        g.add_vertex(i + 1, pose)
        g.add_edge(i, i + 1, meas, np.eye(6))
    g.add_edge(0, n, _rel(true[0], true[n]), 100.0 * np.eye(6), robust=True)
    return g


def robust_edge(dtype):
    n = 6
    true = [np.eye(4)]
    for _ in range(n):
        true.append(true[-1] @ _exp([0.3, 0.0, 0.0, 0.0, 0.0, 0.1]))
    g = j_pg.PoseGraph(dtype=dtype)
    g.add_vertex(0, np.eye(4), fixed=True)
    for i in range(n):
        g.add_vertex(i + 1, true[i + 1])
        g.add_edge(i, i + 1, _rel(true[i], true[i + 1]), 1e4 * np.eye(6))
    g.add_edge(0, n, _exp([5.0, 3.0, -2.0, 0.5, 0.5, 0.5]), 1e4 * np.eye(6), robust=True)
    return g


def capacity_growth(dtype):
    g = j_pg.PoseGraph(vertex_capacity=2, edge_capacity=2, dtype=dtype)
    true = [np.eye(4)]
    for _ in range(9):
        true.append(true[-1] @ _exp([0.1, 0.0, 0.0, 0.0, 0.0, 0.05]))
    g.add_vertex(0, np.eye(4), fixed=True)
    for i in range(9):
        g.add_vertex(i + 1, np.eye(4))
        g.add_edge(i, i + 1, _rel(true[i], true[i + 1]), np.eye(6))
    return g


def gauge_auto_fix(dtype):
    g = j_pg.PoseGraph(dtype=dtype)
    g.add_vertex("a", np.eye(4))
    g.add_vertex("b", np.eye(4))
    g.add_edge("a", "b", _exp([0.1, 0.2, 0.0, 0.0, 0.0, 0.1]), np.eye(6))
    return g


def lm_stress(dtype):
    rng = np.random.default_rng(1)
    n = 40
    true = [np.eye(4)]
    step = _exp([0.5, 0, 0, 0, 0, 0.0])
    for _ in range(n - 1):
        true.append(true[-1] @ step)
    g = j_pg.PoseGraph(vertex_capacity=64, edge_capacity=64, dtype=dtype)
    g.add_vertex(0, true[0], fixed=True)
    for i in range(1, n):
        g.add_vertex(i, true[i] @ _exp(rng.normal(0, 0.8, 6)))
    info = np.diag([1.0, 1.0, 1.0, 1e-4, 1e-4, 1e-4])
    for i in range(n - 1):
        g.add_edge(i, i + 1, _rel(true[i], true[i + 1]), info)
    g.add_edge(0, n - 1, _exp([3.0, 2.0, 0.0, 0.0, 0.0, 1.0]), 1e4 * np.eye(6))
    g.add_edge(5, 30, _exp([-2.0, 4.0, 1.0, 0.5, 0.0, 0.0]), 1e4 * np.eye(6))
    return g


def ring(dtype, n=12, loops=((2, 8),)):
    rng = np.random.default_rng(7)
    step = [0.4, 0.0, 0.0, 0.0, 0.0, 2 * np.pi / n]
    true = [np.eye(4)]
    for _ in range(n - 1):
        true.append(true[-1] @ _exp(step))
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
    return g


def compaction(dtype):
    """Keyframe chain at level 0 plus level-2 odometry vertices: the
    subgraph case of test_subgraph_compaction_matches_full_solve."""
    kf = [np.eye(4)]
    for _ in range(4):
        kf.append(kf[-1] @ _exp([0.3, 0.0, 0.0, 0.0, 0.0, 0.2]))
    g = j_pg.PoseGraph(dtype=dtype)
    for i in range(5):
        g.add_vertex(("kf", i), kf[0] if i == 0 else np.eye(4), fixed=i == 0)
    for i in range(4):
        g.add_edge(("kf", i), ("kf", i + 1), _rel(kf[i], kf[i + 1]), np.eye(6), level=0)
    for i in range(6):
        g.add_vertex(("f", i), np.eye(4))
    for i in range(5):
        g.add_edge(("f", i), ("f", i + 1), _exp([0.1, 0, 0, 0, 0, 0]), np.eye(6), level=2)
    return g


# name -> (graph function, optimize() keyword arguments)
CASES = {
    "two-vertex-chain": (two_vertex_chain, dict(iterations=10)),
    "noise-averaging": (noise_averaging, dict(iterations=20)),
    "loop-closure": (loop_closure, dict(iterations=30)),
    "robust-edge": (robust_edge, dict(iterations=15)),
    "capacity-growth": (capacity_growth, dict(iterations=25)),
    "gauge-auto-fix": (gauge_auto_fix, dict(iterations=10)),
    "lm-stress": (lm_stress, dict(iterations=60, solver="dense", algorithm="lm")),
    "compaction": (compaction, dict(iterations=15, max_level=0)),
    "lm-early-exit": (ring, dict(iterations=60, tol=1e-8)),
    "lm-full-budget": (ring, dict(iterations=60, tol=0.0)),
    "gn": (noise_averaging, dict(iterations=8, algorithm="gn")),
    # in float64 fixed-damping GN does not diverge on the stress graph, in
    # the reference's accelerator branch as in the port (its float32 CPU
    # run does, which tests/test_pose_graph.py pins)
    "gn-stress": (lm_stress, dict(iterations=60, solver="dense", algorithm="gn")),
    "dense-level-2": (compaction, dict(iterations=15, max_level=2, solver="dense")),
}


def _counting(module, name, count):
    """``module.name`` wrapped to add one to ``count[0]`` per call."""
    original = getattr(module, name)

    def counted(*args, **kwargs):
        count[0] += 1
        return original(*args, **kwargs)

    return counted


def _step_function(kw):
    """The function that runs once per solver step of ``optimize(**kw)``."""
    return "_solve_step" if kw.get("algorithm", "lm") == "lm" else "gauss_newton_iteration"


def _reference_steps(graph, kw):
    """The reference's LM steps for ``graph.optimize(**kw)``: its dense loop
    run op by op on the promoted subgraph, each step counted."""
    sub = graph._compact_subgraph(kw.get("max_level", 0))
    arrays = jax.tree.map(lambda x: x.astype(jnp.float64) if x.dtype == jnp.float32 else x,
                          sub.to_graph_arrays())
    count = [0]
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        mp.setattr(j_pg, "_solve_step", _counting(j_pg, "_solve_step", count))
        j_pg.optimize_lm(arrays, kw["iterations"], tol=kw.get("tol", 1e-8))
    return count[0]


def _port_steps(graph, kw):
    """(history, solver steps) of the port's ``graph.optimize(**kw)``."""
    count = [0]
    name = _step_function(kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_pg, name, _counting(t_pg, name, count))
        history = graph.optimize(**kw)
    return history, count[0]


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimize_float64_matches_reference(case):
    build, kw = CASES[case]
    with jax.enable_x64(True):
        ref = build(np.float64)
        port = pose_graph_from_reference(ref)
        before = pose_graph_to_numpy(port)
        h_ref = ref.optimize(**kw)
    h_port, port_steps = _port_steps(port, kw)
    assert h_port.dtype == np.float64 and h_port.shape == h_ref.shape
    pose_atol, rtol = STRESS_TOLERANCES if case in STRESS_CASES else (POSE_ATOL_F64,
                                                                       HISTORY_RTOL_F64)
    # below rtol x the first chi2 an entry is rounding dust (an exact graph
    # converges to ~1e-30), compared absolutely; the steps taken above that
    # floor are equal, and all steps where the solve stops above it
    floor = rtol * h_ref[0]
    np.testing.assert_allclose(h_port, h_ref, rtol=rtol, atol=floor)
    assert np.sum(h_port > floor) == np.sum(h_ref > floor)
    if kw.get("algorithm", "lm") == "gn" or kw.get("tol", 1e-8) == 0.0:
        assert port_steps == kw["iterations"]
    elif h_ref[-1] > floor:
        with jax.enable_x64(True):
            ref_steps = _reference_steps(pose_graph_from_reference_copy(before, ref), kw)
        assert port_steps == ref_steps, (port_steps, ref_steps)
    a, b = pose_graph_to_numpy(port), pose_graph_to_numpy(ref)
    assert a["keys"] == b["keys"]
    np.testing.assert_allclose(a["poses"], b["poses"], atol=pose_atol, rtol=0)
    for name in ("fixed", "edge_i", "edge_j", "measurements", "information", "edge_active",
                 "robust", "edge_level"):
        np.testing.assert_array_equal(a[name], b[name])


def pose_graph_from_reference_copy(state, ref):
    """A fresh reference graph holding ``state`` (pose_graph_to_numpy) with
    the structure of ``ref``: the input of the step count."""
    g = copy.deepcopy(ref)
    g.poses[: g.num_vertices] = state["poses"]
    g._touch_poses()
    return g


F32_CASES = sorted(set(CASES) - set(STRESS_CASES) - {"gn"})
# the reference's own float32 CPU solve is 1.2e-5 (robust edge, information
# 1e4) and 9.1e-4 (the level-2 chain) off its float64 solve of the same
# case: the port is held to its accelerator branch there
F32_OFF_CASES = ("robust-edge", "dense-level-2")


def _reference_accelerator_branch(graph, kw):
    """The reference's solve of ``graph.optimize(**kw)`` as it runs with an
    accelerator as the default backend (pose_graph.py:1706-1721): the
    compacted subgraph promoted to float64 into its jitted dense loop.
    Returns the poses [n, 4, 4] in the graph's dtype."""
    sub = graph._compact_subgraph(kw.get("max_level", 0))
    with jax.enable_x64(True):
        arrays = jax.tree.map(lambda x: x.astype(jnp.float64) if x.dtype == jnp.float32 else x,
                              sub.to_graph_arrays())
        if kw.get("algorithm", "lm") == "lm":
            out, _ = j_pg._optimize_lm_jit(arrays, kw["iterations"], j_pg.CAUCHY_DELTA, "dense",
                                           256, kw.get("tol", 1e-8))
        else:
            out, _ = j_pg._optimize_jit(arrays, kw["iterations"], j_pg.CAUCHY_DELTA, "dense", 256)
    poses = graph.poses[: graph.num_vertices].copy()
    poses[sub.vidx] = np.asarray(out.poses)[: sub.n].astype(graph.dtype)
    return poses


@pytest.mark.parametrize("case", F32_CASES)
def test_optimize_float32_matches_reference(case):
    """A float32 graph: the reference solves it in float32 on the CPU, the
    port in float64.  Poses within 1e-5 of the reference's float32 run
    (but for F32_OFF_CASES), and within 1e-7 (the float32 storage) of the
    reference's accelerator branch."""
    build, kw = CASES[case]
    ref = build(np.float32)
    port = pose_graph_from_reference(ref)
    branch = _reference_accelerator_branch(build(np.float32), kw)
    h_ref = ref.optimize(**kw)
    h_port = port.optimize(**kw)
    assert h_port.shape == h_ref.shape and port.poses.dtype == np.float32
    n = port.num_vertices
    np.testing.assert_allclose(port.poses[:n], branch, atol=1e-7, rtol=0)
    if case not in F32_OFF_CASES:
        np.testing.assert_allclose(port.poses[:n], ref.poses[:n], atol=POSE_ATOL_F32, rtol=0)


def test_reference_assertions_hold_on_the_port():
    """The reference tests' own gates, on the port's graphs."""
    g = pose_graph_from_reference(two_vertex_chain(np.float32))
    hist = g.optimize(iterations=10)
    assert _pose_err(g.vertex_pose(1), _exp([0.3, -0.1, 0.2, 0.05, -0.02, 0.1])) < 1e-4
    assert hist[-1] < 1e-6

    g = pose_graph_from_reference(gauge_auto_fix(np.float32))
    g.optimize(iterations=10)
    assert _pose_err(g.vertex_pose("a"), np.eye(4)) < 1e-5
    assert _pose_err(g.vertex_pose("b"), _exp([0.1, 0.2, 0.0, 0.0, 0.0, 0.1])) < 1e-4

    g_lm = pose_graph_from_reference(lm_stress(np.float64))
    hist_lm = g_lm.optimize(60, solver="dense", algorithm="lm")
    assert np.isfinite(hist_lm).all() and hist_lm[-1] < 1e-1
    assert (np.diff(hist_lm) <= 1e-9 * np.maximum(hist_lm[:-1], 1.0)).all()

    g_full = pose_graph_from_reference(ring(np.float32))
    g_tol = pose_graph_from_reference(ring(np.float32))
    h_full = g_full.optimize(iterations=60, tol=0.0)
    h_tol = g_tol.optimize(iterations=60, tol=1e-8)
    assert len(h_tol) == 60 and np.all(np.diff(h_tol) <= 1e-9)
    np.testing.assert_allclose(h_tol[-1], h_full[-1], rtol=1e-4, atol=1e-10)

    g = pose_graph_from_reference(compaction(np.float32))
    untouched = g.poses[5:11].copy()
    g.optimize(iterations=15, max_level=0)
    np.testing.assert_array_equal(g.poses[5:11], untouched)


def test_structure_cache_reused_across_rounds_and_invalidated():
    """tests/test_pose_graph.py's case on the port: rounds with no
    structural change reuse the compacted subgraph and give the poses of a
    cache-cold solve; every structural mutator invalidates."""
    g1 = pose_graph_from_reference(ring(np.float32, 24, ((3, 12), (8, 20))))
    g2 = pose_graph_from_reference(ring(np.float32, 24, ((3, 12), (8, 20))))
    compactions = []
    orig = g1._compact_subgraph
    g1._compact_subgraph = lambda ml: (compactions.append(1), orig(ml))[1]
    for _ in range(3):
        g1.optimize(4, algorithm="lm", tol=0.0)
    assert len(compactions) == 1
    for _ in range(3):
        g2._touch_structure()
        g2.optimize(4, algorithm="lm", tol=0.0)
    np.testing.assert_array_equal(g1.poses[: g1.num_vertices], g2.poses[: g2.num_vertices])
    g1.add_edge(5, 15, np.eye(4), np.eye(6))
    g1.optimize(1)
    g1.set_edge_level(g1.num_edges - 1, 2)
    g1.optimize(1)
    g1.deactivate_edges([g1.num_edges - 1])
    g1.optimize(1)
    g1.set_all_edge_levels(0)
    g1.optimize(1)
    assert len(compactions) == 5
    g1.optimize(1)
    assert len(compactions) == 5


def test_convergence_memo_skips_resolves_and_invalidates():
    """tests/test_pose_graph.py's case on the port, and the same number of
    solves as the reference's graph on the same calls."""
    counts = []
    for g in (ring(np.float32, 24, ((3, 12), (8, 20))),):
        for graph in (g, pose_graph_from_reference(g)):
            solves = []
            orig = graph._solve_compact
            graph._solve_compact = lambda *a, _o=orig, _s=solves, **k: (_s.append(1), _o(*a, **k))[1]
            for _ in range(6):
                graph.optimize(8, algorithm="lm", tol=1e-8)
            n_to_converge = len(solves)
            poses = graph.poses[: graph.num_vertices].copy()
            h_memo = graph.optimize(8, algorithm="lm", tol=1e-8)
            assert len(solves) == n_to_converge
            assert abs(h_memo[-1] - h_memo[-2]) <= 1e-8 * abs(h_memo[-1])
            np.testing.assert_array_equal(graph.poses[: graph.num_vertices], poses)
            graph.set_vertex_pose(5, graph.vertex_pose(5) @ _exp([0.01, 0, 0, 0, 0, 0]))
            graph.optimize(8, algorithm="lm", tol=1e-8)
            assert len(solves) == n_to_converge + 1
            for _ in range(6):
                graph.optimize(8, algorithm="lm", tol=1e-8)
            n_now = len(solves)
            graph.add_edge(2, 17, np.eye(4), np.eye(6))
            graph.optimize(8, algorithm="lm", tol=1e-8)
            assert len(solves) == n_now + 1
            counts.append(len(solves))
    assert counts[0] == counts[1], counts
    g2 = pose_graph_from_reference(ring(np.float32))
    s2 = []
    orig2 = g2._solve_compact
    g2._solve_compact = lambda *a, **k: (s2.append(1), orig2(*a, **k))[1]
    g2.optimize(4, algorithm="lm", tol=0.0)
    g2.optimize(4, algorithm="lm", tol=0.0)
    assert len(s2) == 2


@pytest.mark.parametrize("solver", ["cg", "schur", "sparse"])
def test_unported_solvers_raise(solver):
    """The routes that raised before they were ported now run, on the float64
    ring, to the reference's poses (within 1e-9) and history (rtol 1e-9);
    an unknown solver still raises."""
    with jax.enable_x64(True):
        ref = ring(np.float64)
        g = pose_graph_from_reference(ref)
        h_ref = ref.optimize(5, solver=solver)
    h = g.optimize(5, solver=solver)
    assert g.last_solver == solver and h.shape == h_ref.shape
    np.testing.assert_allclose(h, h_ref, rtol=HISTORY_RTOL_F64)
    np.testing.assert_allclose(g.poses[: g.num_vertices], ref.poses[: ref.num_vertices],
                               atol=POSE_ATOL_F64, rtol=0)
    with pytest.raises(ValueError, match="unknown solver"):
        g.optimize(5, solver="qr")


def test_auto_beyond_the_dense_cap_raises():
    """``auto`` on 130 active vertices no longer raises: it takes the route
    the reference takes (a ring of one chain: schur) to the reference's
    poses; "dense" still serves the same graph."""
    with jax.enable_x64(True):
        ref = ring(np.float64, n=130, loops=())
        g = pose_graph_from_reference(ref)
        dense = pose_graph_from_reference(ref)
        h_ref = ref.optimize(2)
    h = g.optimize(2)
    assert g.last_solver == "schur" and h.shape == h_ref.shape == (2,)
    np.testing.assert_allclose(h, h_ref, rtol=HISTORY_RTOL_F64)
    np.testing.assert_allclose(g.poses[: g.num_vertices], ref.poses[: ref.num_vertices],
                               atol=POSE_ATOL_F64, rtol=0)
    assert dense.optimize(2, solver="dense").shape == (2,) and dense.last_solver == "dense"


def test_container_round_trip():
    """The container's bookkeeping: capacity growth, keys, edge lookup,
    renaming, edge levels, fixing."""
    ref = capacity_growth(np.float32)
    g = pose_graph_from_reference(ref)
    assert len(g.poses) == len(ref.poses) == 16 and g.num_edges == 9
    for name, value in pose_graph_to_numpy(ref).items():
        got = pose_graph_to_numpy(g)[name]
        if name == "keys":
            assert got == value
        else:
            np.testing.assert_array_equal(got, value)
    assert g.find_edge(3, 4) == ref.find_edge(3, 4) == 3
    assert g.find_edge(0, 5) is None
    g.rename_vertex(9, "last")
    ref.rename_vertex(9, "last")
    assert g.vertex_keys() == ref.vertex_keys()
    for graph in (g, ref):
        graph.set_edge_level(2, 2)
        graph.set_fixed("last")
    assert [e[:2] + e[4:] for e in g.edge_list()] == [e[:2] + e[4:] for e in ref.edge_list()]
    arrays = g.to_arrays()
    assert arrays.poses.shape == (16, 4, 4) and int(arrays.vertex_mask.sum()) == 10
