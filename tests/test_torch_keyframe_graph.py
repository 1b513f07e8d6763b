"""The port's ``KeyframeGraph`` against the reference, on the CPU.

The same local maps go into both back ends: four maps of three frames on a
noisy 60x80 circle (``tests/test_keyframe_graph.py``'s intrinsics and
tracker config), built by hand from the ground truth with perturbed
measurements, each map's keyframe the previous map's last frame as
``LocalTracker`` makes them.  Synchronously (``use_threading=False``),
each map's insertion, constraint search, validation waves and incremental
optimization, then the final pass: the keyframes, vertex keys, edges (ends,
levels, robust flags) and timestamps equal the reference's, before and
after the final optimization; the accepted loop edges are the same pairs;
poses agree within 1e-4 (the reference solves its float32 graph in float32
on the CPU, the port in float64).  Then the cases of
``tests/test_keyframe_graph.py`` that need no tracker, run on the port as
the reference's run (threading default, worker poisoning, the final
schedule, callbacks on the worker, the final re-search's frame budget), and
the threaded back end against the synchronous one.
"""

import time

import numpy as np
import pytest
import torch

from dvo_slam_tpu.config import GraphConfig, TrackerConfig
from dvo_slam_tpu.models.frames import Frame as JFrame
from dvo_slam_tpu.models.keyframe_graph import KeyframeGraph as JKeyframeGraph
from dvo_slam_tpu.models.local_map import LocalMap as JLocalMap
from dvo_slam_tpu.models.streaming import _ReplayEvaluation
from dvo_slam_tpu.ops import se3 as j_se3
from dvo_slam_tpu.ops.camera import Intrinsics
from dvo_slam_tpu.utils import synthetic

from dvo_slam_tpu_torch import convert
from dvo_slam_tpu_torch.config import GraphConfig as TGraphConfig
from dvo_slam_tpu_torch.config import TrackerConfig as TTrackerConfig
from dvo_slam_tpu_torch.models import keyframe_graph as t_kg
from dvo_slam_tpu_torch.models.evaluation import RestoredEvaluation
from dvo_slam_tpu_torch.models.frames import Keyframe as TKeyframe
from dvo_slam_tpu_torch.models.local_map import LocalMap as TLocalMap

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

K = Intrinsics(80.0, 80.0, 39.5, 29.5)
SHAPE = (60, 80)
TCFG = TrackerConfig(first_level=1, last_level=0, max_iterations_per_level=25,
                     precision=1e-4, use_initial_estimate=True)
GCFG = GraphConfig(new_constraint_min_entropy_ratio_coarse=0.03,
                   new_constraint_min_entropy_ratio_fine=0.3, optimization_iterations=16,
                   final_optimization_iterations=60, optimization_remove_outliers=True,
                   optimization_outlier_weight_threshold=0.1,
                   final_optimization_remove_outliers=True,
                   final_optimization_outlier_weight_threshold=0.1)
MAP_FRAMES = 3
POSE_ATOL = 1e-4


def _exp(xi):
    return np.asarray(j_se3.exp_se3(np.asarray(xi, np.float32)), np.float64)


@pytest.fixture(scope="module")
def sequence():
    """(poses, reference frames) of 13 noisy frames on a 5 cm circle."""
    poses = synthetic.circular_trajectory(4 * MAP_FRAMES + 1, radius=0.05, rot_amplitude=0.03)
    frames = []
    for i, pose in enumerate(poses):
        i_, d_, v_ = synthetic.render_frame(pose, K, SHAPE, seed=i, depth_noise=0.002,
                                            intensity_noise=1.0)
        frames.append(JFrame.from_arrays(i_, d_, v_, i / 30.0, TCFG.num_levels))
    return poses, frames


def _maps(package, poses, frames):
    """Four local maps of MAP_FRAMES frames: map m's keyframe is frame
    3m; per frame a keyframe edge and (but the first) an odometry edge, the
    measurements the ground truth perturbed by 1 mm / 1 mrad."""
    rng = np.random.default_rng(0)
    info = np.diag([4e4] * 3 + [1e5] * 3)
    local_map, evaluation = ((JLocalMap, _ReplayEvaluation) if package == "reference" else
                             (TLocalMap, lambda v: RestoredEvaluation(
                                 {"kind": "loglik", "first": v, "average": v, "n": 1.0})))
    out = []
    for m in range(4):
        kf = MAP_FRAMES * m
        lm = local_map.create(frames[kf], poses[kf])
        for i in range(kf + 1, kf + MAP_FRAMES + 1):
            lm.add_frame(frames[i])
            noise = lambda: _exp(rng.normal(0, 1e-3, 6))  # noqa: E731
            if i > kf + 1:
                lm.add_odometry_measurement(np.linalg.inv(poses[i - 1]) @ poses[i] @ noise(), info)
            lm.add_keyframe_measurement(np.linalg.inv(poses[kf]) @ poses[i] @ noise(), info)
        lm.evaluation = evaluation(100.0 + 10.0 * m)
        out.append(lm)
    return out


def _graph_state(kg):
    g = kg.graph
    edges = sorted((str(i), str(j), bool(r), int(lv)) for i, j, _, _, r, lv in g.edge_list())
    keys = g.vertex_keys()
    return {
        "keyframes": [k.id for k in kg.keyframes],
        "keys": keys,
        "edges": edges,
        "stamps": {str(k): kg.timestamps[k] for k in keys},
        "poses": np.stack([np.asarray(g.vertex_pose(k), np.float64) for k in keys]),
        "loops": sorted((str(i), str(j)) for i, j, _, _, r, _ in g.edge_list() if r),
    }


@pytest.fixture(scope="module")
def graphs(sequence):
    """Both back ends fed the same maps: their states after the maps and
    after the final optimization."""
    poses, frames = sequence
    port_frames = [convert.frame_from_reference(f, device="cpu") for f in frames]
    ref = JKeyframeGraph(K, GCFG, TCFG, use_threading=False)
    port = t_kg.KeyframeGraph(K, convert.config_from_reference(GCFG),
                              convert.config_from_reference(TCFG), use_threading=False)
    states = []
    for kg, maps in ((ref, _maps("reference", poses, frames)),
                     (port, _maps("port", poses, port_frames))):
        for m in maps:
            kg.add(m)
        before = _graph_state(kg)
        kg.final_optimization()
        states.append((before, _graph_state(kg), kg))
    return states


def _assert_same(a, b):
    for name in ("keyframes", "keys", "edges", "stamps", "loops"):
        assert a[name] == b[name], name
    np.testing.assert_allclose(a["poses"], b["poses"], atol=POSE_ATOL, rtol=0)


def test_graph_matches_reference_on_the_same_maps(graphs):
    (ref_before, ref_after, _), (before, after, port) = graphs
    _assert_same(before, ref_before)
    _assert_same(after, ref_after)
    assert len(after["loops"]) > 0  # the loop closes
    assert after["keyframes"] == [1, 2, 3, 4]
    # the phase timers of the reference's taxonomy
    assert {"constraint_search", "constraint_validation", "constraint_insert",
            "final_optimization"} <= set(port.timers.summary())


def test_edge_levels_and_structure(graphs):
    """tests/test_keyframe_graph.py::test_graph_structure_invariants and
    ::test_edge_levels_before_final on the port's graph."""
    (_, _, _), (before, after, kg) = graphs
    levels = [e[3] for e in before["edges"]]
    assert t_kg.ODOMETRY_EDGE_LEVEL in levels and 0 in levels
    g = kg.graph
    kf_ids = [k.id for k in kg.keyframes]
    for k in kg.keyframes:
        assert g.has_vertex(("kf", k.id)) and ("kf", k.id) in kg.timestamps
    for key in g.vertex_keys():
        assert key in kg.timestamps
    for a, b in zip(kf_ids[:-1], kf_ids[1:]):
        e = g.find_edge(("kf", a), ("kf", b))
        assert e is not None and g.edge_level[e] == 0, (a, b)
    assert (g.edge_level[: g.num_edges] == 0).all()
    stamps, poses = kg.trajectory()
    assert len(stamps) == len(np.unique(stamps)) == 4 * MAP_FRAMES + 1
    assert poses.shape == (4 * MAP_FRAMES + 1, 4, 4) and np.isfinite(poses).all()
    w, chi2 = kg.edge_errors()
    assert len(w) == len(chi2) == g.num_edges


def test_threaded_backend_matches_synchronous(sequence, graphs):
    """tests/test_keyframe_graph.py::test_threaded_backend_matches_synchronous
    at the back end: the worker thread applies the same maps to the same
    graph, bit for bit."""
    poses, frames = sequence
    port_frames = [convert.frame_from_reference(f, device="cpu") for f in frames]
    kg = t_kg.KeyframeGraph(K, convert.config_from_reference(GCFG),
                            convert.config_from_reference(TCFG), use_threading=True)
    assert kg._thread is not None
    for m in _maps("port", poses, port_frames):
        kg.add(m)
    kg.wait_for_queue()
    state = _graph_state(kg)
    (_, _, _), (before, _, _) = graphs
    for name in ("keyframes", "keys", "edges", "stamps", "loops"):
        assert state[name] == before[name], name
    np.testing.assert_array_equal(state["poses"], before["poses"])
    kg.shutdown()
    assert kg._thread is None


def test_threading_default_follows_config():
    """tests/test_keyframe_graph.py:122 on the port."""
    kg = t_kg.KeyframeGraph(K, TGraphConfig(), TTrackerConfig())
    assert kg._thread is not None
    kg.shutdown()
    kg2 = t_kg.KeyframeGraph(K, TGraphConfig(use_multi_threading=False), TTrackerConfig())
    assert kg2._thread is None


def test_worker_exception_surfaces_poisons_and_keeps_draining():
    """tests/test_keyframe_graph.py:136 on the port."""
    kg = t_kg.KeyframeGraph(K, TGraphConfig(), TTrackerConfig(), use_threading=True)
    kg.add(object())  # not a LocalMap: the worker raises
    kg.add(object())  # still drained after the failure
    with pytest.raises(RuntimeError, match="worker failed"):
        kg.wait_for_queue()
    kg.wait_for_queue()  # reported once
    with pytest.raises(RuntimeError, match="poisoned"):
        kg.add(object())
    kg.shutdown()
    kg2 = t_kg.KeyframeGraph(K, TGraphConfig(), TTrackerConfig(), use_threading=True)
    kg2.add(object())
    kg2._queue.join()
    kg2.shutdown(raise_errors=False)  # a discarded graph's error is dropped
    assert kg2._worker_error is None


def test_final_optimization_runs_full_schedule():
    """tests/test_keyframe_graph.py:171 on the port: ten optimize rounds
    unless early exit is asked for."""
    k = Intrinsics(40.0, 40.0, 19.5, 14.5)

    def count_rounds(graph_cfg):
        kg = t_kg.KeyframeGraph(k, graph_cfg, TTrackerConfig(first_level=1, last_level=0))
        calls = []
        orig = kg.graph.optimize
        kg.graph.optimize = lambda *a, **kw: (calls.append(1), orig(*a, **kw))[1]
        kg.final_optimization()
        kg.shutdown()
        return len(calls)

    assert count_rounds(TGraphConfig(final_optimization_remove_outliers=False)) == 10
    assert count_rounds(TGraphConfig(final_optimization_remove_outliers=False,
                                         final_optimization_early_exit=True)) == 1


def test_map_changed_callback_on_worker_does_not_deadlock():
    """tests/test_keyframe_graph.py:263 on the port: a callback on the worker
    may read trajectory() and edge_errors()."""
    kg = t_kg.KeyframeGraph(K, TGraphConfig(), TTrackerConfig(), use_threading=True)
    hit = []

    def fake_new_keyframe(m):
        kg.trajectory()
        kg.edge_errors()
        hit.append(True)

    kg._new_keyframe = fake_new_keyframe
    kg.add(object())
    deadline = time.monotonic() + 20.0
    while not hit and time.monotonic() < deadline:
        time.sleep(0.01)
    assert hit, "worker deadlocked joining its own queue item"
    kg.wait_for_queue()
    kg.shutdown()


def test_final_research_chunks_by_frame_budget():
    """tests/test_keyframe_graph.py:291 on the port: the final re-search
    validates in sub-waves bounded by distinct touched frames, whole pair
    groups per wave."""
    kg = t_kg.KeyframeGraph(K, TGraphConfig(), TTrackerConfig(), use_threading=False)
    n = 9
    for i in range(1, n + 1):
        kg.keyframes.append(TKeyframe(id=i, frame=object(), pose=np.eye(4)))
        kg.graph.add_vertex(("kf", i), np.eye(4), fixed=(i == 1))
    kg._find_candidates = lambda kf: [c for c in kg.keyframes if c is not kf]
    waves = []
    kg.validator.MAX_CACHED_FRAMES = 4
    kg.validator.validate = lambda props: (waves.append(props), [])[1]
    kg.final_optimization()
    assert len(waves) > 1
    n_pairs = (n * (n - 1)) // 2 - (n - 1)
    assert sum(len(w) for w in waves) == 2 * n_pairs
    pair_waves = {}
    for wi, w in enumerate(waves):
        frames = {id(f) for p in w for f in (p.reference.frame, p.current.frame)}
        assert len(frames) <= 4, len(frames)
        for p in w:
            pair_waves.setdefault(frozenset({p.reference.id, p.current.id}), set()).add(wi)
    assert all(len(ws) == 1 for ws in pair_waves.values())
    assert len(pair_waves) == n_pairs


def test_timers_match_reference():
    """tests/test_aux.py::test_timers on the port's copy, beside the
    reference's: the same phases, counts and summary keys."""
    from dvo_slam_tpu.utils import timers as j_timers
    from dvo_slam_tpu_torch.utils import timers as t_timers

    summaries = []
    for module in (j_timers, t_timers):
        t = module.PhaseTimers()
        for _ in range(3):
            with t.timing("match"):
                pass
        with t["constraint_search"].timing():
            pass
        summaries.append(t.summary())
        assert t["match"].mean >= 0.0 and t["match"].total >= t["match"].mean
    assert t_timers.PhaseTimers.PHASES == j_timers.PhaseTimers.PHASES
    for ref, port in zip(*(sorted(s.items()) for s in summaries)):
        assert ref[0] == port[0] and ref[1]["count"] == port[1]["count"]
        assert set(ref[1]) == set(port[1]) == {"mean_ms", "total_s", "count"}
