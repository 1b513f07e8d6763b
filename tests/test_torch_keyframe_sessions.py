"""Whole ``KeyframeTracker`` sessions (``end_session``) at 120x160 on the
CPU, and the SLAM path's spans.

A session is ``init``, ``make_frame_raw`` + ``update`` for each frame, then
``end_session``: the map comes to the host as a ``SessionMap`` and the
back end's worker is joined.  Two sessions back to back in one process
give the maps that each gives alone, and leave no worker alive.  With the
span recorder on, the worker's spans carry their keyframe's frame id and
its thread's name and are drained with the front end's; off, nothing is
recorded.
"""

import threading

import numpy as np
import pytest
import torch

from dvo_slam_tpu_torch.config import GraphConfig, KeyframeConfig, SlamConfig, TrackerConfig
from dvo_slam_tpu_torch.models.keyframe_graph import WORKER_NAME, SessionMap
from dvo_slam_tpu_torch.models.keyframe_tracker import KeyframeTracker
from dvo_slam_tpu_torch.ops.camera import Intrinsics
from dvo_slam_tpu_torch.utils import synthetic, timers
from slam_bench.reference import pose_graph as ref_pg

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

K = Intrinsics(160.0, 160.0, 79.5, 59.5)
SHAPE = (120, 160)
CFG = SlamConfig(
    tracker=TrackerConfig(first_level=2, last_level=0, max_iterations_per_level=30,
                          precision=1e-4, use_initial_estimate=True),
    keyframe=KeyframeConfig(max_translational_distance=0.05, min_entropy_ratio=0.6,
                            min_equation_system_constraint_ratio=0.3),
    graph=GraphConfig(new_constraint_search_radius=5.0,
                      new_constraint_min_entropy_ratio_coarse=0.03,
                      new_constraint_min_entropy_ratio_fine=0.3,
                      min_equation_system_constraint_ratio=0.3, optimization_iterations=20,
                      optimization_remove_outliers=True,
                      optimization_outlier_weight_threshold=0.1,
                      final_optimization_iterations=100,
                      final_optimization_remove_outliers=True,
                      final_optimization_outlier_weight_threshold=0.1),
)
FRAMES = 12
SLAM_SPANS = ("dvo.kf.update", "dvo.kf.dual_match", "dvo.kf.decision", "dvo.localmap.optimize",
              "dvo.graph.keyframe", "dvo.graph.search", "dvo.graph.wave", "dvo.graph.optimize",
              "dvo.graph.final")


@pytest.fixture(autouse=True)
def _recorder_off():
    timers.disable()
    yield
    timers.disable()


def _recording(seed: int):
    """Raw u8/u16 frames along a closed loop of 10 cm radius (two keyframes
    or more, a loop candidate), sensor noise from ``seed``."""
    poses = synthetic.circular_trajectory(FRAMES, radius=0.1, rot_amplitude=0.05)
    out = []
    for i, pose in enumerate(poses):
        i_, d_, v_ = synthetic.render_frame(pose, K, SHAPE, seed=seed * 100 + i,
                                            depth_noise=0.002, intensity_noise=1.0)
        out.append((np.clip(i_, 0, 255).astype(np.uint8),
                    np.where(v_, d_ * 5000, 0).astype(np.uint16)))
    return out


def _session(recording):
    kt = KeyframeTracker(K, CFG, device="cpu")
    kt.init()
    frames = []
    for i, (iu8, du16) in enumerate(recording):
        frames.append(kt.make_frame_raw(iu8, du16, i / 30.0))
        kt.update(frames[-1])
    return kt, frames, kt.end_session()


def _workers():
    """The back end's worker threads alive now (other tests' graphs may
    leave theirs)."""
    return {t for t in threading.enumerate() if t.name == WORKER_NAME}


@pytest.fixture(scope="module")
def recordings():
    return _recording(1), _recording(2)


@pytest.fixture(scope="module")
def alone(recordings):
    """Each recording's map from a session of its own, the second first, and
    the workers alive before them."""
    workers = _workers()
    second = _session(recordings[1])[2]
    first = _session(recordings[0])[2]
    return first, second, workers


def _assert_same(a: SessionMap, b: SessionMap):
    for field in SessionMap._fields:
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=field)


def test_a_session_ends_with_its_map_on_the_host(alone):
    m = alone[0]
    n = len(m.stamps)
    assert n == FRAMES and np.all(np.diff(m.stamps) > 0)
    assert m.poses.shape == (n, 4, 4) and m.poses.dtype == np.float64
    assert m.fixed[0] and m.fixed.sum() == 1 and m.keyframe[0] and m.keyframe.sum() >= 2
    e = len(m.edge_i)
    assert e >= n - 1 and m.measurement.shape == (e, 4, 4) and m.information.shape == (e, 6, 6)
    assert np.all((m.weight > 0) & (m.weight <= 1)) and np.all(m.weight[~m.robust] == 1)
    assert m.start_poses.shape == m.poses.shape and not np.array_equal(m.start_poses, m.poses)
    assert m.kept.dtype == bool and np.all(m.kept[~m.robust])
    assert _workers() <= alone[2]


def test_the_final_pass_is_the_references_from_where_it_started(alone):
    """The plain reference's final pass (float64, ``slam_bench/reference/
    pose_graph``) from the map's starting poses on all the pass's edges
    prunes the same edges, and the session's map costs what the
    reference's does within the port's convergence test (a relative change
    of the cost below ``optimization_tol``: a vertex held by one edge may
    stop short of it by 1e-5 m, as here)."""
    m = alone[0]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    g = ref_pg.Graph(t(m.start_poses), t(m.fixed), t(m.edge_i), t(m.edge_j), t(m.measurement),
                     t(m.information), t(m.robust))
    poses, kept = ref_pg.final_pass(g, 10, CFG.graph.final_optimization_iterations // 10,
                                    CFG.graph.final_optimization_outlier_weight_threshold)
    np.testing.assert_array_equal(kept.numpy(), m.kept)
    mine, theirs = float(ref_pg.cost(g, t(m.poses))), float(ref_pg.cost(g, poses))
    assert 0.0 <= mine - theirs < CFG.graph.optimization_tol * theirs, (mine, theirs)


def test_sessions_back_to_back_give_the_maps_of_sessions_alone(recordings, alone):
    before = _workers()
    first = _session(recordings[0])[2]
    second = _session(recordings[1])[2]
    _assert_same(first, alone[0])
    _assert_same(second, alone[1])
    assert _workers() <= before


def test_a_session_that_raises_still_joins_its_worker(recordings, monkeypatch):
    before = _workers()
    kt = KeyframeTracker(K, CFG, device="cpu")
    kt.init()
    for i, (iu8, du16) in enumerate(recordings[0][:3]):
        kt.update(kt.make_frame_raw(iu8, du16, i / 30.0))

    def refuse(*args, **kwargs):
        raise RuntimeError("final pass refused")

    monkeypatch.setattr(kt.graph, "final_optimization", refuse)
    with pytest.raises(RuntimeError, match="final pass refused"):
        kt.end_session()
    assert _workers() <= before


def test_worker_spans_carry_their_keyframe_and_drain_with_the_front_end(recordings):
    timers.enable("cpu")
    kt, frames, m = _session(recordings[0])
    spans = timers.drain()
    names = {s.name for s in spans}
    assert set(SLAM_SPANS) <= names
    ids = {f.frame_id for f in frames}
    by_stamp = {f.timestamp: f.frame_id for f in frames}
    keyframe_ids = {by_stamp[s] for s in m.stamps[m.keyframe]}
    worker = [s for s in spans if s.thread == WORKER_NAME]
    assert {s.name for s in worker} >= {"dvo.graph.keyframe", "dvo.localmap.optimize",
                                        "dvo.graph.search", "dvo.graph.wave",
                                        "dvo.graph.optimize"}
    assert {s.frame for s in worker if s.name == "dvo.graph.keyframe"} == keyframe_ids
    assert all(s.frame in keyframe_ids for s in worker)  # nested spans inherit it
    front = [s for s in spans if s.name == "dvo.kf.update"]
    assert [s.frame for s in front] == [f.frame_id for f in frames]
    assert all(s.thread == threading.current_thread().name for s in front)
    final = [s for s in spans if s.name == "dvo.graph.final"]
    assert len(final) == 1 and final[0].frame == frames[-1].frame_id and final[0].frame in ids
    counts = kt.graph.counts
    assert counts["keyframes"] == m.keyframe.sum() and counts["maps_added"] == counts["keyframes"]
    # the final pass's waves add to the insertions' streams
    assert counts["waves"] >= 1 and counts["wave_chunks"] >= 1
    assert counts["wave_streams"] >= 2 * counts["proposals_validated"] > 0
    assert counts["optimizations"] >= 10


def test_off_no_span_is_recorded_and_nothing_allocated(recordings):
    assert all(timers.span(name) is timers._NULL for name in SLAM_SPANS)
    _session(recordings[0][:4])
    assert timers.drain() == []
    assert not timers._recorder._pending and not timers._recorder._pool


def test_evaluation_counts_lose_no_update_across_threads(monkeypatch):
    """``frames.batch_evaluations`` takes the front end's and the worker's
    counts at once: eight threads, a switch every microsecond; a dual match
    (two references, one current frame) and a validation pair (each frame
    both) are told apart by their distinct frames."""
    import sys

    from dvo_slam_tpu_torch.models import frames
    from dvo_slam_tpu_torch.models.frames import HostLevelStats, HostTrackingResult

    monkeypatch.setattr(frames, "batch_evaluations", type(frames.batch_evaluations)())
    timers.enable("cpu")
    stats = tuple(HostLevelStats(1, 1, its, 0) for its in (3, 2, 1))
    results = [HostTrackingResult(np.eye(4), np.eye(6), 0.0, stats)] * 2
    cfg = CFG.tracker
    keyframe, previous, current = object(), object(), object()
    dual = [(keyframe, current), (previous, current)]
    pair = [(keyframe, current), (current, keyframe)]

    def work():
        for k in range(500):
            frames._count_evaluations(cfg, dual if k % 2 else pair, results)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert dict(frames.batch_evaluations) == {
        (level, 2, 2, only_current): its * 2000
        for level, its in ((2, 3), (1, 2), (0, 1)) for only_current in (0, 1)}
