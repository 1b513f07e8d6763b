"""The port's tracking front end against the reference, on the CPU:
``LocalMap``, the evaluations, ``LocalTracker`` and ``CameraTracker``.

Frames are the reference's (``Frame.from_arrays`` on ``tests/test_slam.py``'s
120x160 scenes) carried into the port with ``convert.frame_from_reference``.
``LocalMap``: the cases of ``tests/test_slam.py``, the graphs' structure
equal and every pose within 1e-5 (the reference optimizes the float32 graph
in float32 on the CPU, the port in float64).  The evaluations agree to
float64 rounding on the same results.  ``LocalTracker`` on 8 frames with a
forced completion at frame 4 and ``CameraTracker`` on 5 frames
(``tests/test_aux.py``): poses within 1e-4 of the reference's, the same
maps and the callbacks in the same order, the same published count.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvo_slam_tpu.config import TrackerConfig
from dvo_slam_tpu.models import evaluation as j_eval
from dvo_slam_tpu.models.camera_tracker import CameraTracker as JCameraTracker
from dvo_slam_tpu.models.frames import Frame as JFrame
from dvo_slam_tpu.models.frames import HostLevelStats as JLevelStats
from dvo_slam_tpu.models.frames import HostTrackingResult as JResult
from dvo_slam_tpu.models.local_map import LocalMap as JLocalMap
from dvo_slam_tpu.models.local_tracker import LocalTracker as JLocalTracker
from dvo_slam_tpu.ops import se3 as j_se3
from dvo_slam_tpu.ops.camera import Intrinsics
from dvo_slam_tpu.utils import synthetic

from dvo_slam_tpu_torch.convert import (
    config_from_reference,
    frame_from_reference,
    pose_graph_to_numpy,
)
from dvo_slam_tpu_torch.models import evaluation as t_eval
from dvo_slam_tpu_torch.models.camera_tracker import CameraTracker as TCameraTracker
from dvo_slam_tpu_torch.models.frames import BatchedMatcher
from dvo_slam_tpu_torch.models.local_map import LocalMap as TLocalMap
from dvo_slam_tpu_torch.models.local_tracker import LocalTracker as TLocalTracker

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

K = Intrinsics(160.0, 160.0, 79.5, 59.5)  # tests/test_slam.py, tests/test_aux.py
SHAPE = (120, 160)
SLAM_CFG = TrackerConfig(first_level=2, last_level=0, max_iterations_per_level=30,
                         precision=1e-4, use_initial_estimate=True)  # tests/test_slam.py
AUX_CFG = TrackerConfig(first_level=2, last_level=0, max_iterations_per_level=30,
                        use_initial_estimate=True)  # tests/test_aux.py
MAP_POSE_ATOL = 1e-5
TRACK_POSE_ATOL = 1e-4
NOISE = dict(depth_noise=0.002, intensity_noise=1.0)


def _exp(xi):
    return np.asarray(j_se3.exp_se3(jnp.asarray(np.asarray(xi, np.float32))))


def _frames(pose, t, num_levels=3, **kw):
    """(reference Frame, port Frame) of tests/test_slam.py's _frame."""
    i, d, v = synthetic.render_frame(pose, K, SHAPE, seed=int(t * 30), **kw)
    ref = JFrame.from_arrays(i, d, v, t, num_levels)
    return ref, frame_from_reference(ref, device="cpu")


def _graphs_equal(port_map, ref_map, atol=MAP_POSE_ATOL, tracked=False):
    """The maps' graphs: the structure equal, the poses within ``atol``;
    ``tracked`` edges (from the two trackers' matches) hold measurements
    within ``atol`` and information within rtol 1e-2 (plus 1e-3 of its
    largest entry)."""
    a, b = pose_graph_to_numpy(port_map.graph), pose_graph_to_numpy(ref_map.graph)
    assert a["keys"] == b["keys"]
    for name in a:
        if name == "poses" or (tracked and name == "measurements"):
            np.testing.assert_allclose(a[name], b[name], atol=atol, rtol=0, err_msg=name)
        elif tracked and name == "information":
            # a flipped constraint moves an entry by up to 0.5 % here
            np.testing.assert_allclose(a[name], b[name], rtol=1e-2,
                                       atol=1e-3 * np.abs(b[name]).max())
        elif name != "keys":
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_local_map_structure():
    """tests/test_slam.py::test_local_map_structure on both packages."""
    (j0, t0), (j1, t1), (j2, t2) = (
        _frames(pose, k / 30.0) for k, pose in enumerate(
            (np.eye(4), _exp([0.01, 0, 0, 0, 0, 0]), _exp([0.02, 0, 0, 0, 0, 0]))))
    T1, T2 = _exp([0.01, 0, 0, 0, 0, 0]), _exp([0.02, 0, 0, 0, 0, 0])
    maps = (JLocalMap.create(j0, np.eye(4)), TLocalMap.create(t0, np.eye(4)))
    for m, f1, f2 in zip(maps, (j1, t1), (j2, t2)):
        m.add_frame(f1)
        m.add_keyframe_measurement(T1, 100 * np.eye(6))
        assert m.num_frames == 1
        np.testing.assert_allclose(m.current_frame_pose(), T1, atol=1e-6)
        m.add_frame(f2)
        m.add_odometry_measurement(np.linalg.inv(T1) @ T2, 100 * np.eye(6))
        m.add_keyframe_measurement(T2, 100 * np.eye(6))
    ref, port = maps
    _graphs_equal(port, ref, atol=0)
    ref.optimize(20)
    history = port.optimize(20)
    assert history.shape == (20,) and np.isfinite(history).all()
    _graphs_equal(port, ref)
    np.testing.assert_allclose(port.current_frame_pose(), T2, atol=1e-4)
    meas, _ = port.last_keyframe_edge()
    np.testing.assert_allclose(meas, T2, atol=1e-8)
    assert port.frame_timestamps == ref.frame_timestamps
    assert port.current_frame is t2 and port.keyframe is t0


def test_local_map_reanchoring():
    """tests/test_slam.py::test_local_map_reanchoring on both packages."""
    (j0, t0), (j1, t1) = _frames(np.eye(4), 0.0), _frames(_exp([0.05, 0, 0, 0, 0, 0]), 1 / 30)
    T1 = _exp([0.05, 0, 0, 0, 0, 0])
    anchor = _exp([0.0, 0.1, 0, 0, 0, 0.2])
    maps = (JLocalMap.create(j0, np.eye(4)), TLocalMap.create(t0, np.eye(4)))
    for m, f1 in zip(maps, (j1, t1)):
        m.add_frame(f1)
        m.add_keyframe_measurement(T1, np.eye(6))
        m.set_keyframe_pose(anchor)
    ref, port = maps
    _graphs_equal(port, ref, atol=0)
    np.testing.assert_allclose(port.keyframe_pose(), anchor, atol=1e-6)
    np.testing.assert_allclose(port.current_frame_pose(), anchor @ T1, atol=1e-5)
    np.testing.assert_allclose(port.frame_pose(1), ref.frame_pose(1), atol=0)


def _counts(result):
    return [tuple(s) for s in result.level_stats]


def _results():
    """Three port results of one matcher on the map scene, and the same
    numbers as the reference's HostTrackingResult."""
    frames = [_frames(_exp([0.01 * k, 0, 0.004 * k, 0, 0.002 * k, 0]), k / 30.0)[1]
              for k in range(4)]
    matcher = BatchedMatcher(config_from_reference(SLAM_CFG), K)
    port = matcher.match_many([(frames[0], frames[k], None) for k in (1, 2, 3)])
    ref = [JResult(r.transformation, r.information, r.neg_log_likelihood,
                   tuple(JLevelStats(*s) for s in r.level_stats)) for r in port]
    return port, ref


@pytest.mark.parametrize("kind", ["LogLikelihoodEvaluation", "NormalizedLogLikelihoodEvaluation",
                                  "EntropyEvaluation"])
def test_evaluations_match_reference(kind):
    port_results, ref_results = _results()
    port = getattr(t_eval, kind)(port_results[0])
    ref = getattr(j_eval, kind)(ref_results[0])
    for p, r in zip(port_results[1:], ref_results[1:]):
        assert port.ratio_with_first(p) == pytest.approx(ref.ratio_with_first(r), rel=1e-12)
        port.add(p)
        ref.add(r)
        assert port.ratio_with_average(p) == pytest.approx(ref.ratio_with_average(r), rel=1e-12)
    state, ref_state = t_eval.evaluation_state(port), j_eval.evaluation_state(ref)
    assert state["kind"] == ref_state["kind"] == j_eval.evaluation_kind(ref)
    for key in ("first", "average", "n"):
        assert state[key] == pytest.approx(ref_state[key], rel=1e-12)
    restored = t_eval.RestoredEvaluation(state)
    assert t_eval.evaluation_kind(restored) == state["kind"]
    assert restored.ratio_with_average(port_results[2]) == pytest.approx(
        port.ratio_with_average(port_results[2]), rel=1e-12)
    assert t_eval.evaluation_state(None) is None


def test_local_tracker_matches_reference():
    """8 frames (tests/test_slam.py's scene and config, with the benchmark's
    sensor noise), a forced completion at frame 4: poses within 1e-4, the
    same maps and callback order.  (Without noise the compiled reference's
    contracted multiply-adds move the identity-started odometry stream by an
    iteration at level 2 on every frame; noise breaks those pixel-centre
    ties.)"""
    poses = synthetic.linear_trajectory(8, np.array([0.01, 0.0, 0.003]),
                                        np.array([0.0, 0.004, 0.0]))
    pairs = [_frames(p, k / 30.0, **NOISE) for k, p in enumerate(poses)]
    runs = []
    for side, tracker in ((0, JLocalTracker(K, SLAM_CFG)),
                          (1, TLocalTracker(K, config_from_reference(SLAM_CFG), device="cpu"))):
        log, graphs = [], []
        tracker.add_map_initialized_callback(
            lambda tr, m, r, _log=log: _log.append(("init", m.num_frames)))

        def complete(tr, m, _log=log, _graphs=graphs):
            _log.append(("complete", m.num_frames))
            _graphs.append(m)

        tracker.add_map_complete_callback(complete)
        results = []
        tracker.add_accept_criterion(
            lambda tr, r_odo, r_kf, _log=log, _r=results: (
                _log.append("vote") or _r.append((r_odo, r_kf)) or True, r_odo, r_kf))
        frames = [pair[side] for pair in pairs]
        tracker.init_new_local_map(frames[0], frames[1], np.eye(4))
        est = []
        for k in range(2, len(frames)):
            if k == 4:
                tracker.force_complete_current_local_map()
            est.append(np.asarray(tracker.update(frames[k]), np.float64))
        runs.append((np.asarray(est), log, graphs, tracker, results))
    (ref_est, ref_log, ref_maps, ref_tracker, ref_results), (est, log, maps, tracker, results) = runs
    assert log == ref_log and len(maps) == len(ref_maps) == 1
    # every dual match: iterations and terminations equal per level; the
    # valid constraints may part by one (near-tie flips, as in
    # test_known_near_tie_flip: 2 of the 12 results on this scene)
    flips = 0
    for pair, ref_pair in zip(results, ref_results):
        for r, ref in zip(pair, ref_pair):
            for s, s_ref in zip(r.level_stats, ref.level_stats):
                assert (s.valid_pixels, s.iterations, s.termination) == tuple(
                    int(x) for x in (s_ref.valid_pixels, s_ref.iterations, s_ref.termination))
                assert abs(s.valid_constraints - int(s_ref.valid_constraints)) <= 1
            flips += _counts(r) != [tuple(int(x) for x in s) for s in ref.level_stats]
    assert flips <= 2, flips
    assert log.count(("complete", 3)) == 1  # frames 1-3; frame 4 seeds the next map
    np.testing.assert_allclose(est, ref_est, atol=TRACK_POSE_ATOL, rtol=0)
    np.testing.assert_allclose(tracker.last_keyframe_pose, ref_tracker.last_keyframe_pose,
                               atol=TRACK_POSE_ATOL)
    for m, r in zip(maps + [tracker.local_map], ref_maps + [ref_tracker.local_map]):
        _graphs_equal(m, r, atol=TRACK_POSE_ATOL, tracked=True)
    # the retired keyframe's tracking artifacts were released
    assert tracker.matcher._prep_key not in maps[0].keyframe.__dict__.get("_prepared", {})
    err = np.abs(est[-1][:3, 3] - (np.linalg.inv(poses[0]) @ poses[-1])[:3, 3]).max()
    assert err < 5e-3, err


def _aux_frame(tracker, pose, t):
    i, d, v = synthetic.render_frame(pose, K, SHAPE, seed=int(t * 30))
    return tracker.make_frame(i, d, v, t)


def test_camera_tracker_matches_reference():
    """tests/test_aux.py::test_camera_tracker_accumulates on both packages."""
    poses = synthetic.linear_trajectory(5, np.array([0.01, 0, 0]), np.zeros(3))
    out = []
    for tracker_cls, kw in ((JCameraTracker, {}), (TCameraTracker, {"device": "cpu"})):
        published = []
        cfg = AUX_CFG if tracker_cls is JCameraTracker else config_from_reference(AUX_CFG)
        ct = tracker_cls(K, cfg, pose_callback=lambda t, p, c, _p=published: _p.append((t, p)),
                         **kw)
        est = [np.asarray(ct.update(_aux_frame(ct, pose, i / 30.0)), np.float64)
               for i, pose in enumerate(poses)]
        out.append((np.asarray(est), published, ct))
    (ref_est, ref_pub, ref_ct), (est, pub, ct) = out
    np.testing.assert_allclose(est, ref_est, atol=TRACK_POSE_ATOL, rtol=0)
    assert len(pub) == len(ref_pub) == 5
    assert [t for t, _ in pub] == [t for t, _ in ref_pub]
    assert np.abs(est[-1][:3, 3] - poses[-1][:3, 3]).max() < 2e-3
    assert ct.frames_since_last_success == 0
    cov = ct.covariance()
    assert cov.shape == (6, 6) and np.isfinite(cov).all()


def test_camera_tracker_failure_keeps_reference():
    """tests/test_aux.py::test_camera_tracker_failure_keeps_reference on the
    port: a NaN result keeps the reference frame and counts the failure."""
    ct = TCameraTracker(K, config_from_reference(AUX_CFG), device="cpu")
    ct.update(_aux_frame(ct, np.eye(4), 0.0))
    ref_before = ct.reference

    class FakeResult:
        transformation = np.full((4, 4), np.nan)

    ct.matcher.match = lambda *a, **k: FakeResult()
    pose = ct.update(_aux_frame(ct, np.eye(4), 1 / 30.0))
    assert ct.frames_since_last_success == 1
    assert ct.reference is ref_before
    np.testing.assert_allclose(pose, np.eye(4))


def test_trackers_ask_for_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = config_from_reference(AUX_CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TCameraTracker(K, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TLocalTracker(K, cfg)
    tracker = TLocalTracker(K, cfg, device="cpu")
    frame = _frames(np.eye(4), 0.0)[1]
    tracker.device = torch.device("cuda", 0)
    with pytest.raises(ValueError, match="the tracker runs on cuda"):
        tracker.init_new_local_map(frame, frame, np.eye(4))
