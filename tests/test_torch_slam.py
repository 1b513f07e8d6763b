"""The port's ``KeyframeTracker`` (front end, keyframe policy and back end)
against the reference, on the CPU.

``tests/test_slam.py``'s tiny run (30x40, 8 frames on a 4 cm circle, its
config), synchronous in both packages, frames carried into the port with
``convert.frame_from_reference``:
- with the benchmark's sensor noise (depth 2 mm, intensity 1): the same
  keyframes and accepted loop pairs, online poses within 1e-4, the
  optimized graph trajectory within 1e-4 (the reference solves its float32
  graph in float32 on the CPU, the port in float64);
- on the scene as ``tests/test_slam.py`` renders it, without noise: the
  same keyframes and loop pairs, online poses within 1e-3 (streams started
  at the identity warp meet the compiled reference's pixel-centre ties,
  ROADMAP queue C), and the reference test's own gates.
Then, on the port, the reference's policy tests: threaded equal to
synchronous, the divergence reset, a forced keyframe, an initial offset,
the raw live path, and the device rules.
"""

import numpy as np
import pytest
import torch

from dvo_slam_tpu.config import GraphConfig, KeyframeConfig, SlamConfig, TrackerConfig
from dvo_slam_tpu.models.frames import Frame as JFrame
from dvo_slam_tpu.models.keyframe_tracker import KeyframeTracker as JKeyframeTracker
from dvo_slam_tpu.ops.camera import Intrinsics

from dvo_slam_tpu_torch import convert
from dvo_slam_tpu_torch.models import frames as t_frames
from dvo_slam_tpu_torch.models.keyframe_tracker import KeyframeTracker as TKeyframeTracker
from dvo_slam_tpu_torch.ops import se3 as t_se3
from dvo_slam_tpu_torch.utils import synthetic, trajectory

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

K_TINY = Intrinsics(40.0, 40.0, 19.5, 14.5)
SHAPE_TINY = (30, 40)
TINY_CFG = SlamConfig(  # tests/test_slam.py::test_slam_smoke_tiny
    tracker=TrackerConfig(first_level=1, last_level=0, max_iterations_per_level=15,
                          precision=1e-4, use_initial_estimate=True),
    keyframe=KeyframeConfig(max_translational_distance=0.05, min_entropy_ratio=0.5,
                            min_equation_system_constraint_ratio=0.1),
    graph=GraphConfig(new_constraint_search_radius=5.0,
                      new_constraint_min_entropy_ratio_coarse=0.03,
                      new_constraint_min_entropy_ratio_fine=0.3,
                      min_equation_system_constraint_ratio=0.1, optimization_iterations=10,
                      final_optimization_iterations=20),
)
K = Intrinsics(160.0, 160.0, 79.5, 59.5)  # tests/test_slam.py
SHAPE = (120, 160)
SLAM_CFG = convert.config_from_reference(SlamConfig(
    tracker=TrackerConfig(first_level=2, last_level=0, max_iterations_per_level=30,
                          precision=1e-4, use_initial_estimate=True),
    keyframe=KeyframeConfig(max_translational_distance=0.08, min_entropy_ratio=0.6,
                            min_equation_system_constraint_ratio=0.3),
    graph=GraphConfig(new_constraint_search_radius=5.0,
                      new_constraint_min_entropy_ratio_coarse=0.03,
                      new_constraint_min_entropy_ratio_fine=0.3,
                      min_equation_system_constraint_ratio=0.3, optimization_iterations=20,
                      final_optimization_iterations=100, optimization_remove_outliers=True,
                      optimization_outlier_weight_threshold=0.1,
                      final_optimization_remove_outliers=True,
                      final_optimization_outlier_weight_threshold=0.1),
))
NOISE = dict(depth_noise=0.002, intensity_noise=1.0)
ONLINE_ATOL = 1e-4
GRAPH_ATOL = 1e-4
NOISE_FREE_ONLINE_ATOL = 1e-3


def _loops(kt):
    return sorted((i, j) for i, j, _, _, robust, _ in kt.graph.graph.edge_list() if robust)


def _run(kt, frames):
    """(online poses, graph stamps, graph poses) of a finished run."""
    kt.init()
    est = np.asarray([np.asarray(kt.update(f), np.float64) for f in frames])
    kt.force_keyframe()
    kt.finish()
    stamps, poses = kt.trajectory()
    return est, stamps, poses


@pytest.fixture(scope="module", params=["noise", "noise-free"])
def tiny_runs(request):
    """The reference's and the port's tiny runs on the same frames."""
    noise = NOISE if request.param == "noise" else {}
    poses = synthetic.circular_trajectory(8, radius=0.04, rot_amplitude=0.02)
    frames = []
    for i, pose in enumerate(poses):
        i_, d_, v_ = synthetic.render_frame(pose, K_TINY, SHAPE_TINY, seed=i, **noise)
        frames.append(JFrame.from_arrays(i_, d_, v_, i / 30.0, TINY_CFG.tracker.num_levels))
    ref = JKeyframeTracker(K_TINY, TINY_CFG, use_threading=False)
    port = TKeyframeTracker(K_TINY, convert.config_from_reference(TINY_CFG), use_threading=False,
                            device="cpu")
    ref_out = _run(ref, frames)
    out = _run(port, [convert.frame_from_reference(f, device="cpu") for f in frames])
    return request.param, poses, (ref, ref_out), (port, out)


def test_tiny_run_matches_reference(tiny_runs):
    kind, poses, (ref, (ref_est, ref_stamps, ref_graph)), (port, (est, stamps, graph)) = tiny_runs
    assert [k.id for k in port.graph.keyframes] == [k.id for k in ref.graph.keyframes]
    assert len(port.graph.keyframes) >= 3
    assert _loops(port) == _loops(ref) and len(_loops(port)) > 0
    online_atol = ONLINE_ATOL if kind == "noise" else NOISE_FREE_ONLINE_ATOL
    np.testing.assert_allclose(est, ref_est, atol=online_atol, rtol=0)
    np.testing.assert_array_equal(stamps, ref_stamps)
    if kind == "noise":
        np.testing.assert_allclose(graph, ref_graph, atol=GRAPH_ATOL, rtol=0)
    # tests/test_slam.py::test_slam_smoke_tiny's gates
    gt_stamps = np.arange(len(poses)) / 30.0
    ate = trajectory.ate_rmse(gt_stamps, est, gt_stamps, poses)
    assert np.isfinite(ate) and ate < 0.05, ate
    assert len(stamps) == len(poses)
    assert port.graph.graph.last_solver == "dense"
    assert {"constraint_validation", "final_optimization"} <= set(port.graph.timers.summary())


def _frame(tracker, pose, t, **kw):
    i, d, v = synthetic.render_frame(pose, K, SHAPE, seed=int(t * 30), **kw)
    return tracker.make_frame(i, d, v, t)


def _tracker(**kw):
    return TKeyframeTracker(K, SLAM_CFG, device="cpu", **kw)


def test_threaded_matches_synchronous():
    """tests/test_keyframe_graph.py::test_threaded_backend_matches_synchronous
    on the whole tracker: a steadily translating camera (keyframes every few
    frames, tests/test_slam.py::test_keyframe_switching_linear_path's
    path), the graph worker on and off, bit-equal graph trajectories."""
    poses = synthetic.linear_trajectory(10, np.array([0.02, 0, 0]), np.zeros(3))
    runs = []
    for threading in (False, True):
        kt = _tracker(use_threading=threading)
        assert (kt.graph._thread is not None) == threading
        kt.init()
        est = [np.asarray(kt.update(_frame(kt, p, i / 30.0)), np.float64)
               for i, p in enumerate(poses)]
        kt.graph.wait_for_queue()
        runs.append((np.asarray(est), kt.graph.trajectory(), len(kt.graph.keyframes)))
        kt.graph.shutdown()
    (est_s, (s_s, p_s), n_s), (est_t, (s_t, p_t), n_t) = runs
    assert n_s == n_t >= 2
    np.testing.assert_array_equal(est_s, est_t)
    np.testing.assert_array_equal(s_s, s_t)
    np.testing.assert_array_equal(p_s, p_t)
    assert np.linalg.norm(est_t[-1][:3, 3] - poses[-1][:3, 3]) < 0.02


def test_forced_keyframe():
    """tests/test_slam.py::test_forced_keyframe on the port."""
    poses = synthetic.linear_trajectory(6, np.array([0.005, 0, 0]), np.zeros(3))
    kt = _tracker()
    kt.init()
    for i, pose in enumerate(poses[:4]):
        kt.update(_frame(kt, pose, i / 30.0))
    kt.graph.wait_for_queue()
    n_before = len(kt.graph.keyframes)
    kt.force_keyframe()
    kt.update(_frame(kt, poses[4], 4 / 30.0))
    kt.graph.wait_for_queue()
    assert len(kt.graph.keyframes) == n_before + 1
    kt.graph.shutdown()


def test_divergence_reset():
    """tests/test_slam.py::test_divergence_reset on the port: a frame 10 m
    away is rejected by the divergence criterion and its odometry reset."""
    kt = _tracker(use_threading=False)
    kt.init()
    kt.update(_frame(kt, np.eye(4), 0.0))
    kt.update(_frame(kt, np.eye(4), 1 / 30.0))
    far = np.eye(4)
    far[:3, 3] = [10.0, 0, 0]
    seen = []
    kt.lt.add_accept_criterion(lambda lt, r_odo, r_kf: (seen.append(r_odo) or True, r_odo, r_kf))
    pose = np.asarray(kt.update(_frame(kt, far, 2 / 30.0)), np.float64)
    assert np.isfinite(pose).all()
    assert np.linalg.norm(pose[:3, 3]) < 1.0
    np.testing.assert_array_equal(seen[-1].transformation, np.eye(4))
    np.testing.assert_allclose(seen[-1].information, np.eye(6) * 0.008 ** 2)


def test_initial_transformation_offset():
    """tests/test_slam.py::test_initial_transformation_offset on the port."""
    T0 = t_se3.exp_se3(torch.tensor([0.5, -0.2, 0.1, 0.0, 0.0, 0.3], dtype=torch.float64)).numpy()
    poses = synthetic.linear_trajectory(4, np.array([0.01, 0, 0]), np.zeros(3))
    kt = _tracker(use_threading=False)
    kt.init(T0)
    est = [np.asarray(kt.update(_frame(kt, pose, i / 30.0)), np.float64)
           for i, pose in enumerate(poses)]
    np.testing.assert_allclose(est[0], T0, atol=1e-6)
    rel_est = np.linalg.inv(est[0]) @ est[-1]
    rel_true = np.linalg.inv(poses[0]) @ poses[-1]
    assert np.abs(rel_est[:3, 3] - rel_true[:3, 3]).max() < 0.01


def test_make_frame_raw_live_path():
    """tests/test_slam.py::test_make_frame_raw_fused_prepare_live_path on the
    port: raw u8/u16 frames are prepared for the tracker's config once, in
    ``make_frame_raw``, and never again by a match; the trajectory holds the
    reference test's gate."""
    k = Intrinsics(80.0, 80.0, 39.5, 29.5)
    cfg = convert.config_from_reference(SlamConfig(
        tracker=TrackerConfig(first_level=1, last_level=0, use_initial_estimate=True)))
    kt = TKeyframeTracker(k, cfg, device="cpu")
    kt.init()
    poses = synthetic.circular_trajectory(6, radius=0.03)
    prepared = []
    original = t_frames.prepare_frame
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_frames, "prepare_frame",
                   lambda c, *a: (prepared.append(c), original(c, *a))[1])
        for i, p in enumerate(poses):
            i_, d_, v_ = synthetic.render_frame(p, k, (60, 80), seed=i, depth_noise=0.002)
            iu8 = np.clip(i_, 0, 255).astype(np.uint8)
            du16 = np.where(v_, d_ * 5000, 0).astype(np.uint16)
            frame = kt.make_frame_raw(iu8, du16, i / 30.0)
            assert (cfg.tracker, k) in frame._prepared
            kt.update(frame)
        kt.force_keyframe()
        kt.finish()
    assert prepared.count(cfg.tracker) == len(poses)
    stamps, traj = kt.trajectory()
    assert trajectory.ate_rmse(stamps, traj, np.arange(6) / 30.0, poses) < 0.01
    kt.graph.shutdown()


def test_configure_at_run_time():
    """tests/test_aux.py::test_runtime_reconfiguration on the port."""
    import dataclasses

    kt = _tracker(use_threading=False)
    kt.init()
    poses = synthetic.linear_trajectory(3, np.array([0.005, 0, 0]), np.zeros(3))
    for i, pose in enumerate(poses):
        kt.update(_frame(kt, pose, i / 30.0))
    new = dataclasses.replace(SLAM_CFG.tracker, max_iterations_per_level=10)
    kt.configure_tracking(new)
    assert kt.lt.cfg.max_iterations_per_level == 10 and kt.lt.matcher.cfg is new
    assert kt.graph.validator.stage2_matcher.cfg.first_level == new.first_level
    assert np.isfinite(kt.update(_frame(kt, poses[-1], 0.2))).all()
    kt.configure_keyframe_selection(dataclasses.replace(SLAM_CFG.keyframe, min_entropy_ratio=0.5))
    kt.configure_mapping(dataclasses.replace(SLAM_CFG.graph, optimization_iterations=4))
    assert kt.cfg.keyframe.min_entropy_ratio == 0.5 and kt.graph.cfg.optimization_iterations == 4


def test_tracker_asks_for_the_card(monkeypatch):
    """Without ``device`` the tracker takes the card and raises without one;
    with ``device="cpu"`` its frames and its local tracker are on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TKeyframeTracker(K, SLAM_CFG, use_threading=False)
    kt = _tracker(use_threading=False)
    assert kt.device == torch.device("cpu") and kt.lt.device == kt.device
    frame = _frame(kt, np.eye(4), 0.0)
    assert frame.levels[0].intensity.device == kt.device
