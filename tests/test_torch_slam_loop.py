"""The port's ``KeyframeTracker`` against the reference on a short loop at
120x160 (``tests/test_slam.py``'s intrinsics and SLAM config; 12 frames
once round a 6 cm circle, 0.03 rad, with the benchmark's sensor noise),
synchronous in both packages, frames carried into the port with
``convert.frame_from_reference``: the same keyframes and accepted loop
pairs, online poses within 1e-4, the optimized graph trajectory within
1e-4 (the reference solves its float32 graph in float32 on the CPU, the
port in float64), the final pass's route, and the reference test's gates
(online and graph ATE < 10 mm, loop edges accepted).
"""

import numpy as np
import pytest
import torch

from dvo_slam_tpu.config import GraphConfig, KeyframeConfig, SlamConfig, TrackerConfig
from dvo_slam_tpu.models.frames import Frame as JFrame
from dvo_slam_tpu.models.keyframe_tracker import KeyframeTracker as JKeyframeTracker
from dvo_slam_tpu.ops.camera import Intrinsics

from dvo_slam_tpu_torch import convert
from dvo_slam_tpu_torch.models.keyframe_tracker import KeyframeTracker as TKeyframeTracker
from dvo_slam_tpu_torch.utils import synthetic, trajectory

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

K = Intrinsics(160.0, 160.0, 79.5, 59.5)
SHAPE = (120, 160)
CFG = SlamConfig(  # tests/test_slam.py::SLAM_CFG
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
)
FRAMES = 12
ONLINE_ATOL = 1e-4
GRAPH_ATOL = 1e-4


def _run(kt, frames):
    kt.init()
    est = np.asarray([np.asarray(kt.update(f), np.float64) for f in frames])
    kt.force_keyframe()
    kt.finish()
    return est, kt.trajectory()


@pytest.fixture(scope="module")
def runs():
    poses = synthetic.circular_trajectory(FRAMES, radius=0.06, rot_amplitude=0.03)
    frames = []
    for i, pose in enumerate(poses):
        i_, d_, v_ = synthetic.render_frame(pose, K, SHAPE, seed=i, depth_noise=0.002,
                                            intensity_noise=1.0)
        frames.append(JFrame.from_arrays(i_, d_, v_, i / 30.0, CFG.tracker.num_levels))
    ref = JKeyframeTracker(K, CFG, use_threading=False)
    port = TKeyframeTracker(K, convert.config_from_reference(CFG), use_threading=False,
                            device="cpu")
    return poses, (ref, _run(ref, frames)), (port, _run(port, [
        convert.frame_from_reference(f, device="cpu") for f in frames]))


def _loops(kt):
    return sorted((i, j) for i, j, _, _, robust, _ in kt.graph.graph.edge_list() if robust)


def test_loop_matches_reference(runs):
    poses, (ref, (ref_est, (ref_stamps, ref_graph))), (port, (est, (stamps, graph))) = runs
    assert [k.id for k in port.graph.keyframes] == [k.id for k in ref.graph.keyframes]
    assert len(port.graph.keyframes) >= 3
    assert _loops(port) == _loops(ref) and len(_loops(port)) > 0
    np.testing.assert_allclose(est, ref_est, atol=ONLINE_ATOL, rtol=0)
    np.testing.assert_array_equal(stamps, ref_stamps)
    np.testing.assert_allclose(graph, ref_graph, atol=GRAPH_ATOL, rtol=0)
    assert port.graph.graph.last_solver == "dense"


def test_reference_gates_hold(runs):
    """tests/test_slam.py::test_full_slam_loop_trajectory's gates."""
    poses, _, (port, (est, (stamps, graph))) = runs
    gt = np.arange(FRAMES) / 30.0
    assert trajectory.ate_rmse(gt, est, gt, poses) < 0.01
    assert len(stamps) == FRAMES
    assert trajectory.ate_rmse(stamps, graph, gt, poses) < 0.01
    w, chi2 = port.graph.edge_errors()
    assert len(w) == len(chi2) > 0
