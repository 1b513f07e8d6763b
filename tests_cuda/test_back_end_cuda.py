"""The SLAM back end on the card, at 640x480 and ``benchmark_config()``.

``TwoStageMatcher.match_pairs`` on six requests (three frame pairs of the
easy scene, an identity and a relative initialization each) runs the
batched folded kernel at B = 12, one launch per lockstep iteration of its
coarse and fine solves, and agrees with the same call on CPU frames (the
plain version): valid pixels equal, valid constraints within 1 % of them,
at most two levels whose iterations or termination part (near-ties: the
kernel sums its Gram in double, the plain version in float32, and a
different last bit of the estimate moves the mask's edge pixels),
transformations within 1e-4.
A threaded ``KeyframeTracker`` tracks 24 frames of the occluded scene on
the card: the worker's validation waves run the kernel (the plain version
never), 24 poses come back, the ATE-RMSE stays under 10 mm, and without a
card the tracker raises.
"""

import numpy as np
import pytest
import torch

from dvo_slam_tpu_torch import benchmark_config, odometry
from dvo_slam_tpu_torch.models import irls_graph
from dvo_slam_tpu_torch.models.constraints import (
    constraint_tracker_config,
    validation_tracker_config,
)
from dvo_slam_tpu_torch.models.frames import Frame, TwoStageMatcher
from dvo_slam_tpu_torch.models.keyframe_tracker import KeyframeTracker
from dvo_slam_tpu_torch.ops import fused_kernels
from dvo_slam_tpu_torch.ops.camera import TUM_FR1
from dvo_slam_tpu_torch.tools import driver_launches
from dvo_slam_tpu_torch.utils import synthetic, trajectory

pytestmark = pytest.mark.cuda

SLAM = benchmark_config()
CFG = SLAM.tracker
FRAMES = 24


@pytest.fixture(scope="module")
def easy():
    poses = synthetic.circular_trajectory(FRAMES, radius=0.05, rot_amplitude=0.02)
    intensity, depth = odometry.render_sequence(poses, (480, 640), TUM_FR1, workers=4)
    return intensity, depth, poses


@pytest.fixture(scope="module")
def hard():
    poses = synthetic.circular_trajectory(FRAMES, radius=0.15, rot_amplitude=0.12,
                                          z_amplitude=0.05)
    intensity, depth = odometry.render_sequence(poses, (480, 640), TUM_FR1,
                                                scene=synthetic.occluded_scene(), seed0=1000,
                                                workers=4)
    return intensity, depth, poses


def _frames(raw, device, ids):
    intensity, depth, _ = raw
    return {k: Frame.from_raw(intensity[k], depth[k], k / 30.0, CFG.num_levels, device=device)
            for k in ids}


def _requests(frames, poses):
    out = []
    for a, b in ((0, 8), (4, 16), (8, 20)):
        out.append((frames[a], frames[b], None))
        out.append((frames[a], frames[b], np.linalg.inv(poses[a]) @ poses[b]))
    return out


def test_two_stage_matcher_on_the_card_against_the_cpu(easy):
    raw, poses = easy, easy[2]
    ids = (0, 4, 8, 16, 20)
    matcher = TwoStageMatcher(validation_tracker_config(CFG), constraint_tracker_config(CFG),
                              TUM_FR1)
    driver_launches.reset_counts()
    card = matcher.match_pairs(_requests(_frames(raw, "cuda", ids), poses))
    host = matcher.match_pairs(_requests(_frames(raw, "cpu", ids), poses))
    irls_graph.fold_counts()  # the while graphs' launches, counted on the card
    assert fused_kernels.warp_fused_stats_cuda.launches == 0
    coarse = sum(max(max(q[0].level_stats[i].iterations, q[1].level_stats[i].iterations)
                     for q in card) for i in range(len(card[0][0].level_stats)))
    fine = sum(max(max(q[2].level_stats[i].iterations, q[3].level_stats[i].iterations)
                   for q in card) for i in range(len(card[0][2].level_stats)))
    assert fused_kernels.warp_fused_stats_batched_cuda.launches == coarse + fine > 0
    parted = 0
    for quad_card, quad_host in zip(card, host):
        for r, h in zip(quad_card, quad_host):
            for s, t in zip(r.level_stats, h.level_stats):
                assert s.valid_pixels == t.valid_pixels
                assert abs(s.valid_constraints - t.valid_constraints) <= 0.01 * s.valid_pixels
                parted += (s.iterations, s.termination) != (t.iterations, t.termination)
            np.testing.assert_allclose(r.transformation, h.transformation, atol=1e-4)
    assert parted <= 2, parted


def test_threaded_keyframe_tracker_on_the_card(hard, monkeypatch):
    intensity, depth, poses = hard
    plain_calls = []
    plain = fused_kernels.warp_fused_stats_plain
    monkeypatch.setattr(fused_kernels, "warp_fused_stats_plain",
                        lambda *a, **k: (plain_calls.append(1), plain(*a, **k))[1])
    driver_launches.reset_counts()
    kt = KeyframeTracker(TUM_FR1, SLAM)
    assert kt.graph._thread is not None and kt.device.type == "cuda"
    kt.init()
    online = [kt.update(kt.make_frame_raw(intensity[k], depth[k], k / 30.0))
              for k in range(FRAMES)]
    kt.finish()
    stamps, est = kt.trajectory()
    kt.graph.shutdown()
    assert plain_calls == []
    assert driver_launches.launches()[driver_launches.BATCHED] > 0
    assert len(stamps) == FRAMES and len(kt.graph.keyframes) >= 2
    gt = np.arange(FRAMES) / 30.0
    assert trajectory.ate_rmse(stamps, est, gt, poses) < 0.01
    assert trajectory.ate_rmse(gt, np.asarray(online), gt, poses) < 0.01


def test_keyframe_tracker_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KeyframeTracker(TUM_FR1, SLAM, use_threading=False)
