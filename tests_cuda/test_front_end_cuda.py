"""The tracking front end on the card, at 640x480 and
``benchmark_config().tracker``.

``BatchedMatcher.match_many`` at B = 2 (two references against one frame,
the dual match's shape) runs the batched folded kernel once per lockstep
iteration and agrees with two one-stream ``match`` calls: per level the
iterations and terminations equal, the estimate within 1e-5.
``kernel_backend="fused"`` runs the plain twin on CUDA tensors and
``"pallas"`` the kernel: on one pair iterations and terminations equal,
estimates within 1e-4.  ``CameraTracker`` and ``LocalTracker`` track 10
frames (raw u8/u16 NumPy frames in) with no CPU tensor on the tracking path
(0-d scalars aside) but the initial poses' upload and the result's one
download per match, each match one launch of its match graph; without a
card both raise.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from dvo_slam_tpu_torch import benchmark_config, odometry
from dvo_slam_tpu_torch.models import irls_graph
from dvo_slam_tpu_torch.models.camera_tracker import CameraTracker
from dvo_slam_tpu_torch.models.dense_tracker import match_pyramids
from dvo_slam_tpu_torch.models.frames import BatchedMatcher, Frame
from dvo_slam_tpu_torch.models.local_tracker import LocalTracker
from dvo_slam_tpu_torch.ops import fused_kernels
from dvo_slam_tpu_torch.ops.camera import TUM_FR1
from dvo_slam_tpu_torch.tools import driver_launches
from dvo_slam_tpu_torch.utils import synthetic

pytestmark = pytest.mark.cuda

CFG = benchmark_config().tracker
FRAMES = 10
# the host<->device copies a match makes: the initial poses up
# (``from_numpy`` lifts the host array, ``to`` copies it), the flat result
# down (``cpu``, then ``numpy`` detaches it)
TRANSFERS = {torch.ops.aten.lift_fresh.default, torch.ops.aten._to_copy.default,
             torch.ops.aten.copy_.default, torch.ops.aten.detach.default}


@pytest.fixture(scope="module")
def raw():
    poses = synthetic.circular_trajectory(100, radius=0.05, rot_amplitude=0.02)[:FRAMES]
    intensity, depth = odometry.render_sequence(poses, (480, 640), TUM_FR1, workers=4)
    return intensity, depth, poses


def _frames(raw, count=3):
    intensity, depth, _ = raw
    return [Frame.from_raw(intensity[k], depth[k], k / 30.0, CFG.num_levels,
                           prepare_for=(CFG, TUM_FR1)) for k in range(count)]


def _counts(result):
    return [(s.iterations, s.termination) for s in result.level_stats]


def test_batched_matcher_b2_against_one_stream_calls(raw):
    f = _frames(raw)
    matcher = BatchedMatcher(CFG, TUM_FR1)
    driver_launches.reset_counts()
    wave = matcher.match_many([(f[0], f[2], None), (f[1], f[2], None)])
    lockstep = sum(max(a.iterations, b.iterations)
                   for a, b in zip(wave[0].level_stats, wave[1].level_stats))
    irls_graph.fold_counts()  # the while graphs' launches, counted on the card
    assert fused_kernels.warp_fused_stats_batched_cuda.launches == lockstep > 0
    assert fused_kernels.warp_fused_stats_cuda.launches == 0
    for ref, result in zip(f[:2], wave):
        one = matcher.match(ref, f[2])
        assert _counts(one) == _counts(result)
        np.testing.assert_allclose(result.transformation, one.transformation, atol=1e-5)
    irls_graph.fold_counts()
    assert fused_kernels.warp_fused_stats_cuda.launches == sum(
        s.iterations for r in wave for s in r.level_stats)


def test_fused_backend_runs_the_twin_on_the_card(raw):
    f = _frames(raw, 2)
    eye = torch.eye(4, device="cuda")
    driver_launches.reset_counts()
    twin = match_pyramids(dataclasses.replace(CFG, kernel_backend="fused"), TUM_FR1,
                          f[0].levels, f[1].levels, eye)
    irls_graph.fold_counts()
    assert fused_kernels.warp_fused_stats_cuda.launches == 0
    assert twin.transformation.is_cuda
    kernel = match_pyramids(dataclasses.replace(CFG, kernel_backend="pallas"), TUM_FR1,
                            f[0].levels, f[1].levels, eye)
    irls_graph.fold_counts()
    assert fused_kernels.warp_fused_stats_cuda.launches == sum(
        s.iterations for s in kernel.level_stats) > 0
    assert [(s.iterations, int(s.termination)) for s in twin.level_stats] == [
        (s.iterations, int(s.termination)) for s in kernel.level_stats]
    torch.testing.assert_close(twin.transformation, kernel.transformation, rtol=0, atol=1e-4)


class _CpuOps(TorchDispatchMode):
    """Records every op that touches a CPU tensor of one element or more,
    but the transfers.  (A 0-d CPU tensor is a scalar passed to a kernel:
    ``x[..., 3] = 1.0`` fills from one.)"""

    def __init__(self):
        super().__init__()
        self.cpu_ops, self.ops = [], 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops += 1
        leaves = pytree.tree_leaves((args, kwargs, out))
        if func not in TRANSFERS and any(
                isinstance(t, torch.Tensor) and t.device.type == "cpu" and t.dim() > 0
                for t in leaves):
            self.cpu_ops.append(str(func))
        return out


def test_trackers_stay_on_the_card(raw):
    intensity, depth, gt = raw
    camera = CameraTracker(TUM_FR1, CFG)
    local = LocalTracker(TUM_FR1, CFG)
    frames = [camera.make_frame_raw(intensity[k], depth[k], k / 30.0) for k in range(FRAMES)]
    assert frames[0].levels[CFG.first_level].intensity.is_cuda
    camera.update(frames[0])
    local.init_new_local_map(frames[0], frames[1], np.eye(4))
    watch = _CpuOps()
    launched = irls_graph.stats()["match_graph_launches"]
    with watch:
        camera_poses = [camera.update(f) for f in frames[1:]]
        for k, f in enumerate(frames[2:], start=2):
            if k == 6:
                local.force_complete_current_local_map()
            local.update(f)
    assert watch.ops > 0 and watch.cpu_ops == [], sorted(set(watch.cpu_ops))
    # each match of both trackers is one match-graph launch, so the host
    # issues a few ops a frame where it issued hundreds level by level
    assert irls_graph.stats()["match_graph_launches"] - launched >= 2 * FRAMES - 3
    err = np.abs(camera_poses[-1][:3, 3] - (np.linalg.inv(gt[0]) @ gt[-1])[:3, 3]).max()
    assert err < 5e-3, err
    assert local.local_map.num_frames == FRAMES - 6


def test_trackers_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: CameraTracker(TUM_FR1, CFG), lambda: LocalTracker(TUM_FR1, CFG),
                 lambda: Frame.from_raw(np.zeros((8, 8), np.uint8), np.zeros((8, 8), np.uint16),
                                        0.0, 2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
