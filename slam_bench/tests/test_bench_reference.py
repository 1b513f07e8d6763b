"""The plain reference against the program's CPU path on a tiny pair, and
the control (float32 with TF32 products) far from it."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from slam_bench import manifest, scene
from slam_bench.reference import tracker as ref
from slam_bench.tests.tiny import tiny_cell


@pytest.fixture(scope="module")
def frames():
    cell = tiny_cell("fr1_desk_odometry.recorded")
    k = cell.config["intrinsics"]
    K = (k["fx"], k["fy"], k["ox"], k["oy"])
    poses = scene.circular_trajectory(72, 0.14, 0.13, 0.05)[:5]

    class Intr:
        fx, fy, ox, oy = K

    iu, du = scene.render_sequence(poses, (120, 160), Intr, scene=scene.occluded_scene(),
                                   seed0=5)
    return cell, K, poses, iu, du


def _program_relative(cell, iu, du):
    from dvo_slam_tpu_torch.models.camera_tracker import CameraTracker
    from slam_bench import program

    ct = CameraTracker(program.intrinsics(cell.config), program.tracker_config(cell.config),
                       device="cpu")
    P = [ct.update(ct.make_frame_raw(iu[i], du[i], i / 30.0)) for i in range(len(iu))]
    return np.stack([np.linalg.inv(P[i - 1]) @ P[i] for i in range(1, len(P))])


def _reference(cell, K, iu, du, dtype=torch.float64, mm=torch.matmul):
    class Rec:
        intensity, depth = iu, du

    Rec.intrinsics = type("K", (), dict(zip(("fx", "fy", "ox", "oy"), K)))
    entry = manifest.entry("camera_tracker")
    poses, its = entry.reference_poses(cell.config, Rec, [1, 2, 3, 4], torch.device("cpu"),
                                       dtype=dtype, mm=mm)
    return poses, its


def test_reference_against_the_program(frames):
    cell, K, poses, iu, du = frames
    mine = _program_relative(cell, iu, du)
    theirs, its = _reference(cell, K, iu, du)
    t, r = ref.relative_gap(torch.from_numpy(mine), torch.from_numpy(theirs))
    assert t.max() < 2e-6 and r.max() < 2e-6, (t, r)
    truth = np.stack([np.linalg.inv(poses[i - 1]) @ poses[i] for i in range(1, 5)])
    t_gt, _ = ref.relative_gap(torch.from_numpy(theirs), torch.from_numpy(truth))
    assert t_gt.max() < 2e-3
    assert its.shape == (4, 3) and (its >= 1).all()


def test_control_fails_the_limits(frames):
    cell, K, _, iu, du = frames
    theirs, _ = _reference(cell, K, iu, du)
    control, _ = _reference(cell, K, iu, du, dtype=torch.float32, mm=ref.tf32_matmul)
    t, r = ref.relative_gap(torch.from_numpy(control), torch.from_numpy(theirs))
    limits = manifest.cell("fr1_desk_odometry.recorded").limits
    assert np.percentile(t.numpy(), 90) > limits["pose_gap_t_p90_m"]


def test_se3_round_trip():
    xi = torch.tensor([[0.01, -0.02, 0.03, 0.1, -0.05, 0.2], [1e-5, 0, 0, 1e-6, 0, 0]],
                      dtype=torch.float64)
    assert torch.allclose(ref.log_se3(ref.exp_se3(xi)), xi, atol=1e-12)
    T = ref.exp_se3(xi)
    assert torch.allclose(ref.inverse(T) @ T, torch.eye(4, dtype=torch.float64).expand(2, 4, 4),
                          atol=1e-12)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10, 3.0 + 2**-12], dtype=torch.float32)
    assert ref.tf32_round(x).tolist() == [1.0, 1.0 + 2**-10, 1.0 + 2**-10, 3.0]
