"""The renderer copy against the program's, and the recording by seed."""

from __future__ import annotations

import numpy as np
import torch

from slam_bench import scene, traffic
from slam_bench.tests.tiny import live_cell, tiny_cell


def test_render_sequence_equals_the_programs():
    from dvo_slam_tpu_torch.odometry import render_sequence
    from dvo_slam_tpu_torch.ops.camera import Intrinsics
    from dvo_slam_tpu_torch.utils import synthetic

    k = Intrinsics(130.0, 129.0, 79.5, 59.5)
    poses = scene.circular_trajectory(6, 0.14, 0.13, 0.05)
    assert np.array_equal(poses, synthetic.circular_trajectory(6, 0.14, 0.13, 0.05))
    for planes, theirs in ((scene.occluded_scene(), synthetic.occluded_scene()),
                           (scene.default_scene(), synthetic.default_scene())):
        mine = scene.render_sequence(poses[:3], (30, 40), k, scene=planes, seed0=7)
        other = render_sequence(poses[:3], (30, 40), k, scene=theirs, seed0=7)
        assert np.array_equal(mine[0], other[0]) and np.array_equal(mine[1], other[1])


def test_device_renderer_equals_the_copy():
    class K:
        fx, fy, ox, oy = 130.0, 129.0, 79.5, 59.5

    poses = scene.circular_trajectory(72, 0.14, 0.13, 0.05)[:20:4]
    planes = scene.occluded_scene()
    i, z, v = scene.render_frames_torch(poses, K, (60, 80), planes, "cpu", chunk=2)
    for k, pose in enumerate(poses):
        ri, rz, rv = scene.render_frame(pose, K, (60, 80), scene=planes)
        assert np.array_equal(i[k].numpy(), ri) and np.array_equal(z[k].numpy(), rz)
        assert np.array_equal(v[k].numpy(), rv)


def test_recording_is_fixed_by_the_seed():
    cell = tiny_cell("fr1_desk_odometry.recorded", frames=80)
    cpu = torch.device("cpu")
    a = traffic.make_recording(cell.config, 80, 2**31 + 77, cpu)
    b = traffic.make_recording(cell.config, 80, 2**31 + 77, cpu)
    c = traffic.make_recording(cell.config, 80, 2**31 + 78, cpu)
    assert np.array_equal(a.intensity, b.intensity) and np.array_equal(a.depth, b.depth)
    assert not np.array_equal(a.intensity, c.intensity)
    # frame f's noise is (seed, f)'s whatever the recording's length
    short = traffic.make_recording(cell.config, 66, 2**31 + 77, cpu)
    assert np.array_equal(short.intensity, a.intensity[:66])
    assert np.array_equal(short.depth, a.depth[:66])
    # the lap repeats: frames a lap apart show one pose
    lap = cell.config["loop"]["lap_frames"]
    assert np.array_equal(a.poses[0], a.poses[lap])
    assert a.intensity.dtype == np.uint8 and a.depth.dtype == np.uint16


def test_loops_have_the_sequences_speeds():
    for config in (tiny_cell("fr1_desk_odometry.recorded").config, live_cell().config):
        poses = traffic.lap_poses(config)
        closed = np.concatenate([poses, poses[:1]])
        rel = [np.linalg.inv(closed[k]) @ closed[k + 1] for k in range(len(poses))]
        rate = config["sequence"]["rate_hz"]
        speed = np.mean([np.linalg.norm(r[:3, 3]) for r in rel]) * rate
        angle = np.mean([np.degrees(np.arccos(np.clip((np.trace(r[:3, :3]) - 1) / 2, -1, 1)))
                         for r in rel]) * rate
        seq = config["sequence"]
        assert abs(speed / seq["mean_translational_speed_m_s"] - 1) < 0.03
        assert abs(angle / seq["mean_angular_speed_deg_s"] - 1) < 0.03
