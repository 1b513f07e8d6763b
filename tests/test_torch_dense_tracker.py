"""The port's dense tracker against the reference, on the CPU.

Same scenes, same pyramids: per level, iteration counts, termination
codes, selected pixels and valid constraints must be EQUAL; the estimate
within atol 1e-5, the information within rtol 1e-3 plus an atol of 1e-3
of its largest entry (its small off-diagonal entries cancel), the
negative log-likelihood within rtol 1e-4, and the per-iteration trace row
by row (the precision's off-diagonal as a correlation, atol 1e-3).  One
scene is known to part by one constraint (``test_known_near_tie_flip``).

The reference runs op by op here (``jax.disable_jit``), as the port does:
compiled as one program, XLA contracts multiply-adds in its fused loops,
which moves warped coordinates by an ulp and, at the identity warp where
they sit on pixel centres, flips the sampled 2x2 support of some pixels.
Op by op, every per-pixel value is bit-equal between the two packages and
only the pixel reductions (Gram, log sum) are summed in another order.
The odometry run holds the port against the compiled reference.
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dvo_slam_tpu import config as j_config
from dvo_slam_tpu.models import dense_tracker as j_dt
from dvo_slam_tpu.ops import se3 as j_se3
from dvo_slam_tpu.ops.camera import Intrinsics as JIntrinsics
from dvo_slam_tpu.ops.pyramid import build_pyramid as j_build_pyramid
from dvo_slam_tpu.ops.pyramid import convert_raw_depth as j_convert_raw_depth
from dvo_slam_tpu.utils import synthetic as j_syn

from dvo_slam_tpu_torch.convert import (
    config_from_reference,
    levels_from_numpy,
    prepared_from_numpy,
    result_to_numpy,
)
from dvo_slam_tpu_torch import odometry
from dvo_slam_tpu_torch.models import dense_tracker as t_dt
from dvo_slam_tpu_torch.ops.camera import Intrinsics as TIntrinsics
from dvo_slam_tpu_torch.ops.pyramid import build_pyramid as t_build_pyramid

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

K = (160.0, 160.0, 79.5, 59.5)  # tests/test_dense_tracker.py
SHAPE = (120, 160)

def _both(cfg):
    """A reference config and the port's, built from it by convert.py."""
    return cfg, config_from_reference(cfg)


# each config twice, the reference's and the port's (equal field by field)
CFG = _both(j_config.TrackerConfig(first_level=2, last_level=0, max_iterations_per_level=50))
BENCH = _both(j_config.benchmark_config().tracker)
NOISE = dict(depth_noise=0.002, intensity_noise=1.0)

# (config, twist of the current camera, initial guess, render noise)
SCENES = {
    "default-z": (CFG, [0.0, 0.0, 0.02, 0.0, 0.0, 0.0], None, {}),
    "default-6dof": (CFG, [0.01, -0.008, 0.012, 0.004, -0.005, 0.006], None, {}),
    "bench-x": (BENCH, [0.01, 0.0, 0.0, 0.0, 0.0, 0.0], np.eye(4, dtype=np.float32), NOISE),
    "bench-xz-yaw": (
        BENCH, [0.01, 0.0, 0.005, 0.0, 0.0, 0.01], np.eye(4, dtype=np.float32), NOISE,
    ),
}


def _frames(twist, noise, num_levels):
    T = np.asarray(j_se3.exp_se3(jnp.asarray(twist, jnp.float32)), np.float64)
    out = []
    for pose, seed in ((np.eye(4), 0), (T, 1)):
        i, d, v = j_syn.render_frame(pose, JIntrinsics(*K), SHAPE, seed=seed, **noise)
        ref = j_build_pyramid(jnp.asarray(i), jnp.asarray(d), jnp.asarray(v), num_levels)
        port = t_build_pyramid(
            torch.from_numpy(i), torch.from_numpy(d), torch.from_numpy(v), num_levels
        )
        out.append((ref, port))
    return out


def _level_counts(result):
    return [
        (int(s.valid_pixels), int(s.valid_constraints), int(s.iterations), int(s.termination))
        for s in result.level_stats
    ]


def _assert_results_match(port, ref):
    port = result_to_numpy(port)
    assert _level_counts(port) == _level_counts(ref)
    np.testing.assert_allclose(port.transformation, np.asarray(ref.transformation), atol=1e-5)
    info_ref = np.asarray(ref.information)
    np.testing.assert_allclose(
        port.information, info_ref, rtol=1e-3, atol=1e-3 * np.abs(info_ref).max()
    )
    np.testing.assert_allclose(
        float(port.neg_log_likelihood), float(ref.neg_log_likelihood), rtol=1e-4
    )
    return port


def _assert_precisions_close(port, ref):
    """2x2 precisions [I, 2, 2]: diagonals within rtol 1e-3; the
    off-diagonal as a correlation P01 / sqrt(P00 P11) within atol 1e-3.
    P01 comes from a near-cancelling sum of r_I r_Z, orders of magnitude
    below the diagonal, so its own relative error is no measure."""
    np.testing.assert_allclose(port[:, 0, 0], ref[:, 0, 0], rtol=1e-3)
    np.testing.assert_allclose(port[:, 1, 1], ref[:, 1, 1], rtol=1e-3)
    corr = lambda p: p[:, 0, 1] / np.sqrt(p[:, 0, 0] * p[:, 1, 1])  # noqa: E731
    np.testing.assert_allclose(corr(port), corr(ref), atol=1e-3)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_match_pyramids_matches_reference(scene):
    (cfg, t_cfg), twist, init, noise = SCENES[scene]
    (ref0, port0), (ref1, port1) = _frames(twist, noise, cfg.num_levels)
    with jax.disable_jit():
        ref = j_dt.match_pyramids(
            cfg, JIntrinsics(*K), ref0, ref1, init, collect_iteration_stats=True
        )
    port = t_dt.match_pyramids(
        t_cfg, TIntrinsics(*K), port0, port1, init, collect_iteration_stats=True
    )
    port = _assert_results_match(port, ref)

    # the iteration trace, row by row (rows past the count stay zero)
    assert len(port.iteration_stats) == len(ref.iteration_stats) == cfg.num_levels - cfg.last_level
    for tr_port, tr_ref, stats in zip(port.iteration_stats, ref.iteration_stats, port.level_stats):
        its = int(stats.iterations)
        np.testing.assert_array_equal(tr_port.valid_constraints, np.asarray(tr_ref.valid_constraints))
        assert (tr_port.valid_constraints[its:] == 0).all()
        np.testing.assert_allclose(tr_port.log_likelihood, np.asarray(tr_ref.log_likelihood), rtol=1e-4)
        _assert_precisions_close(tr_port.precision[:its], np.asarray(tr_ref.precision)[:its])
        np.testing.assert_allclose(tr_port.increment, np.asarray(tr_ref.increment), atol=1e-5)
        info_ref = np.asarray(tr_ref.information)
        np.testing.assert_allclose(
            tr_port.information, info_ref, rtol=1e-3, atol=1e-3 * np.abs(info_ref).max()
        )


def test_known_near_tie_flip():
    """The one scene of ROADMAP queue C where the port and the reference
    part: twist [0.01, 0, 0, 0, 0, 0], no render noise, first_level=2.  The
    Gram and the log sum are summed in another order, the final level-2
    iterate moves by an ulp and one pixel's constraint flips: 1129 valid
    constraints in the port, 1130 in the reference.  Everything else is
    equal, and the estimate agrees within 1e-7."""
    cfg, t_cfg = CFG
    (ref0, port0), (ref1, port1) = _frames([0.01, 0.0, 0.0, 0.0, 0.0, 0.0], {}, cfg.num_levels)
    with jax.disable_jit():
        ref = j_dt.match_pyramids(cfg, JIntrinsics(*K), ref0, ref1)
    port = result_to_numpy(t_dt.match_pyramids(t_cfg, TIntrinsics(*K), port0, port1))
    counts_port, counts_ref = _level_counts(port), _level_counts(ref)
    assert counts_ref[0] == (1200, 1130, 4, 3)
    assert counts_port[0] == (1200, 1129, 4, 3)
    assert counts_port[1:] == counts_ref[1:]
    np.testing.assert_allclose(port.transformation, np.asarray(ref.transformation), atol=1e-7)


def test_match_prepared_on_reference_prepared_frames():
    """The reference's prepared frames, carried across by convert.py, give
    the port's match_prepared the reference's inputs exactly."""
    (cfg, t_cfg), twist, init, noise = SCENES["bench-xz-yaw"]
    (ref0, _), (ref1, _) = _frames(twist, noise, cfg.num_levels)
    kj = JIntrinsics(*K)
    prep0, prep1 = j_dt.prepare_frame(cfg, kj, ref0), j_dt.prepare_frame(cfg, kj, ref1)
    with jax.disable_jit():
        ref = j_dt.match_prepared(cfg, kj, prep0, prep1, init)
    port_prep0, port_prep1 = prepared_from_numpy(prep0), prepared_from_numpy(prep1)
    port = t_dt.match_prepared(t_cfg, TIntrinsics(*K), port_prep0, port_prep1, init)
    _assert_results_match(port, ref)
    # a keyframe keeps only its reference-role artifacts
    stripped = t_dt.match_prepared(
        t_cfg, TIntrinsics(*K), t_dt.ref_artifacts(port_prep0), port_prep1, init
    )
    assert torch.equal(stripped.transformation, port.transformation)
    # the reference's pyramids, carried across, through the whole entry point
    via_levels = t_dt.match_pyramids(
        t_cfg, TIntrinsics(*K), levels_from_numpy(ref0), levels_from_numpy(ref1), init
    )
    _assert_results_match(via_levels, ref)


def test_dense_tracker_facade():
    t_cfg = CFG[1]
    (_, port0), (_, port1) = _frames([0.01, 0.0, 0.005, 0.0, 0.0, 0.01], {}, t_cfg.num_levels)
    tracker = t_dt.DenseTracker(TIntrinsics(*K), t_cfg)
    direct = t_dt.match_pyramids(t_cfg, TIntrinsics(*K), port0, port1)
    result = tracker.match(port0, port1)
    assert torch.equal(result.transformation, direct.transformation)
    assert len(tracker.build_pyramid(port0[0].intensity, port0[0].depth, port0[0].valid)) == 3


def test_all_invalid_depth_probe():
    """A current frame without valid depth: no constraint at any level,
    TooFewConstraints, and a finite result."""
    t_cfg = CFG[1]
    i, d, v = j_syn.render_frame(np.eye(4), JIntrinsics(*K), SHAPE, seed=0)
    ref = t_build_pyramid(
        torch.from_numpy(i), torch.from_numpy(d), torch.from_numpy(v), t_cfg.num_levels
    )
    cur = t_build_pyramid(
        torch.from_numpy(i), torch.zeros(SHAPE), torch.zeros(SHAPE, dtype=torch.bool),
        t_cfg.num_levels,
    )
    result = t_dt.match_pyramids(t_cfg, TIntrinsics(*K), ref, cur)
    for stats in result.level_stats:
        assert int(stats.valid_constraints) == 0
        assert int(stats.termination) == t_dt.TERM_TOO_FEW_CONSTRAINTS
    assert torch.isfinite(result.transformation).all()
    assert not bool(result.is_nan())


def test_kernel_backend_pallas_needs_cuda():
    t_cfg = CFG[1]
    (_, port0), (_, port1) = _frames([0.01, 0, 0, 0, 0, 0], {}, t_cfg.num_levels)
    with pytest.raises(ValueError, match="CUDA"):
        t_dt.match_pyramids(
            dataclasses.replace(t_cfg, kernel_backend="pallas"), TIntrinsics(*K), port0, port1
        )


def test_odometry_matches_compiled_reference():
    """8 frames of 120x160 u8/u16 odometry, frame to frame with a
    constant-velocity warm start (the port's odometry driver, on the CPU): the
    trajectory agrees with the compiled reference within 1e-4 m."""
    cfg, t_cfg = _both(dataclasses.replace(BENCH[0], first_level=2, last_level=0))
    poses = j_syn.circular_trajectory(100, radius=0.05, rot_amplitude=0.02)[:8]
    intensity_u8, depth_u16 = odometry.render_sequence(poses, SHAPE, TIntrinsics(*K))

    t_i, t_d = odometry.upload_sequence(intensity_u8, depth_u16, "cpu")
    est_port, iterations, _ = odometry.track_sequence(t_cfg, TIntrinsics(*K), t_i, t_d)
    assert iterations >= 7 * cfg.num_levels

    match = jax.jit(functools.partial(j_dt.match_pyramids, cfg, JIntrinsics(*K)))

    def pyramid(k):
        depth, valid = j_convert_raw_depth(jnp.asarray(depth_u16[k]))
        return j_build_pyramid(
            jnp.asarray(intensity_u8[k]).astype(jnp.float32), depth, valid,
            cfg.num_levels, skip_below=cfg.last_level,
        )

    pose = rel = np.eye(4, dtype=np.float32)
    est_ref = [pose]
    prev = pyramid(0)
    for k in range(1, len(poses)):
        cur = pyramid(k)
        rel = np.asarray(match(prev, cur, jnp.asarray(rel)).transformation)
        pose = pose @ rel
        est_ref.append(pose)
        prev = cur
    np.testing.assert_allclose(est_port[:, :3, 3], np.asarray(est_ref)[:, :3, 3], atol=1e-4)
    # and both track the ground truth
    np.testing.assert_allclose(est_port[:, :3, 3], poses[:, :3, 3] - poses[0, :3, 3], atol=2e-3)
