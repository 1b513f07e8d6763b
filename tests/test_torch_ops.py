"""Parity of the PyTorch port's ops with the JAX reference, on the CPU.

The same inputs, made with NumPy from a seed, go through both packages.
Pyramids, masks, acceleration packs and quad tables take the same
float32 operations in the same order on both sides and must be
bit-equal; the rest agree within the tolerances stated per test.
"""

import enum

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dvo_slam_tpu.ops import interp as j_interp
from dvo_slam_tpu.ops import least_squares as j_ls
from dvo_slam_tpu.ops import pyramid as j_pyr
from dvo_slam_tpu.ops import residuals as j_res
from dvo_slam_tpu.ops import robust as j_robust
from dvo_slam_tpu.ops import se3 as j_se3
from dvo_slam_tpu.ops.camera import Intrinsics as JIntrinsics
from dvo_slam_tpu.utils import synthetic as j_syn

from dvo_slam_tpu_torch.ops import interp as t_interp
from dvo_slam_tpu_torch.ops import least_squares as t_ls
from dvo_slam_tpu_torch.ops import pyramid as t_pyr
from dvo_slam_tpu_torch.ops import residuals as t_res
from dvo_slam_tpu_torch.ops import robust as t_robust
from dvo_slam_tpu_torch.ops import se3 as t_se3
from dvo_slam_tpu_torch.ops.camera import Intrinsics as TIntrinsics

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

# the scenes of tests/test_pallas.py and tests/test_dense_tracker.py
SCENES = {
    "60x80": ((60, 80), (80.0, 80.0, 39.5, 29.5)),
    "120x160": ((120, 160), (160.0, 160.0, 79.5, 59.5)),
}


def _t(a):
    return torch.from_numpy(np.array(a))


def _raw_frame(shape, k, pose, seed, scene=None):
    """A rendered frame quantised to camera format: u8 intensity, u16 depth."""
    i, d, v = j_syn.render_frame(
        pose, JIntrinsics(*k), shape, scene=scene, seed=seed,
        depth_noise=0.002, intensity_noise=1.0, invalid_fraction=0.03,
    )
    i_u8 = np.clip(i, 0, 255).astype(np.uint8)
    d_u16 = np.where(v, d * 5000.0, 0).astype(np.uint16)
    return i_u8, d_u16


def _pyramids(shape, k, pose=np.eye(4), seed=0, num_levels=3, skip_below=0, scene=None):
    i_u8, d_u16 = _raw_frame(shape, k, pose, seed, scene)
    jd, jv = j_pyr.convert_raw_depth(jnp.asarray(d_u16))
    ref = j_pyr.build_pyramid(
        jnp.asarray(i_u8).astype(jnp.float32), jd, jv, num_levels, skip_below
    )
    td, tv = t_pyr.convert_raw_depth(_t(d_u16))
    port = t_pyr.build_pyramid(
        _t(i_u8).to(torch.float32), td, tv, num_levels, skip_below
    )
    return ref, port


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_se3_exp_log_inverse(seed):
    """exp/log/inverse agree with the reference to atol 1e-6 over both
    Taylor branches (|w| below and above 0.1 rad)."""
    rng = np.random.default_rng(seed)
    xi = rng.normal(0.0, 0.05, (16, 6)).astype(np.float32)
    xi[8:, 3:] *= 6.0  # rotations beyond the small-angle branch
    T_ref = np.asarray(j_se3.exp_se3(jnp.asarray(xi)))
    T_port = t_se3.exp_se3(_t(xi))
    np.testing.assert_allclose(T_port.numpy(), T_ref, atol=1e-6)
    np.testing.assert_allclose(
        t_se3.log_se3(_t(T_ref)).numpy(), np.asarray(j_se3.log_se3(jnp.asarray(T_ref))),
        atol=1e-6,
    )
    np.testing.assert_allclose(
        t_se3.inverse(_t(T_ref)).numpy(), np.asarray(j_se3.inverse(jnp.asarray(T_ref))),
        atol=1e-6,
    )
    np.testing.assert_allclose(t_se3.log_se3(T_port).numpy(), xi, atol=1e-5)


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("skip_below", [0, 1])
def test_pyramid_and_selection_bit_equal(scene, skip_below):
    """u8/u16 input: every level's channels and masks, and the selection
    mask, bit-equal to the reference (None levels where skipped)."""
    shape, k = SCENES[scene]
    ref, port = _pyramids(shape, k, seed=3, skip_below=skip_below)
    assert len(ref) == len(port)
    for lv_ref, lv_port in zip(ref, port):
        if lv_ref is None:
            assert lv_port is None
            continue
        for field in j_pyr.PyramidLevel._fields:
            np.testing.assert_array_equal(
                getattr(lv_port, field).numpy(), np.asarray(getattr(lv_ref, field)),
                err_msg=field,
            )
        np.testing.assert_array_equal(
            t_pyr.selection_mask(lv_port).numpy(),
            np.asarray(j_pyr.selection_mask(lv_ref)),
        )


def test_convert_raw_depth_bit_equal():
    rng = np.random.default_rng(4)
    raw = rng.integers(0, 65536, (30, 40)).astype(np.uint16)
    raw[::3] = 0
    jd, jv = j_pyr.convert_raw_depth(jnp.asarray(raw))
    td, tv = t_pyr.convert_raw_depth(_t(raw))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_acceleration_and_quad_table_bit_equal(scene):
    shape, k = SCENES[scene]
    ref, port = _pyramids(shape, k, seed=5)
    for lv_ref, lv_port in zip(ref, port):
        acc_ref = j_pyr.build_acceleration_cm(lv_ref)
        acc_port = t_pyr.build_acceleration_cm(lv_port)
        np.testing.assert_array_equal(acc_port.numpy(), np.asarray(acc_ref))
        w = lv_ref.intensity.shape[1]
        np.testing.assert_array_equal(
            t_interp.build_quad_table_cm(acc_port, w).numpy(),
            np.asarray(j_interp.build_quad_table_cm(acc_ref, w)),
        )


@pytest.mark.parametrize("depth_buffered", [True, False])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_warp_and_sample_cm(scene, depth_buffered):
    """The warp + quad sample on the occluded scene: validity equal,
    values within atol 1e-5 (same float32 ops on both sides)."""
    from dvo_slam_tpu.models.dense_tracker import _build_refpack as j_refpack
    from dvo_slam_tpu_torch.models.dense_tracker import _build_refpack as t_refpack

    shape, k = SCENES[scene]
    occluded = j_syn.occluded_scene()
    ref, port_ref = _pyramids(shape, k, seed=6, scene=occluded)
    twist = np.asarray([0.01, -0.006, 0.008, 0.004, -0.006, 0.005], np.float32)
    T = np.asarray(j_se3.exp_se3(jnp.asarray(twist)))
    cur, port_cur = _pyramids(shape, k, pose=T.astype(np.float64), seed=7, scene=occluded)
    for level in range(len(ref)):
        jk, tk = JIntrinsics(*k).at_level(level), TIntrinsics(*k).at_level(level)
        hw = tuple(ref[level].intensity.shape)
        j_sel = j_pyr.selection_mask(ref[level])
        t_sel = t_pyr.selection_mask(port_ref[level])
        j_pack, t_pack = j_refpack(ref[level], j_sel, jk), t_refpack(port_ref[level], t_sel, tk)
        np.testing.assert_array_equal(t_pack.numpy(), np.asarray(j_pack))
        j_quad = j_interp.build_quad_table_cm(j_pyr.build_acceleration_cm(cur[level]), hw[1])
        t_quad = t_interp.build_quad_table_cm(t_pyr.build_acceleration_cm(port_cur[level]), hw[1])
        s_ref = np.asarray(
            j_res.warp_and_sample_cm(j_pack, j_quad, hw, jk, jnp.asarray(T),
                                     depth_buffered=depth_buffered)
        )
        s_port = t_res.warp_and_sample_cm(
            t_pack, t_quad, hw, tk, _t(T), depth_buffered=depth_buffered
        ).numpy()
        np.testing.assert_array_equal(s_port[6], s_ref[6])
        assert s_ref[6].sum() > 0.25 * s_ref[6].size  # not vacuous
        np.testing.assert_allclose(s_port, s_ref, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_precision_from_scale(seed):
    """Both variance floors engage as in the reference: a regular scale, a
    near-zero one (floors dominate) and a singular one; rtol 1e-6."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(2, 2)).astype(np.float32)
    cases = [
        a @ a.T * np.float32(1e-3),
        np.zeros((2, 2), np.float32),
        np.asarray([[1e-9, 1e-9], [1e-9, 1e-9]], np.float32),
    ]
    for sigma in cases:
        np.testing.assert_allclose(
            t_robust.precision_from_scale(_t(sigma)).numpy(),
            np.asarray(j_robust.precision_from_scale(jnp.asarray(sigma))),
            rtol=1e-6,
        )


def test_tdist_weights_and_log_likelihood():
    rng = np.random.default_rng(8)
    r = (rng.normal(size=(500, 2)) * [0.02, 0.005]).astype(np.float32)
    mask = rng.random(500) > 0.2
    P = np.asarray([[2500.0, 30.0], [30.0, 4.0e4]], np.float32)
    np.testing.assert_allclose(
        t_robust.tdist_weights(_t(r), _t(P), _t(mask)).numpy(),
        np.asarray(j_robust.tdist_weights(jnp.asarray(r), jnp.asarray(P), jnp.asarray(mask))),
        rtol=1e-6,
    )
    np.testing.assert_allclose(
        float(t_robust.tdist_log_likelihood_cm(_t(r.T), _t(P), _t(mask))),
        float(j_robust.tdist_log_likelihood_cm(jnp.asarray(r.T), jnp.asarray(P),
                                               jnp.asarray(mask))),
        rtol=1e-5,
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_solve_ldlt(seed):
    """Equilibrated Cholesky solve of a normal-equation-like system
    (diagonal spread over 1e2..1e8): rtol 1e-5 against the reference; the
    column-vector form sums each column's dot products in another order
    than the reference's scalar unroll."""
    rng = np.random.default_rng(seed)
    J = rng.normal(size=(200, 6)) * np.logspace(1, 4, 6)
    A = (J.T @ J).astype(np.float32)
    b = rng.normal(size=6).astype(np.float32) * 100.0
    x_ref = np.asarray(j_ls.solve_ldlt(jnp.asarray(A), jnp.asarray(b)))
    x_port = t_ls.solve_ldlt(_t(A), _t(b)).numpy()
    np.testing.assert_allclose(x_port, x_ref, rtol=1e-5)
    np.testing.assert_allclose(A.astype(np.float64) @ x_port, b, rtol=1e-3, atol=1e-2)


def test_solve_ldlt_singular_is_finite():
    """A singular system (two columns of J identical: a direction with no
    constraint) still gives a finite step, thanks to the pivot floor, as
    in the reference."""
    J = np.random.default_rng(9).normal(size=(50, 6)).astype(np.float32)
    J[:, 5] = J[:, 4]
    A = J.T @ J
    b = np.ones(6, np.float32)
    x_ref = np.asarray(j_ls.solve_ldlt(jnp.asarray(A), jnp.asarray(b)))
    x = t_ls.solve_ldlt(_t(A), _t(b)).numpy()
    assert np.isfinite(x_ref).all()
    assert np.isfinite(x).all()


def test_unproject_project_bit_equal():
    from dvo_slam_tpu.ops import camera as j_cam
    from dvo_slam_tpu_torch.ops import camera as t_cam

    depth = np.random.default_rng(10).uniform(0.5, 4.0, (30, 40)).astype(np.float32)
    k = (80.0, 80.0, 19.5, 14.5)
    pts_ref = np.asarray(j_cam.unproject(jnp.asarray(depth), j_cam.Intrinsics(*k)))
    pts_port = t_cam.unproject(_t(depth), t_cam.Intrinsics(*k))
    np.testing.assert_array_equal(pts_port.numpy(), pts_ref)
    np.testing.assert_array_equal(
        t_cam.project(pts_port, t_cam.Intrinsics(*k)).numpy(),
        np.asarray(j_cam.project(jnp.asarray(pts_ref), j_cam.Intrinsics(*k))),
    )
    assert t_cam.TUM_FR1 == tuple(j_cam.TUM_FR1)
    assert t_cam.TUM_FR1.at_level(2) == tuple(j_cam.TUM_FR1.at_level(2))


def test_config_and_trajectory_metric_are_the_references():
    """The port's own copies of the configs, the benchmark operating point
    and the ATE metric equal the reference's: the same class and enum names,
    the benchmark config field by field through convert.py in both
    directions, and the metric on a random trajectory."""
    from dvo_slam_tpu import config as j_config
    from dvo_slam_tpu.utils import trajectory as j_traj
    from dvo_slam_tpu_torch import benchmark_config, config as t_config
    from dvo_slam_tpu_torch.convert import config_from_reference, config_to_reference
    from dvo_slam_tpu_torch.utils import trajectory as t_traj

    for name in t_config.__all__:
        assert getattr(t_config, name) is not getattr(j_config, name)
        assert getattr(t_config, name).__name__ == getattr(j_config, name).__name__
    assert config_to_reference(benchmark_config(), j_config) == j_config.benchmark_config()
    assert config_from_reference(j_config.benchmark_config()) == benchmark_config()
    for name in t_traj.__all__:
        assert getattr(t_traj, name) is not getattr(j_traj, name)
    rng = np.random.default_rng(11)
    poses = np.tile(np.eye(4), (20, 1, 1))
    poses[:, :3, 3] = np.cumsum(rng.normal(0.0, 0.01, (20, 3)), axis=0)
    est = poses.copy()
    est[:, :3, 3] += rng.normal(0.0, 1e-3, (20, 3))
    stamps = np.arange(20) / 30.0
    assert t_traj.ate_rmse(stamps, est, stamps, poses) == j_traj.ate_rmse(stamps, est, stamps, poses)


_CONFIG_CLASSES = ("TrackerConfig", "KeyframeConfig", "GraphConfig", "SlamConfig")


@pytest.mark.parametrize("name", _CONFIG_CLASSES)
def test_config_copy_equals_reference_field_by_field(name):
    """Each copied config class has the reference's fields, in order, with
    equal defaults; its enums have the reference's members and values; a
    non-default config survives the round trip through convert.py."""
    import dataclasses

    from dvo_slam_tpu import config as j_config
    from dvo_slam_tpu_torch import config as t_config
    from dvo_slam_tpu_torch.convert import config_from_reference, config_to_reference

    t_cls, j_cls = getattr(t_config, name), getattr(j_config, name)
    t_fields, j_fields = dataclasses.fields(t_cls), dataclasses.fields(j_cls)
    assert [f.name for f in t_fields] == [f.name for f in j_fields]
    assert config_to_reference(t_cls(), j_config) == j_cls()
    assert config_from_reference(j_cls()) == t_cls()
    for enum_name in ("InfluenceFunction", "ScaleEstimator"):
        t_enum, j_enum = getattr(t_config, enum_name), getattr(j_config, enum_name)
        assert [(m.name, m.value) for m in t_enum] == [(m.name, m.value) for m in j_enum]
    j_bench = getattr(j_config.benchmark_config(), name.replace("Config", "").lower(), None)
    j_cfg = j_config.benchmark_config() if j_bench is None else j_bench
    t_cfg = config_from_reference(j_cfg)
    assert type(t_cfg) is t_cls
    for f in j_fields:
        mine, theirs = getattr(t_cfg, f.name), getattr(j_cfg, f.name)
        if isinstance(mine, enum.Enum):
            assert (type(mine).__name__, mine.name) == (type(theirs).__name__, theirs.name)
        elif dataclasses.is_dataclass(mine):
            assert config_to_reference(mine, j_config) == theirs, f.name
        else:
            assert type(mine) is type(theirs) and mine == theirs, f.name
    assert config_to_reference(t_cfg, j_config) == j_cfg


def test_config_enums_convert_by_member_name():
    """The reference compares enums by identity: a converted config carries
    each package's own members."""
    import dataclasses

    from dvo_slam_tpu import config as j_config
    from dvo_slam_tpu_torch import config as t_config
    from dvo_slam_tpu_torch.convert import config_from_reference, config_to_reference

    j_cfg = j_config.TrackerConfig(influence_function=j_config.InfluenceFunction.HUBER,
                                   scale_estimator=j_config.ScaleEstimator.MAD, mu=0.3)
    t_cfg = config_from_reference(j_cfg)
    assert t_cfg.influence_function is t_config.InfluenceFunction.HUBER
    assert t_cfg.scale_estimator is t_config.ScaleEstimator.MAD
    back = config_to_reference(dataclasses.replace(t_cfg, depth_buffered_sampling=False), j_config)
    assert back.influence_function is j_config.InfluenceFunction.HUBER
    assert back == dataclasses.replace(j_cfg, depth_buffered_sampling=False)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_trajectory_metrics_equal_reference(seed):
    """associate_trajectories, umeyama_alignment and ate_rmse of the port's
    copy against the reference's on random trajectories (with a timestamp
    jitter and an unmatched tail): bit-equal."""
    from dvo_slam_tpu.utils import trajectory as j_traj
    from dvo_slam_tpu_torch.utils import trajectory as t_traj

    rng = np.random.default_rng(seed)
    frames = 40
    gt = np.tile(np.eye(4), (frames, 1, 1))
    gt[:, :3, 3] = np.cumsum(rng.normal(0.0, 0.02, (frames, 3)), axis=0)
    twist = rng.normal(0.0, 0.05, 6).astype(np.float32)
    offset = np.asarray(j_se3.exp_se3(jnp.asarray(twist)), np.float64)
    est = offset[None] @ gt
    est[:, :3, 3] += rng.normal(0.0, 2e-3, (frames, 3))
    gt_stamps = np.arange(frames) / 30.0
    est_stamps = gt_stamps + rng.uniform(-0.005, 0.005, frames)
    est_stamps[-5:] += 1.0  # no ground truth within max_dt
    for a, b in zip(t_traj.associate_trajectories(est_stamps, gt_stamps),
                    j_traj.associate_trajectories(est_stamps, gt_stamps)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t_traj.umeyama_alignment(est[:, :3, 3], gt[:, :3, 3]),
                                  j_traj.umeyama_alignment(est[:, :3, 3], gt[:, :3, 3]))
    ate = t_traj.ate_rmse(est_stamps, est, gt_stamps, gt)
    assert ate == j_traj.ate_rmse(est_stamps, est, gt_stamps, gt) and 0.0 < ate < 0.01
    assert np.isnan(t_traj.ate_rmse(est_stamps[:1], est[:1], gt_stamps, gt))
