"""The port's modular-path ops against the reference's, on the CPU:
``pyramid.build_acceleration``, the channel-last samplers of ``interp``,
``residuals`` (the Jacobians, ``warp_and_sample``, ``compute_residuals``,
``normal_equations``), the rest of ``robust`` and of ``least_squares``,
and ``Intrinsics.matrix``.  Inputs come from a seed with NumPy at 60x80
and 120x160.

Elementwise ops are bit-equal to the reference run op by op
(``jax.disable_jit``): the samplers, the Jacobians, the univariate
weights and the median.  The reductions are summed in another order and
held within a stated tolerance: rtol 1e-5 (the normal equations and the
scale sums, A and b against their own largest entry), 1e-5 of the terms'
scale for the log-likelihood, rtol 1e-4 for the solves.  The warp's point
transform is a three-term reduction too: the reference's CPU matrix
product rounds two of its columns unfused and the third with fused
multiply-adds, the port sums every column unfused, so z' parts by up to
two ulps; ``warp_and_sample`` and ``compute_residuals`` keep equal masks
and validity on every scene, the residuals within the reference's own
2e-5 (``tests/test_pallas.py``), each sampled channel and the Jacobian
within 2e-5 of their largest magnitude.  A batch [B, ...] is held
against its streams' one-stream calls: bit-equal for the elementwise ops,
within the same tolerances for the reductions.  Then the reference's own
oracles (``tests/test_residuals.py``, ``tests/test_robust.py``) run on
the port.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dvo_slam_tpu.ops import interp as j_interp
from dvo_slam_tpu.ops import least_squares as j_ls
from dvo_slam_tpu.ops import pyramid as j_pyr
from dvo_slam_tpu.ops import residuals as j_res
from dvo_slam_tpu.ops import robust as j_rob
from dvo_slam_tpu.ops import se3 as j_se3
from dvo_slam_tpu.ops.camera import Intrinsics as JIntrinsics
from dvo_slam_tpu.utils import synthetic as j_syn

from dvo_slam_tpu_torch.ops import interp, least_squares, pyramid, residuals, robust
from dvo_slam_tpu_torch.ops.camera import Intrinsics, project, unproject

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

SIZES = {"60x80": ((60, 80), (80.0, 80.0, 39.5, 29.5)),
         "120x160": ((120, 160), (160.0, 160.0, 79.5, 59.5))}
TWIST = [0.01, -0.008, 0.012, 0.004, -0.005, 0.006]
RTOL = 1e-5  # the reductions, summed in another order than the reference's


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _eq(a, b):
    np.testing.assert_array_equal(_np(a), _np(b))


def _scene(size, seed=0, twist=TWIST):
    """Reference and current levels of a rendered pair (both packages'
    level 0, bit-equal), the intrinsics and the true transform."""
    shape, k = SIZES[size]
    T = np.asarray(j_se3.exp_se3(jnp.asarray(twist, jnp.float32)), np.float64)
    out = []
    for pose, s in ((np.eye(4), seed), (T, seed + 1)):
        i, d, v = j_syn.render_frame(pose, JIntrinsics(*k), shape, seed=s,
                                     depth_noise=0.002, invalid_fraction=0.03)
        out.append((j_pyr.build_pyramid(jnp.asarray(i), jnp.asarray(d), jnp.asarray(v), 1)[0],
                    pyramid.build_pyramid(_t(i), _t(d), _t(v), 1)[0]))
    return out[0], out[1], k, T.astype(np.float32)


def _coords(rng, shape, n=500):
    h, w = shape
    u = rng.uniform(-2.0, w + 1.0, n).astype(np.float32)
    v = rng.uniform(-2.0, h + 1.0, n).astype(np.float32)
    z = rng.uniform(0.5, 4.0, n).astype(np.float32)
    return u, v, z


@pytest.mark.parametrize("size", sorted(SIZES))
def test_build_acceleration(size):
    (_, ref), (j_cur, cur), _, _ = _scene(size)
    accel = pyramid.build_acceleration(cur)
    _eq(accel, j_pyr.build_acceleration(j_cur))
    h, w = accel.shape[:2]
    _eq(accel.reshape(h * w, 8).T, pyramid.build_acceleration_cm(cur))
    stacked = pyramid.PyramidLevel(*(torch.stack([a, b]) for a, b in zip(ref, cur)))
    batched = pyramid.build_acceleration(stacked)
    _eq(batched[1], accel)
    _eq(batched[0], pyramid.build_acceleration(ref))


@pytest.mark.parametrize("buffered", [False, True])
@pytest.mark.parametrize("size", sorted(SIZES))
def test_bilinear_sample_accel(size, buffered):
    _, (j_cur, cur), _, _ = _scene(size)
    rng = np.random.default_rng(1)
    u, v, z = _coords(rng, cur.intensity.shape)
    zz = (z, _t(z)) if buffered else (None, None)
    accel = pyramid.build_acceleration(cur)
    values, valid = interp.bilinear_sample_accel(accel, _t(u), _t(v), zz[1])
    with jax.disable_jit():
        j_values, j_valid = j_interp.bilinear_sample_accel(
            j_pyr.build_acceleration(j_cur), jnp.asarray(u), jnp.asarray(v),
            None if zz[0] is None else jnp.asarray(zz[0]))
    _eq(values, j_values)
    _eq(valid, j_valid)
    assert 0 < int(valid.sum()) < len(u)
    # a stream axis: each stream samples its own tensor
    stacked = torch.stack([accel, torch.flip(accel, dims=(0,))])
    uu, vv = torch.stack([_t(u), _t(u[::-1].copy())]), torch.stack([_t(v), _t(v[::-1].copy())])
    zb = None if zz[1] is None else torch.stack([zz[1], zz[1]])
    b_values, b_valid = interp.bilinear_sample_accel(stacked, uu, vv, zb)
    for b in range(2):
        one = interp.bilinear_sample_accel(stacked[b], uu[b], vv[b],
                                           None if zb is None else zb[b])
        _eq(b_values[b], one[0])
        _eq(b_valid[b], one[1])


@pytest.mark.parametrize("buffered", [False, True])
def test_row_major_quad_table(buffered):
    _, (j_cur, cur), _, _ = _scene("60x80")
    rng = np.random.default_rng(2)
    u, v, z = _coords(rng, cur.intensity.shape)
    quad = interp.build_quad_table(pyramid.build_acceleration(cur))
    j_quad = j_interp.build_quad_table(j_pyr.build_acceleration(j_cur))
    _eq(quad, j_quad)
    with jax.disable_jit():
        want = j_interp.bilinear_sample_quad(j_quad, (60, 80), jnp.asarray(u), jnp.asarray(v),
                                             jnp.asarray(z) if buffered else None)
    got = interp.bilinear_sample_quad(quad, (60, 80), _t(u), _t(v), _t(z) if buffered else None)
    _eq(got[0], want[0])
    _eq(got[1], want[1])


@pytest.mark.parametrize("size", sorted(SIZES))
def test_depth_buffer_and_image_samplers(size):
    _, (j_cur, cur), _, _ = _scene(size)
    rng = np.random.default_rng(3)
    u, v, z = _coords(rng, cur.intensity.shape)
    got = interp.bilinear_with_depth_buffer(cur.intensity, cur.depth, cur.valid,
                                            _t(u), _t(v), _t(z))
    with jax.disable_jit():
        want = j_interp.bilinear_with_depth_buffer(
            j_cur.intensity, j_cur.depth, j_cur.valid, jnp.asarray(u), jnp.asarray(v),
            jnp.asarray(z))
        want_img = j_interp.bilinear_sample_image(j_cur.depth, jnp.asarray(u), jnp.asarray(v))
    _eq(got[0], want[0])
    _eq(got[1], want[1])
    got_img = interp.bilinear_sample_image(cur.depth, _t(u), _t(v))
    _eq(got_img[0], want_img[0])
    _eq(got_img[1], want_img[1])


def test_jacobians_and_depth_stddev():
    rng = np.random.default_rng(4)
    pts = rng.uniform([-1, -1, 0.3], [1, 1, 4.0], (3, 200, 3)).astype(np.float32)
    pts[0, :5, 2] = 0.0  # the guarded division
    with jax.disable_jit():
        jw = j_res.projection_jacobian(jnp.asarray(pts))
        jz = j_res.transform_z_jacobian(jnp.asarray(pts))
        sd = j_res.depth_stddev(jnp.asarray(pts[..., 2]))
    _eq(residuals.projection_jacobian(_t(pts)), jw)
    _eq(residuals.transform_z_jacobian(_t(pts)), jz)
    _eq(residuals.depth_stddev(_t(pts[..., 2])), sd)


@pytest.mark.parametrize("form", ["accel", "quad"])
@pytest.mark.parametrize("size", sorted(SIZES))
def test_warp_and_sample(size, form):
    (j_ref, ref), (j_cur, cur), k, T = _scene(size)
    accel = pyramid.build_acceleration(cur)
    quad = interp.build_quad_table(accel) if form == "quad" else None
    got = residuals.warp_and_sample(ref.depth, accel, Intrinsics(*k), _t(T), quad=quad)
    with jax.disable_jit():
        j_accel = j_pyr.build_acceleration(j_cur)
        want = j_res.warp_and_sample(
            j_ref.depth, j_accel, JIntrinsics(*k), jnp.asarray(T),
            quad=None if quad is None else j_interp.build_quad_table(j_accel))
    sampled, z_t, points = got
    _eq(points, want[2])
    _eq(sampled[:, 6], want[0][:, 6])  # validity
    np.testing.assert_allclose(_np(z_t), _np(want[1]), rtol=0, atol=1e-6)
    valid = _np(sampled[:, 6]) > 0.5
    assert valid.sum() > 1000
    for c in range(6):
        _close(_np(sampled)[valid, c], _np(want[0])[valid, c], rtol=2e-5)


def _residual_inputs(level, accel, k, T):
    sel = (pyramid if isinstance(level.intensity, torch.Tensor) else j_pyr).selection_mask(level)
    return (level.intensity, level.depth, level.idx, level.idy, sel, accel, k, T)


@pytest.mark.parametrize("size", sorted(SIZES))
def test_compute_residuals_bit_equal(size):
    (j_ref, ref), (j_cur, cur), k, T = _scene(size)
    got = residuals.compute_residuals(*_residual_inputs(
        ref, pyramid.build_acceleration(cur), Intrinsics(*k), _t(T)))
    with jax.disable_jit():
        want = j_res.compute_residuals(*_residual_inputs(
            j_ref, j_pyr.build_acceleration(j_cur), JIntrinsics(*k), jnp.asarray(T)))
    assert int(got.num_valid) > 1000
    _eq(got.mask, want.mask)
    _eq(got.num_valid, want.num_valid)
    np.testing.assert_allclose(_np(got.residuals), _np(want.residuals), rtol=0, atol=2e-5)
    _close(got.jacobian, want.jacobian, rtol=2e-5)


def test_compute_residuals_batched_equals_streams():
    """B = 3 streams, each its own pair and transform, in one call: each
    stream bit-equal to its one-stream call."""
    scenes = [_scene("60x80", seed=s, twist=np.array(TWIST) * f)
              for s, f in ((0, 1.0), (3, 0.5), (5, -0.7))]
    k = Intrinsics(*scenes[0][2])
    refs = [s[0][1] for s in scenes]
    accels = [pyramid.build_acceleration(s[1][1]) for s in scenes]
    Ts = [_t(s[3]) for s in scenes]
    stack = lambda xs: torch.stack(list(xs))  # noqa: E731
    ref_b = pyramid.PyramidLevel(*(stack(f) for f in zip(*refs)))
    batched = residuals.compute_residuals(*_residual_inputs(ref_b, stack(accels), k, stack(Ts)))
    for b in range(3):
        one = residuals.compute_residuals(*_residual_inputs(refs[b], accels[b], k, Ts[b]))
        for x, y in zip(batched, one):
            _eq(x[b], y)


def _close(got, want, rtol=RTOL, scale=None):
    """Within rtol of the reference's largest magnitude (entries that
    cancel are held to the whole quantity's scale)."""
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    bound = rtol * (np.abs(want).max() if scale is None else scale)
    assert np.abs(got - want).max() <= bound, (np.abs(got - want).max(), bound)


def test_normal_equations_and_scale_against_reference():
    (j_ref, ref), (j_cur, cur), k, T = _scene("120x160")
    rd = residuals.compute_residuals(*_residual_inputs(
        ref, pyramid.build_acceleration(cur), Intrinsics(*k), _t(T)))
    j_rd = j_res.ResidualData(*(jnp.asarray(_np(f)) for f in rd))
    P = np.array([[3000.0, 50.0], [50.0, 2.0e5]], np.float32)
    w = robust.tdist_weights(rd.residuals, _t(P), rd.mask)
    with jax.disable_jit():
        j_w = j_rob.tdist_weights(j_rd.residuals, jnp.asarray(P), j_rd.mask)
        j_A, j_b = j_res.normal_equations(j_rd, j_w, jnp.asarray(P))
        j_S = j_rob.tdist_scale(j_rd.residuals, j_w, j_rd.num_valid)
        j_ll = j_rob.tdist_log_likelihood(j_rd.residuals, jnp.asarray(P), j_rd.mask)
    np.testing.assert_allclose(_np(w), _np(j_w), rtol=1e-6)
    A, b = residuals.normal_equations(rd, w, _t(P))
    _close(A, j_A)
    _close(b, j_b)
    _eq(A, A.T)
    _close(robust.tdist_scale(rd.residuals, w, rd.num_valid), j_S)
    ll = robust.tdist_log_likelihood(rd.residuals, _t(P), rd.mask)
    n = int(rd.num_valid)
    _close(ll, j_ll, scale=abs(0.5 * n * np.log(np.linalg.det(P.astype(np.float64)))))
    # a batch of two systems against each one's call
    rd2 = residuals.ResidualData(*(torch.stack([f, f.flip(0) if f.dim() else f]) for f in rd))
    w2 = torch.stack([w, w.flip(0)])
    P2 = torch.stack([_t(P), _t(P) * 2.0])
    A2, b2 = residuals.normal_equations(rd2, w2, P2)
    for i in range(2):
        one = residuals.ResidualData(*(f[i] for f in rd2))
        Ai, bi = residuals.normal_equations(one, w2[i], P2[i])
        _close(A2[i], Ai)
        _close(b2[i], bi)


def _residuals(n=256, seed=0, outliers=0.1):
    """tests/test_robust.py's residuals."""
    rng = np.random.default_rng(seed)
    r = rng.normal(0, 0.05, (n, 2))
    m = rng.random(n) < outliers
    r[m] += rng.normal(0, 1.0, (m.sum(), 2))
    mask = rng.random(n) > 0.2
    r[~mask] = 0.0
    return r.astype(np.float32), mask


def test_robust_functions_against_reference():
    r, mask = _residuals(1000, seed=7)
    P = np.array([[30.0, 2.0], [2.0, 50.0]], np.float32)
    mean = np.array([0.01, -0.02], np.float32)
    x = np.linspace(-10, 10, 201).astype(np.float32)
    with jax.disable_jit():
        want = {
            "huber": j_rob.huber_weights(jnp.asarray(x)),
            "tukey": j_rob.tukey_weights(jnp.asarray(x)),
            "tdist1d": j_rob.tdist_weights_1d(jnp.asarray(x)),
            "maha": j_rob.mahalanobis_sq(jnp.asarray(r), jnp.asarray(P), jnp.asarray(mean)),
            "normal": j_rob.normal_scale(jnp.asarray(r[:, 0]), jnp.asarray(mask)),
            "mad": j_rob.mad_scale(jnp.asarray(r[:, 1]), jnp.asarray(mask)),
            "fixed": j_rob.tdist_fixed_point(jnp.asarray(r), jnp.asarray(mask)),
        }
    _eq(robust.huber_weights(_t(x)), want["huber"])
    _eq(robust.tukey_weights(_t(x)), want["tukey"])
    _eq(robust.tdist_weights_1d(_t(x)), want["tdist1d"])
    np.testing.assert_allclose(_np(robust.mahalanobis_sq(_t(r), _t(P), _t(mean))),
                               _np(want["maha"]), rtol=RTOL)
    np.testing.assert_allclose(float(robust.normal_scale(_t(r[:, 0]), _t(mask))),
                               float(want["normal"]), rtol=RTOL)
    _eq(robust.mad_scale(_t(r[:, 1]), _t(mask)), want["mad"])
    _close(robust.tdist_fixed_point(_t(r), _t(mask)), want["fixed"], rtol=1e-4)
    # a stream axis: per-stream scales and medians
    rb = torch.stack([_t(r[:, 0]), _t(r[:, 1])])
    mb = torch.stack([_t(mask), _t(~mask | (r[:, 0] > 0))])
    for fn in (robust.normal_scale, robust.mad_scale):
        batched = fn(rb, mb)
        for b in range(2):
            _eq(batched[b], fn(rb[b], mb[b]))


@pytest.mark.parametrize("count", [6, 7, 1, 0])
def test_masked_median_even_and_odd(count):
    """Entry n // 2 of the sorted masked entries: the upper median for an
    even count (``torch.median`` would give the lower one), +inf with no
    entry."""
    x = np.array([5.0, -1.0, 3.0, 8.0, 2.0, 7.0, 4.0, 9.0], np.float32)
    mask = np.arange(8) < count
    big = np.where(mask, x, np.inf).astype(np.float32)
    want = j_rob._masked_median(jnp.asarray(big), jnp.asarray(mask.sum()))
    got = robust._masked_median(_t(big), torch.tensor(mask.sum()))
    _eq(got, want)
    if count:
        assert float(got) == np.sort(x[:count])[count // 2]
    batched = robust._masked_median(torch.stack([_t(big), _t(big[::-1].copy())]),
                                    torch.tensor([count, count]))
    _eq(batched, torch.stack([got, got]))


def _systems():
    rng = np.random.default_rng(1)
    J = rng.standard_normal((40, 6)).astype(np.float32)
    x_true = rng.standard_normal(6).astype(np.float32)
    J5 = J.copy()
    J5[:, 5] = 0.0  # rank-deficient: the last twist direction unobserved
    return J, J5, x_true


@pytest.mark.parametrize("rank", ["full", "deficient"])
def test_solvers_against_reference(rank):
    J, J5, x_true = _systems()
    J = J if rank == "full" else J5
    A = (J.T @ J).astype(np.float32)
    b = (J.T @ J @ x_true).astype(np.float32)
    r = (-J @ x_true).astype(np.float32)
    w = np.random.default_rng(2).uniform(0.5, 1.5, 40).astype(np.float32)
    x_evd = least_squares.solve_evd(_t(A), _t(b))
    np.testing.assert_allclose(_np(x_evd), _np(j_ls.solve_evd(jnp.asarray(A), jnp.asarray(b))),
                               rtol=1e-4, atol=1e-4)
    for weights in (None, w):
        x_svd = least_squares.solve_svd(_t(J), _t(r), None if weights is None else _t(weights))
        want = j_ls.solve_svd(jnp.asarray(J), jnp.asarray(r),
                              None if weights is None else jnp.asarray(weights))
        np.testing.assert_allclose(_np(x_svd), _np(want), rtol=1e-4, atol=1e-4)
    if rank == "deficient":
        assert abs(float(x_evd[5])) < 1e-4  # truncated, not amplified
        assert abs(float(x_svd[5])) < 1e-4  # the minimum-norm solution
    batched = least_squares.solve_evd(torch.stack([_t(A), _t(A) * 2]), torch.stack([_t(b), _t(b)]))
    np.testing.assert_allclose(_np(batched[1]), _np(x_evd) / 2, rtol=1e-4, atol=1e-5)


def test_combine_and_camera_matrix():
    ne = least_squares.NormalEquations(A=torch.eye(6) * 2, b=torch.arange(6.0),
                                       error=torch.tensor(1.5), num_constraints=torch.tensor(20))
    merged = least_squares.combine(ne, ne)
    _eq(merged.A, torch.eye(6) * 4)
    _eq(merged.b, torch.arange(6.0) * 2)
    assert float(merged.error) == 3.0 and int(merged.num_constraints) == 40
    k = SIZES["60x80"][1]
    _eq(Intrinsics(*k).matrix(), JIntrinsics(*k).matrix())
    assert Intrinsics(*k).matrix(torch.float64).dtype == torch.float64


# --- tests/test_residuals.py and tests/test_robust.py on the port ---------


def _flat_level(img, depth=2.0, valid=None):
    shape = img.shape
    return pyramid.make_level(
        _t(img), torch.full(shape, depth, dtype=torch.float32),
        torch.ones(shape, dtype=torch.bool) if valid is None else _t(valid))


def test_bilinear_matches_scipy():
    from scipy.ndimage import map_coordinates

    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (24, 32)).astype(np.float32)
    accel = pyramid.build_acceleration(_flat_level(img))
    u = rng.uniform(0.0, 30.9, 100).astype(np.float32)
    v = rng.uniform(0.0, 22.9, 100).astype(np.float32)
    values, valid = interp.bilinear_sample_accel(accel, _t(u), _t(v))
    expected = map_coordinates(img, np.stack([v, u]), order=1)
    np.testing.assert_allclose(_np(values)[:, 0], expected, atol=1e-3)
    assert _np(valid).all()


def test_bilinear_validity_and_bounds():
    valid = np.ones((8, 8), bool)
    valid[4, 4] = False
    accel = pyramid.build_acceleration(_flat_level(np.ones((8, 8), np.float32), valid=valid))
    _, ok = interp.bilinear_sample_accel(accel, torch.tensor([3.05, 1.0]), torch.tensor([3.05, 1.0]))
    assert not bool(ok[0]) and bool(ok[1])
    accel = pyramid.build_acceleration(_flat_level(np.ones((8, 8), np.float32)))
    _, ok = interp.bilinear_sample_accel(accel, torch.tensor([-0.5, 7.5, 3.0, 6.999]),
                                         torch.tensor([3.0, 3.0, 7.2, 6.5]))
    assert list(_np(ok)) == [False, False, False, True]


def test_quad_table_matches_accel_sampling():
    rng = np.random.default_rng(7)
    img = rng.uniform(0, 255, (24, 32)).astype(np.float32)
    depth = rng.uniform(0.5, 3.0, (24, 32)).astype(np.float32)
    valid = rng.random((24, 32)) > 0.1
    level = pyramid.make_level(_t(img), _t(np.where(valid, depth, 0).astype(np.float32)),
                               _t(valid))
    accel = pyramid.build_acceleration(level)
    u = _t(rng.uniform(-2.0, 33.0, 300).astype(np.float32))
    v = _t(rng.uniform(-2.0, 25.0, 300).astype(np.float32))
    vals_a, ok_a = interp.bilinear_sample_accel(accel, u, v)
    vals_q, ok_q = interp.bilinear_sample_quad(interp.build_quad_table(accel), (24, 32), u, v)
    _eq(ok_a, ok_q)
    np.testing.assert_allclose(_np(vals_q)[_np(ok_a)], _np(vals_a)[_np(ok_a)], atol=1e-5)


def _np_exp_se3(xi):
    from dvo_slam_tpu_torch.utils.synthetic import _pose_from_rt

    return _pose_from_rt(np.asarray(xi[3:], np.float64), np.asarray(xi[:3], np.float64))


@pytest.mark.parametrize("which", ["projection", "transform_z"])
def test_jacobians_finite_difference(which):
    rng = np.random.default_rng(1 if which == "projection" else 2)
    pts = rng.uniform([-1, -1, 0.5], [1, 1, 4.0], (20, 3))
    if which == "projection":
        J = _np(residuals.projection_jacobian(torch.tensor(pts, dtype=torch.float32)))
    else:
        J = _np(residuals.transform_z_jacobian(torch.tensor(pts, dtype=torch.float32)))
    eps = 1e-6
    for n, p in enumerate(pts):
        for i in range(6):
            xi = np.zeros(6)
            xi[i] = eps
            Tp, Tm = _np_exp_se3(xi), _np_exp_se3(-xi)
            pp = Tp[:3, :3] @ p + Tp[:3, 3]
            pm = Tm[:3, :3] @ p + Tm[:3, 3]
            if which == "projection":
                fd = (pp[:2] / pp[2] - pm[:2] / pm[2]) / (2 * eps)
                np.testing.assert_allclose(J[n, :, i], fd, rtol=1e-3, atol=1e-5)
            else:
                np.testing.assert_allclose(J[n, i], (pp[2] - pm[2]) / (2 * eps),
                                           rtol=1e-3, atol=1e-6)


def test_depth_stddev_kinect_model():
    assert float(residuals.depth_stddev(torch.tensor(0.4))) == np.float32(0.0012)
    np.testing.assert_allclose(float(residuals.depth_stddev(torch.tensor(1.4))),
                               0.0012 + 0.0019, rtol=1e-6)


def test_identity_residuals_are_zero_and_reprojection():
    k = Intrinsics(80.0, 80.0, 39.5, 29.5)
    i0, d0, v0 = j_syn.render_frame(np.eye(4), JIntrinsics(*k), (60, 80), seed=3)
    ref = pyramid.make_level(_t(i0), _t(d0), _t(v0))
    rd = residuals.compute_residuals(*_residual_inputs(
        ref, pyramid.build_acceleration(ref), k, torch.eye(4)))
    assert int(rd.num_valid) > 3000
    np.testing.assert_allclose(_np(rd.residuals), 0.0, atol=1e-3)
    uv = _np(project(unproject(_t(d0), k).reshape(-1, 3), k)).reshape(60, 80, 2)
    uu, vv = np.meshgrid(np.arange(80), np.arange(60))
    np.testing.assert_allclose(uv[..., 0], uu, atol=1e-3)
    np.testing.assert_allclose(uv[..., 1], vv, atol=1e-3)


def test_normal_equations_oracle():
    rng = np.random.default_rng(4)
    n = 64
    J = rng.normal(size=(n, 2, 6)).astype(np.float32)
    r = rng.normal(size=(n, 2)).astype(np.float32)
    mask = rng.random(n) > 0.3
    J[~mask] = 0.0
    r[~mask] = 0.0
    w = np.where(mask, rng.uniform(0.1, 1.0, n), 0.0).astype(np.float32)
    P = np.array([[2.0, 0.3], [0.3, 1.5]], np.float32)
    rd = residuals.ResidualData(_t(r), _t(J), _t(mask), torch.tensor(int(mask.sum())))
    A, b = residuals.normal_equations(rd, _t(w), _t(P))
    A_ref = sum(w[i] * J[i].T @ P @ J[i] for i in range(n))
    b_ref = -sum(w[i] * J[i].T @ P @ r[i] for i in range(n))
    np.testing.assert_allclose(_np(A), A_ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(b), b_ref, rtol=1e-4, atol=1e-4)


def test_least_squares_solver_registry():
    J, J5, x_true = _systems()
    r = (-J @ x_true).astype(np.float32)
    A, b = _t(J.T @ J), _t(-J.T @ r)
    for solver in (least_squares.solve_ldlt, least_squares.solve_evd):
        np.testing.assert_allclose(_np(solver(A, b)), x_true, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(_np(least_squares.solve_svd(_t(J), _t(r))), x_true,
                               rtol=1e-3, atol=1e-3)
    x5 = _np(least_squares.solve_evd(_t(J5.T @ J5), _t(J5.T @ J5 @ x_true)))
    np.testing.assert_allclose(x5[:5], x_true[:5], rtol=1e-3, atol=1e-3)
    assert abs(x5[5]) < 1e-4


def test_tdist_oracles():
    r, mask = _residuals()
    P = np.array([[30.0, 2.0], [2.0, 50.0]], np.float32)
    w = _np(robust.tdist_weights(_t(r), _t(P), _t(mask)))
    for i in range(len(r)):
        want = 7.0 / (5.0 + r[i] @ P @ r[i]) if mask[i] else 0.0
        np.testing.assert_allclose(w[i], want, rtol=1e-5)
    r, mask = _residuals(seed=1)
    w = np.where(mask, 0.5, 0.0).astype(np.float32)
    n = mask.sum()
    sigma = _np(robust.tdist_scale(_t(r), _t(w), torch.tensor(n)))
    expected = sum(w[i] * np.outer(r[i], r[i]) for i in range(len(r))) / (n - 3)
    np.testing.assert_allclose(sigma, expected, rtol=1e-4, atol=1e-8)
    r, mask = _residuals(seed=2)
    P = np.array([[40.0, 1.0], [1.0, 60.0]], np.float32)
    ll = float(robust.tdist_log_likelihood(_t(r), _t(P), _t(mask)))
    s = sum(np.log1p(0.2 * (r[i] @ P @ r[i])) for i in range(len(r)) if mask[i])
    np.testing.assert_allclose(ll, 0.5 * mask.sum() * np.log(np.linalg.det(P)) - 3.5 * s,
                               rtol=1e-4)


def test_tdist_fixed_point_converges():
    rng = np.random.default_rng(3)
    n = 4096
    r = rng.normal(0, 0.1, (n, 2))
    out = rng.random(n) < 0.2
    r[out] = rng.normal(0, 2.0, (out.sum(), 2))
    sigma = _np(robust.tdist_fixed_point(torch.tensor(r, dtype=torch.float32),
                                         torch.ones(n, dtype=torch.bool)))
    assert 0.005 < sigma[0, 0] < 0.05 and 0.005 < sigma[1, 1] < 0.05


def test_univariate_oracles():
    x = torch.linspace(-10, 10, 101)
    hw, tw = _np(robust.huber_weights(x)), _np(robust.tukey_weights(x))
    assert hw.max() <= 1.0 and hw.min() > 0.0
    assert tw[0] == 0.0 and tw[50] == 1.0
    np.testing.assert_allclose(hw[50], 1.0)
    np.testing.assert_allclose(hw[0], 1.345 / 10.0, rtol=1e-5)
    rng = np.random.default_rng(4)
    x = rng.normal(0, 2.0, 1001).astype(np.float32)
    ones = torch.ones(1001, dtype=torch.bool)
    np.testing.assert_allclose(float(robust.mad_scale(_t(x), ones)),
                               1.4826 * np.median(np.abs(x - np.median(x))), rtol=0.02)
    rng = np.random.default_rng(5)
    x = rng.normal(1.0, 3.0, 2000).astype(np.float32)
    np.testing.assert_allclose(float(robust.normal_scale(_t(x), torch.ones(2000, dtype=torch.bool))),
                               x.std(ddof=1), rtol=1e-3)
