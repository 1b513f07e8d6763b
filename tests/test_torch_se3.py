"""The port's SE(3) functions that the pose graph reads, against the
reference, on the CPU: ``exp_so3``, ``compose``, ``adjoint``, ``ad_se3``,
``right_jacobian_inverse_approx``, ``transform_points`` and
``orthonormalize`` on seeded batches, in float32 (within 1e-6) and
float64 (the reference under ``jax.enable_x64``, within 1e-13); and the
identities the reference's ``tests/test_se3.py`` holds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvo_slam_tpu.ops import se3 as j_se3

from dvo_slam_tpu_torch.ops import se3 as t_se3

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

ATOL = {np.float32: 1e-6, np.float64: 1e-13}
DTYPES = [np.float32, np.float64]


def _twists(seed, n=16, dtype=np.float64, scale=0.8):
    """[n, 6] twists, small and large angles both (the Taylor branch below
    theta = 0.1 and the closed form above)."""
    rng = np.random.default_rng(seed)
    xi = rng.normal(0.0, scale, (n, 6))
    xi[: n // 2, 3:] *= 0.02
    return xi.astype(dtype)


def _both(fn_name, dtype, *args):
    """(port result as NumPy, reference result as NumPy) of ``fn_name``."""
    with jax.enable_x64(dtype == np.float64):
        ref = np.asarray(getattr(j_se3, fn_name)(*(jnp.asarray(a) for a in args)))
    port = getattr(t_se3, fn_name)(*(torch.from_numpy(np.array(a)) for a in args)).numpy()
    assert port.dtype == ref.dtype == dtype
    return port, ref


def _poses(seed, dtype):
    with jax.enable_x64(dtype == np.float64):
        return np.asarray(j_se3.exp_se3(jnp.asarray(_twists(seed, dtype=dtype))))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed", [0, 1])
def test_exp_so3_ad_and_jacobian(dtype, seed):
    xi = _twists(seed, dtype=dtype)
    for fn, arg in (("exp_so3", xi[:, 3:]), ("ad_se3", xi),
                    ("right_jacobian_inverse_approx", xi)):
        port, ref = _both(fn, dtype, arg)
        np.testing.assert_allclose(port, ref, atol=ATOL[dtype], rtol=0, err_msg=fn)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed", [2, 3])
def test_adjoint_compose_transform_points(dtype, seed):
    T = _poses(seed, dtype)
    U = _poses(seed + 10, dtype)
    port, ref = _both("adjoint", dtype, T)
    np.testing.assert_allclose(port, ref, atol=ATOL[dtype] * 4, rtol=0)
    port, ref = _both("compose", dtype, T, U)
    np.testing.assert_allclose(port, ref, atol=ATOL[dtype] * 4, rtol=0)
    points = np.random.default_rng(seed).normal(0, 2.0, (T.shape[0], 5, 3)).astype(dtype)
    port, ref = _both("transform_points", dtype, T, points)
    np.testing.assert_allclose(port, ref, atol=ATOL[dtype] * 10, rtol=0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_orthonormalize(dtype):
    """A drifted rotation block comes back onto SO(3), as the reference's
    does; the translation is kept."""
    T = _poses(4, dtype).copy()
    drift = np.random.default_rng(4).normal(0, 1e-3, (T.shape[0], 3, 3)).astype(dtype)
    T[:, :3, :3] += drift
    port, ref = _both("orthonormalize", dtype, T)
    np.testing.assert_allclose(port, ref, atol=ATOL[dtype] * 10, rtol=0)
    R = port[:, :3, :3].astype(np.float64)
    np.testing.assert_allclose(R @ np.swapaxes(R, 1, 2), np.broadcast_to(np.eye(3), R.shape),
                               atol=10 * ATOL[dtype])
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=10 * ATOL[dtype])
    np.testing.assert_array_equal(port[:, :3, 3], T[:, :3, 3])


@pytest.mark.parametrize("dtype", DTYPES)
def test_identities(dtype):
    """Ad(T) xi = log(T exp(xi) T^-1) (first order), Jr^-1(0) = I, and
    exp_so3 agrees with exp_se3's rotation block."""
    xi = torch.from_numpy(_twists(5, dtype=dtype))
    T = t_se3.exp_se3(xi)
    eta = 1e-4 * torch.from_numpy(_twists(6, dtype=dtype))
    lhs = t_se3.log_se3(T @ t_se3.exp_se3(eta) @ t_se3.inverse(T))
    rhs = torch.einsum("nij,nj->ni", t_se3.adjoint(T), eta)
    assert float((lhs - rhs).abs().max()) < (1e-6 if dtype == np.float32 else 1e-8)
    np.testing.assert_array_equal(
        t_se3.right_jacobian_inverse_approx(torch.zeros(6, dtype=xi.dtype)).numpy(),
        np.eye(6, dtype=dtype))
    np.testing.assert_allclose(t_se3.exp_so3(xi[:, 3:]).numpy(), T[:, :3, :3].numpy(),
                               atol=ATOL[dtype])
