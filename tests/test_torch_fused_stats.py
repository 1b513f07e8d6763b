"""The fused statistics' plain twin against the reference, on the CPU.

The twin (``fused_stats_plain``) is the port's CPU path and the CUDA
kernel's oracle.  It is held against the reference's XLA twin
(``fused_stats_xla``) and its Pallas kernel run in interpret mode, as
``tests/test_pallas.py`` runs them, on the same ``_level_pair`` scenes.
Tolerances are the reference's own for kernel vs twin: ``num_valid``
equal, Gram blocks rtol 1e-4, ``log_sum`` rtol 1e-5 (the Gram and the
log sum are reductions over the pixels, summed in another order).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dvo_slam_tpu.models.dense_tracker import _build_refpack
from dvo_slam_tpu.ops import pallas_kernels, se3
from dvo_slam_tpu.ops.camera import Intrinsics
from dvo_slam_tpu.ops.interp import build_quad_table_cm
from dvo_slam_tpu.ops.pyramid import build_acceleration_cm, build_pyramid, selection_mask
from dvo_slam_tpu.ops.residuals import warp_and_sample_cm
from dvo_slam_tpu.utils import synthetic

from dvo_slam_tpu_torch.config import TrackerConfig
from dvo_slam_tpu_torch.models import dense_tracker as t_dt
from dvo_slam_tpu_torch.ops import fused_kernels
from dvo_slam_tpu_torch.ops.camera import Intrinsics as TIntrinsics
from dvo_slam_tpu_torch.tools import fused_check

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

K = Intrinsics(80.0, 80.0, 39.5, 29.5)
TK = TIntrinsics(*K)
SHAPE = (60, 80)
P3 = np.asarray([4000.0, 10.0, 1.5e5], np.float32)
GRAM_FIELDS = ("m00", "m01", "m11", "v", "scale_sum")


def _level_pair(twist, seed=0):
    """tests/test_pallas.py's scene: a frame and its warp by exp(twist)."""
    T = np.asarray(se3.exp_se3(jnp.asarray(twist, jnp.float32)), np.float64)
    i0, d0, v0 = synthetic.render_frame(
        np.eye(4), K, SHAPE, seed=seed, depth_noise=0.002, invalid_fraction=0.03
    )
    i1, d1, v1 = synthetic.render_frame(
        T, K, SHAPE, seed=seed, depth_noise=0.002, invalid_fraction=0.03
    )
    ref = build_pyramid(jnp.asarray(i0), jnp.asarray(d0), jnp.asarray(v0), 1)[0]
    cur = build_pyramid(jnp.asarray(i1), jnp.asarray(d1), jnp.asarray(v1), 1)[0]
    refpack = _build_refpack(ref, selection_mask(ref), K)
    quad = build_quad_table_cm(build_acceleration_cm(cur), SHAPE[1])
    sampled = warp_and_sample_cm(refpack, quad, SHAPE, K, jnp.asarray(T, jnp.float32))
    return np.array(sampled), np.array(refpack)


SCENES = {
    "seed3": ([0.008, -0.004, 0.0, 0.002, 0.0, -0.003], 3),
    "seed4": ([0.009, -0.003, 0.004, 0.002, 0.001, -0.002], 4),
}


def _twin(sampled, refpack, first_iter):
    return fused_kernels.fused_stats_plain(
        torch.from_numpy(sampled), torch.from_numpy(refpack), torch.from_numpy(P3),
        torch.tensor(first_iter, dtype=torch.int32), TK,
    )


def _assert_matches(port, ref):
    assert float(port.num_valid) == float(ref.num_valid) > 2000
    for field in GRAM_FIELDS:
        np.testing.assert_allclose(
            getattr(port, field).numpy(), np.asarray(getattr(ref, field)),
            rtol=1e-4, err_msg=field,
        )


@pytest.mark.parametrize("first_iter", [0, 1])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_plain_twin_matches_xla_twin(scene, first_iter):
    sampled, refpack = _level_pair(*SCENES[scene])
    ref = pallas_kernels.fused_stats_xla(
        jnp.asarray(sampled), jnp.asarray(refpack), jnp.asarray(P3),
        jnp.asarray(first_iter, jnp.int32), K,
    )
    port = _twin(sampled, refpack, first_iter)
    _assert_matches(port, ref)
    np.testing.assert_allclose(float(port.log_sum), float(ref.log_sum), rtol=1e-5)


@pytest.mark.parametrize("first_iter", [0, 1])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_plain_twin_matches_pallas_interpret(scene, first_iter):
    sampled, refpack = _level_pair(*SCENES[scene])
    ref = pallas_kernels.fused_stats_pallas(
        jnp.asarray(sampled), jnp.asarray(refpack), jnp.asarray(P3),
        jnp.asarray(first_iter, jnp.int32), K, interpret=True,
    )
    port = _twin(sampled, refpack, first_iter)
    _assert_matches(port, ref)
    np.testing.assert_allclose(float(port.log_sum), float(ref.log_sum), rtol=1e-5)


@pytest.mark.parametrize("first_iter", [0, 1])
def test_partials_residuals_and_weights(first_iter):
    """The single-pass partials: per-pixel residuals and weights bit-equal
    to the reference's fused_partials_xla (the same float32 ops in the same
    order, the weight's division rounded once)."""
    sampled, refpack = _level_pair(*SCENES["seed3"])
    ref = pallas_kernels.fused_partials_xla(
        jnp.asarray(sampled), jnp.asarray(refpack), jnp.asarray(P3),
        jnp.asarray(first_iter, jnp.int32), K,
    )
    port = fused_kernels.fused_partials_plain(
        torch.from_numpy(sampled), torch.from_numpy(refpack), torch.from_numpy(P3),
        torch.tensor(first_iter, dtype=torch.int32), TK,
    )
    _assert_matches(port, ref)
    np.testing.assert_array_equal(port.residuals.numpy(), np.asarray(ref.residuals))
    np.testing.assert_array_equal(port.weights.numpy(), np.asarray(ref.weights))


def test_normal_equations_and_scale_matrix():
    """assemble_normal_equations / scale_matrix on the same partials."""
    sampled, refpack = _level_pair(*SCENES["seed4"])
    ref = pallas_kernels.fused_stats_xla(
        jnp.asarray(sampled), jnp.asarray(refpack), jnp.asarray(P3),
        jnp.asarray(0, jnp.int32), K,
    )
    port = _twin(sampled, refpack, 0)
    P = np.asarray([[5000.0, -30.0], [-30.0, 1.0e5]], np.float32)
    A_r, b_r = pallas_kernels.assemble_normal_equations(ref, jnp.asarray(P))
    A_p, b_p = fused_kernels.assemble_normal_equations(port, torch.from_numpy(P))
    np.testing.assert_allclose(A_p.numpy(), np.asarray(A_r), rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(b_p.numpy(), np.asarray(b_r), rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(
        fused_kernels.scale_matrix(port).numpy(),
        np.asarray(pallas_kernels.scale_matrix(ref)), rtol=1e-4,
    )


def test_dispatch_by_device():
    """A CPU tensor takes the plain twin; the kernel wrappers, single and
    batched, refuse CPU tensors and count no launch."""
    sampled, refpack = _level_pair(*SCENES["seed3"])
    args = (
        torch.from_numpy(sampled), torch.from_numpy(refpack), torch.from_numpy(P3),
        torch.tensor(0, dtype=torch.int32), TK,
    )
    before = (fused_kernels.fused_stats_cuda.launches,
              fused_kernels.fused_stats_batched_cuda.launches)
    want = fused_kernels.fused_stats_plain(*args)
    assert torch.isfinite(want.log_sum) and float(want.num_valid) > 0
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_kernels.fused_stats_cuda(*args)
    batched = (args[0][None], args[1][None], args[2][None], *args[3:])
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_kernels.fused_stats_batched_cuda(*batched)
    assert (fused_kernels.fused_stats_cuda.launches,
            fused_kernels.fused_stats_batched_cuda.launches) == before


def test_backend_resolution():
    cpu = torch.device("cpu")
    cfg = TrackerConfig()
    assert t_dt._resolve_backend(cfg, cpu) == "fused"
    assert t_dt._resolve_backend(cfg, torch.device("cuda")) == "pallas"
    with pytest.raises(ValueError, match="CUDA tensors"):
        t_dt._resolve_backend(dataclasses.replace(cfg, kernel_backend="pallas"), cpu)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_dt._resolve_backend(dataclasses.replace(cfg, kernel_backend="xla"), cpu)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_dt._resolve_backend(dataclasses.replace(cfg, use_weighting=False), cpu)


def test_kernel_check_against_the_xla_twin():
    """The card's kernel-vs-twin check (``tools/fused_check``), run on the
    CPU with the reference's XLA twin in the kernel's place: it passes, and
    it fails once an entry moves by 2e-4 of sqrt(G_aa G_bb) or num_valid
    changes."""
    sampled, refpack = _level_pair(*SCENES["seed4"])
    ref = pallas_kernels.fused_stats_xla(
        jnp.asarray(sampled), jnp.asarray(refpack), jnp.asarray(P3),
        jnp.asarray(0, jnp.int32), K,
    )
    ref = fused_kernels.FusedStats(*(torch.from_numpy(np.array(f)) for f in ref))
    port = _twin(sampled, refpack, 0)
    abs_err, scaled_err = fused_check.compare_fused_stats(ref, port)
    assert 0.0 < scaled_err <= fused_check.GRAM_RTOL and abs_err > 0.0
    g = fused_check.gram14(port)
    np.testing.assert_array_equal(g, g.T)
    assert g[8, 12] == float(port.v[2, 2]) and g[12, 13] == float(port.scale_sum[1])
    bad_v = port.v.clone()
    bad_v[2, 5] += 2e-4 * float(torch.sqrt(port.m11[5, 5] * port.scale_sum[0]))
    with pytest.raises(RuntimeError, match=r"Gram entry \(11, 12\)"):
        fused_check.compare_fused_stats(port._replace(v=bad_v), ref)
    with pytest.raises(RuntimeError, match="num_valid"):
        fused_check.compare_fused_stats(port._replace(num_valid=port.num_valid + 1), ref)


@pytest.mark.parametrize("first_iter", [0, 1])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_exact_gram_check(scene, first_iter):
    """The card's element-wise Gram check (``fused_check.compare_exact_gram``)
    on the CPU.  The float64 Gram of the twin's float32 rows, rounded once
    to float32 as the kernel rounds its double sums, passes within one
    float32 rounding; it agrees with the reference's XLA twin and with the
    port's float32 twin within the sqrt(G_aa G_bb) bound; an entry moved by
    2e-5 of itself fails."""
    sampled, refpack = _level_pair(*SCENES[scene])
    args = (
        torch.from_numpy(sampled), torch.from_numpy(refpack), torch.from_numpy(P3),
        torch.tensor(first_iter, dtype=torch.int32), TK,
    )
    exact = fused_check.exact_gram(*args)
    twin = fused_kernels.fused_stats_plain(*args)
    assert exact[12, 12] > 0 and (exact[0:12, 0:12].diagonal() > 0).all()

    g = torch.zeros((16, 16), dtype=torch.float64)
    g[:14, :14] = torch.from_numpy(exact)
    g[14, 14] = float(twin.num_valid)
    m00, m01, m11, v, scale_sum, n = fused_kernels._unpack_gram(g.float())
    rounded = twin._replace(m00=m00, m01=m01, m11=m11, v=v, scale_sum=scale_sum, num_valid=n)
    assert fused_check.compare_exact_gram(rounded, exact) <= 2.0**-24
    fused_check.compare_fused_stats(rounded, twin)
    ref = pallas_kernels.fused_stats_xla(
        jnp.asarray(sampled), jnp.asarray(refpack), jnp.asarray(P3),
        jnp.asarray(first_iter, jnp.int32), K,
    )
    fused_check.compare_fused_stats(
        rounded, fused_kernels.FusedStats(*(torch.from_numpy(np.array(f)) for f in ref))
    )

    bad_v = rounded.v.clone()
    bad_v[1, 3] *= 1.0 + 2e-5  # v01[3] = G[3, 13]
    with pytest.raises(RuntimeError, match=r"Gram entry \(3, 13\)"):
        fused_check.compare_exact_gram(rounded._replace(v=bad_v), exact)


def _partials_args(sampled, refpack, first_iter):
    return (
        torch.from_numpy(sampled), torch.from_numpy(refpack), torch.from_numpy(P3),
        torch.tensor(first_iter, dtype=torch.int32), TK,
    )


def _pallas_partials(sampled, refpack, first_iter):
    return pallas_kernels.fused_partials_pallas(
        jnp.asarray(sampled), jnp.asarray(refpack), jnp.asarray(P3),
        jnp.asarray(first_iter, jnp.int32), K, interpret=True,
    )


@pytest.mark.parametrize("first_iter", [0, 1])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_partials_twin_matches_pallas_interpret(scene, first_iter):
    """fused_partials_plain against the reference's Pallas kernel in
    interpret mode, at the reference's tolerances for that kernel against
    its XLA twin (tests/test_pallas.py::test_pallas_interpret_matches_xla_twin)."""
    sampled, refpack = _level_pair(*SCENES[scene])
    ref = _pallas_partials(sampled, refpack, first_iter)
    port = fused_kernels.fused_partials_plain(*_partials_args(sampled, refpack, first_iter))
    _assert_matches(port, ref)
    np.testing.assert_allclose(port.residuals.numpy(), np.asarray(ref.residuals), atol=1e-6)
    np.testing.assert_allclose(port.weights.numpy(), np.asarray(ref.weights), rtol=1e-5, atol=1e-8)


def test_partials_dispatch_by_device():
    """A CPU tensor takes the plain twin (bit-equal to it, no launch); the
    kernel wrapper refuses CPU tensors."""
    sampled, refpack = _level_pair(*SCENES["seed4"])
    args = _partials_args(sampled, refpack, 1)
    before = fused_kernels.fused_partials_cuda.launches
    got = fused_kernels.fused_partials(*args)
    want = fused_kernels.fused_partials_plain(*args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert fused_kernels.fused_partials_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_kernels.fused_partials_cuda(*args)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_kernels.fused_partials_rows_cuda(*args)


def test_partials_check_against_pallas_interpret():
    """The card's partials check (``fused_check.compare_fused_partials``),
    run on the CPU with the reference's Pallas kernel (interpret mode) in
    the CUDA kernel's place: it passes, and it fails once the mask row,
    a residual or a weight moves past its tolerance."""
    sampled, refpack = _level_pair(*SCENES["seed3"])
    args = _partials_args(sampled, refpack, 0)
    ref = _pallas_partials(sampled, refpack, 0)
    mask = torch.from_numpy(np.asarray(fused_check.twin_rows(*args)[3]))
    ref_rw = torch.cat([torch.from_numpy(np.array(ref.residuals)),
                        torch.from_numpy(np.array(ref.weights))[None], mask[None]])
    gram = torch.zeros((16, 16))
    g14 = torch.from_numpy(fused_check.gram14(
        fused_kernels.FusedPartials(*(torch.from_numpy(np.array(f)) for f in ref))))
    gram[:14, :14] = g14
    gram[14, 14] = float(ref.num_valid)
    kernel = fused_kernels.partials_from_rows(gram, ref_rw)
    twin = fused_kernels.fused_partials_plain(*args)
    twin_rw = fused_check.twin_rows(*args)
    abs_err, scaled_err, not_bit_equal = fused_check.compare_fused_partials(
        kernel, ref_rw, twin, twin_rw
    )
    assert scaled_err <= fused_check.GRAM_RTOL and 0 <= not_bit_equal <= ref_rw.numel()
    valid = int(torch.nonzero(mask)[0])
    for row, delta, message in ((3, -1.0, "mask row"), (1, 2e-6, "residuals"),
                                (2, 1e-4, "weights")):
        bad = ref_rw.clone()
        bad[row, valid] += delta * (1.0 if row != 2 else float(bad[2, valid]))
        with pytest.raises(RuntimeError, match=message):
            fused_check.compare_fused_partials(kernel, bad, twin, twin_rw)
