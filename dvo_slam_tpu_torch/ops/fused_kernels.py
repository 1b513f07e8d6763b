"""Fused IRLS statistics of the dense-tracking inner loop (counterpart of
``dvo_slam_tpu.ops.pallas_kernels``).

One pass over the pixels of a level computes, per pixel, the residual
pair, the t-distribution weight from the previous precision and the 12
Jacobian entries, and reduces them into the 16x16 Gram matrix of
  U = [sqrt(w) J_I (6); sqrt(w) J_Z (6); sqrt(w) r_I; sqrt(w) r_Z; mask; 0],
which holds every precision-independent sum of the normal equations
(M00 = sum w J_I^T J_I, M01, M11, the four J^T r vectors, the 2x2 scale
numerator and n).  A second pass takes the new precision from those sums
and reduces sum log1p(r^T P_new r / dof) over the valid pixels.

Two implementations, one result:
  * ``fused_stats_plain`` — plain PyTorch, the CPU path and the kernel's
    oracle (the reference's ``fused_stats_xla``);
  * ``fused_stats_cuda`` — the hand-written CUDA kernel for Hopper
    (``csrc/fused_stats.cu``, replacing ``fused_stats_pallas``).
``fused_stats`` picks one by the tensors' device.

Inputs are channel-major [8, N]:
  refpack: i, z, idx, idy, x, y, sel, 0
  sampled: i_c, z_c, idx_c, idy_c, zdx_c, zdy_c, valid, z_t
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .camera import Intrinsics


class FusedPartials(NamedTuple):
    m00: torch.Tensor  # [6, 6]
    m01: torch.Tensor  # [6, 6]
    m11: torch.Tensor  # [6, 6]
    v: torch.Tensor  # [4, 6]  rows: v00, v01, v10, v11
    scale_sum: torch.Tensor  # [3]  (S_II, S_IZ, S_ZZ)
    num_valid: torch.Tensor  # []
    residuals: torch.Tensor  # [2, N] channel-major (r_I, r_Z rows)
    weights: torch.Tensor  # [N]


class FusedStats(NamedTuple):
    """Gram partials plus the log-likelihood sum; per-pixel residuals and
    weights never leave the kernel."""

    m00: torch.Tensor  # [6, 6]
    m01: torch.Tensor  # [6, 6]
    m11: torch.Tensor  # [6, 6]
    v: torch.Tensor  # [4, 6]
    scale_sum: torch.Tensor  # [3]
    num_valid: torch.Tensor  # []
    log_sum: torch.Tensor  # [] sum of log1p(r^T P_new r / dof) over valid pixels


def _pixel_math(ref, cur, precision, first_iter, fx, fy, dof):
    """The per-pixel chain: [8, N] channel packs -> residual pair, IRLS
    weight, mask and the 12 Jacobian components (each [N])."""
    i_r, z_r, idx_r, idy_r, x_r, y_r, sel = (
        ref[0], ref[1], ref[2], ref[3], ref[4], ref[5], ref[6],
    )
    i_c, z_c, idx_c, idy_c, zdx_c, zdy_c, validf, z_t = (
        cur[0], cur[1], cur[2], cur[3], cur[4], cur[5], cur[6], cur[7],
    )

    r_i = (i_c - i_r) * (1.0 / 255.0)
    r_z = z_c - z_t

    sigma = z_r - 0.4
    sigma = 0.0012 + 0.0019 * sigma * sigma
    not_occluded = r_z > -20.0 * sigma

    mask = (sel > 0.5) & (validf > 0.5) & not_occluded
    maskf = mask.to(r_i.dtype)
    r_i = r_i * maskf
    r_z = r_z * maskf

    # IRLS weight from the PREVIOUS precision; unit weights on the first
    # iteration
    p00, p01, p11 = precision[0], precision[1], precision[2]
    d2 = r_i * (p00 * r_i + p01 * r_z) + r_z * (p01 * r_i + p11 * r_z)
    # a true division, as the reference and the kernel round it: a Python
    # number over a tensor is reciprocal-then-multiply in torch, two roundings
    w_t = torch.full_like(d2, dof + 2.0) / (dof + d2)
    w = torch.where(first_iter > 0, maskf, w_t * maskf)

    # gradient channel weights: ESM blend for intensity, current-only depth
    g_ix = 0.5 * (idx_c + idx_r) * (fx / 255.0)
    g_iy = 0.5 * (idy_c + idy_r) * (fy / 255.0)
    g_zx = zdx_c * fx
    g_zy = zdy_c * fy

    z_safe = torch.where(z_r.abs() > 1e-12, z_r, torch.full_like(z_r, 1e-12))
    iz = 1.0 / z_safe
    iz2 = iz * iz
    x, y = x_r, y_r
    zero = torch.zeros_like(iz)

    # rows of the projection Jacobian Jw and the depth row Jz
    jw0 = (iz, zero, -x * iz2, -x * y * iz2, 1.0 + x * x * iz2, -y * iz)
    jw1 = (zero, iz, -y * iz2, -(1.0 + y * y * iz2), x * y * iz2, x * iz)
    jz = (0.0, 0.0, 1.0, y, -x, 0.0)

    j_i = [g_ix * a + g_iy * b for a, b in zip(jw0, jw1)]
    j_z = [g_zx * a + g_zy * b - c for a, b, c in zip(jw0, jw1, jz)]
    j_i = [c * maskf for c in j_i]
    j_z = [c * maskf for c in j_z]
    return r_i, r_z, w, maskf, j_i, j_z


def _gram_rows(r_i, r_z, w, maskf, j_i, j_z):
    """The 16 weighted rows U [16, N] whose Gram carries every reduction."""
    sw = torch.sqrt(w)
    rows = (
        [sw * c for c in j_i]
        + [sw * c for c in j_z]
        + [sw * r_i, sw * r_z, maskf, torch.zeros_like(maskf)]
    )
    return torch.stack(rows, dim=0)


def _unpack_gram(g):
    """Gram [16, 16] -> (m00, m01, m11, v, scale_sum, n).

    Rows 0-5 sqrt(w)J_I, 6-11 sqrt(w)J_Z, 12 sqrt(w)r_I, 13 sqrt(w)r_Z,
    14 mask, 15 zero."""
    m00 = g[0:6, 0:6]
    m01 = g[0:6, 6:12]
    m11 = g[6:12, 6:12]
    v = torch.stack([g[0:6, 12], g[0:6, 13], g[6:12, 12], g[6:12, 13]], dim=0)
    scale_sum = torch.stack([g[12, 12], g[12, 13], g[13, 13]])
    n = g[14, 14]
    return m00, m01, m11, v, scale_sum, n


# variance floors of robust.precision_from_scale: the precision inside the
# fused statistics MUST round exactly as the tracker's host-side one
_SIGMA_FLOOR_I = (0.05 / 255.0) ** 2
_SIGMA_FLOOR_Z = 1e-4**2


def _precision_from_scale_sums(s00, s01, s11, n):
    """(P00, P01, P11) from the raw scale sums — the same maths as
    robust.precision_from_scale(scale_matrix / max(n - 3, 1))."""
    denom = torch.clamp(n - 3.0, min=1.0)
    a = s00 / denom + _SIGMA_FLOOR_I
    b = s01 / denom
    c = s11 / denom + _SIGMA_FLOOR_Z
    det = torch.clamp(a * c - b * b, min=1e-30)
    return c / det, -b / det, a / det


def _check_tf32_off(t):
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the plain twin's Gram product must run in IEEE float32: set "
            "torch.backends.cuda.matmul.allow_tf32 = False"
        )


def fused_partials_plain(
    sampled,  # [8, N]
    refpack,  # [8, N]
    precision3,  # [3] (P00, P01, P11)
    first_iter,  # [] int32
    intrinsics: Intrinsics,
    dof: float = 5.0,
) -> FusedPartials:
    """Plain-PyTorch single pass: the Gram sums plus per-pixel residuals
    and weights (the reference's ``fused_partials_xla``)."""
    _check_tf32_off(sampled)
    r_i, r_z, w, maskf, j_i, j_z = _pixel_math(
        refpack, sampled, precision3, first_iter, intrinsics.fx, intrinsics.fy, dof
    )
    U = _gram_rows(r_i, r_z, w, maskf, j_i, j_z)  # [16, N]
    gram = U @ U.T
    m00, m01, m11, v, scale_sum, n = _unpack_gram(gram)
    return FusedPartials(
        m00=m00, m01=m01, m11=m11, v=v, scale_sum=scale_sum, num_valid=n,
        residuals=torch.stack([r_i, r_z]), weights=w,
    )


def fused_stats_plain(
    sampled, refpack, precision3, first_iter, intrinsics: Intrinsics, dof: float = 5.0
) -> FusedStats:
    """Plain-PyTorch twin of the CUDA kernel (the reference's
    ``fused_stats_xla``): the CPU path and the kernel's oracle."""
    parts = fused_partials_plain(sampled, refpack, precision3, first_iter, intrinsics, dof)
    p00, p01, p11 = _precision_from_scale_sums(
        parts.scale_sum[0], parts.scale_sum[1], parts.scale_sum[2], parts.num_valid
    )
    r_i, r_z = parts.residuals[0], parts.residuals[1]
    d2 = r_i * (p00 * r_i + p01 * r_z) + r_z * (p01 * r_i + p11 * r_z)
    log_terms = torch.where(
        parts.weights > 0, torch.log1p(d2 / dof), torch.zeros_like(d2)
    )
    return FusedStats(
        m00=parts.m00, m01=parts.m01, m11=parts.m11, v=parts.v,
        scale_sum=parts.scale_sum, num_valid=parts.num_valid,
        log_sum=torch.sum(log_terms),
    )


@functools.lru_cache(maxsize=None)
def _kernel_library():
    """The built fused-stats library with its C signature declared (built
    by nvcc at the first call in a process)."""
    from .. import _build

    lib = _build.load_library("fused_stats").lib
    ptr = ctypes.c_void_p
    lib.dvo_fused_stats.argtypes = [
        ptr, ptr, ptr, ctypes.c_int, ptr, ptr, ptr, ptr, ptr, ptr,
    ]
    lib.dvo_fused_stats.restype = ctypes.c_int
    for name in ("dvo_fused_stats_tile", "dvo_fused_stats_pairs"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    return lib


def _check_pack(name, t, n=None):
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError(f"fused_stats_cuda: {name} must be a CUDA tensor")
    if t.dtype != torch.float32:
        raise ValueError(f"fused_stats_cuda: {name} must be float32, got {t.dtype}")
    if t.dim() != 2 or t.shape[0] != 8 or (n is not None and t.shape[1] != n):
        raise ValueError(
            f"fused_stats_cuda: {name} must be [8, N] with one N, got {tuple(t.shape)}"
        )
    if not t.is_contiguous():
        raise ValueError(f"fused_stats_cuda: {name} must be contiguous")


def fused_stats_cuda(
    sampled, refpack, precision3, first_iter, intrinsics: Intrinsics, dof: float = 5.0
) -> FusedStats:
    """The CUDA kernel (``csrc/fused_stats.cu``): four launches on the
    current stream, no host synchronisation.  ``fused_stats_cuda.launches``
    counts the calls that launched it."""
    _check_pack("sampled", sampled)
    n = sampled.shape[1]
    _check_pack("refpack", refpack, n)
    device = sampled.device
    if refpack.device != device:
        raise ValueError("fused_stats_cuda: sampled and refpack on different devices")
    lib = _kernel_library()

    f32 = torch.float32
    params = torch.cat(
        [
            torch.tensor([intrinsics.fx, intrinsics.fy, dof], dtype=f32, device=device),
            torch.as_tensor(first_iter, device=device).to(f32).reshape(1),
            precision3.to(device=device, dtype=f32).reshape(3),
            torch.zeros(1, dtype=f32, device=device),
        ]
    )
    tile = lib.dvo_fused_stats_tile()
    blocks = -(-n // tile)
    gram_partials = torch.empty(
        (blocks, lib.dvo_fused_stats_pairs()), dtype=torch.float64, device=device
    )
    ll_partials = torch.empty(blocks, dtype=torch.float64, device=device)
    gram = torch.empty((16, 16), dtype=f32, device=device)
    prec = torch.empty(3, dtype=f32, device=device)
    log_sum = torch.empty(1, dtype=f32, device=device)
    err = lib.dvo_fused_stats(
        sampled.data_ptr(), refpack.data_ptr(), params.data_ptr(), n,
        gram_partials.data_ptr(), gram.data_ptr(), prec.data_ptr(),
        ll_partials.data_ptr(), log_sum.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_stats_cuda: kernel launch failed, CUDA error {err}")
    fused_stats_cuda.launches += 1
    m00, m01, m11, v, scale_sum, num_valid = _unpack_gram(gram)
    return FusedStats(
        m00=m00, m01=m01, m11=m11, v=v, scale_sum=scale_sum,
        num_valid=num_valid, log_sum=log_sum[0],
    )


fused_stats_cuda.launches = 0


def fused_stats(
    sampled, refpack, precision3, first_iter, intrinsics: Intrinsics, dof: float = 5.0
) -> FusedStats:
    """Dispatch on the tensors' device: CPU tensors take the plain twin,
    CUDA tensors the kernel; any other device raises."""
    kind = sampled.device.type
    if kind == "cpu":
        return fused_stats_plain(sampled, refpack, precision3, first_iter, intrinsics, dof)
    if kind == "cuda":
        return fused_stats_cuda(sampled, refpack, precision3, first_iter, intrinsics, dof)
    raise ValueError(f"fused_stats: no implementation for device {sampled.device}")


def assemble_normal_equations(partials, precision):
    """A, b for a 2x2 precision from the Gram partials:
    A = sum w J^T P J, b = -sum w J^T P r."""
    p00, p01, p11 = precision[0, 0], precision[0, 1], precision[1, 1]
    A = p00 * partials.m00 + p01 * (partials.m01 + partials.m01.T) + p11 * partials.m11
    A = 0.5 * (A + A.T)
    b = -(
        p00 * partials.v[0]
        + p01 * (partials.v[1] + partials.v[2])
        + p11 * partials.v[3]
    )
    return A, b


def scale_matrix(partials):
    """The weighted 2x2 scale numerator sum w r r^T as a matrix (divide by
    n - 3 outside)."""
    s = partials.scale_sum
    return torch.stack([torch.stack([s[0], s[1]]), torch.stack([s[1], s[2]])])
