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

The single-pass form, ``fused_partials``, stops after the Gram and hands
back the per-pixel residuals and weights instead, for a caller that
reduces the Gram over several ranks before it can take the precision (the
pixel-sharded alignment).

Two implementations of each, one result:
  * ``fused_stats_plain`` / ``fused_partials_plain`` — plain PyTorch, the
    CPU path and the kernels' oracle (the reference's ``fused_stats_xla`` /
    ``fused_partials_xla``);
  * ``fused_stats_cuda`` / ``fused_partials_cuda`` — the hand-written CUDA
    kernels for Hopper (``csrc/fused_stats.cu``, replacing
    ``fused_stats_pallas`` / ``fused_partials_pallas``), and
    ``fused_stats_batched_cuda``, B streams' statistics in one call (the
    lockstep multi-stream tracker, where the reference vmaps
    ``fused_stats_pallas``).
``fused_stats`` / ``fused_partials`` pick one by the tensors' device (and
``fused_stats`` the batched entry point for [B, 8, N] packs).  The plain
versions take a leading stream axis as they are.

Inputs are channel-major [8, N] (or [B, 8, N]):
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
    """The per-pixel chain: [..., 8, N] channel packs -> residual pair, IRLS
    weight, mask and the 12 Jacobian components (each [..., N]).
    ``precision`` is [..., 3] and ``first_iter`` [] or [...]: one per
    stream when the packs carry a leading stream axis."""
    i_r, z_r, idx_r, idy_r, x_r, y_r, sel = (ref[..., c, :] for c in range(7))
    i_c, z_c, idx_c, idy_c, zdx_c, zdy_c, validf, z_t = (cur[..., c, :] for c in range(8))

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
    p00, p01, p11 = (precision[..., k, None] for k in range(3))
    d2 = r_i * (p00 * r_i + p01 * r_z) + r_z * (p01 * r_i + p11 * r_z)
    # a true division, as the reference and the kernel round it: a Python
    # number over a tensor is reciprocal-then-multiply in torch, two roundings
    w_t = torch.full_like(d2, dof + 2.0) / (dof + d2)
    first = torch.as_tensor(first_iter, device=d2.device)
    first = first.reshape(first.shape + (1,) * (d2.dim() - first.dim()))
    w = torch.where(first > 0, maskf, w_t * maskf)

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
    """The 16 weighted rows U [..., 16, N] whose Gram carries every reduction."""
    sw = torch.sqrt(w)
    rows = (
        [sw * c for c in j_i]
        + [sw * c for c in j_z]
        + [sw * r_i, sw * r_z, maskf, torch.zeros_like(maskf)]
    )
    return torch.stack(rows, dim=-2)


def _unpack_gram(g):
    """Gram [..., 16, 16] -> (m00, m01, m11, v, scale_sum, n).

    Rows 0-5 sqrt(w)J_I, 6-11 sqrt(w)J_Z, 12 sqrt(w)r_I, 13 sqrt(w)r_Z,
    14 mask, 15 zero."""
    m00 = g[..., 0:6, 0:6]
    m01 = g[..., 0:6, 6:12]
    m11 = g[..., 6:12, 6:12]
    v = torch.stack(
        [g[..., 0:6, 12], g[..., 0:6, 13], g[..., 6:12, 12], g[..., 6:12, 13]], dim=-2
    )
    scale_sum = torch.stack([g[..., 12, 12], g[..., 12, 13], g[..., 13, 13]], dim=-1)
    n = g[..., 14, 14]
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
    sampled,  # [..., 8, N]
    refpack,  # [..., 8, N]
    precision3,  # [..., 3] (P00, P01, P11)
    first_iter,  # [] or [...] int32
    intrinsics: Intrinsics,
    dof: float = 5.0,
) -> FusedPartials:
    """Plain-PyTorch single pass: the Gram sums plus per-pixel residuals
    and weights (the reference's ``fused_partials_xla``).  With a leading
    stream axis the Gram is one batched product [B, 16, N] @ [B, N, 16]."""
    _check_tf32_off(sampled)
    r_i, r_z, w, maskf, j_i, j_z = _pixel_math(
        refpack, sampled, precision3, first_iter, intrinsics.fx, intrinsics.fy, dof
    )
    U = _gram_rows(r_i, r_z, w, maskf, j_i, j_z)  # [..., 16, N]
    gram = U @ U.transpose(-1, -2)
    m00, m01, m11, v, scale_sum, n = _unpack_gram(gram)
    return FusedPartials(
        m00=m00, m01=m01, m11=m11, v=v, scale_sum=scale_sum, num_valid=n,
        residuals=torch.stack([r_i, r_z], dim=-2), weights=w,
    )


def fused_stats_plain(
    sampled, refpack, precision3, first_iter, intrinsics: Intrinsics, dof: float = 5.0
) -> FusedStats:
    """Plain-PyTorch twin of the CUDA kernels (the reference's
    ``fused_stats_xla``): the CPU path and the kernels' oracle.  Packs
    [8, N] give one stream's statistics; [B, 8, N] with per-stream
    ``precision3`` [B, 3] give every field with a leading [B]."""
    parts = fused_partials_plain(sampled, refpack, precision3, first_iter, intrinsics, dof)
    p00, p01, p11 = (
        p.unsqueeze(-1)
        for p in _precision_from_scale_sums(
            parts.scale_sum[..., 0], parts.scale_sum[..., 1], parts.scale_sum[..., 2],
            parts.num_valid,
        )
    )
    r_i, r_z = parts.residuals[..., 0, :], parts.residuals[..., 1, :]
    d2 = r_i * (p00 * r_i + p01 * r_z) + r_z * (p01 * r_i + p11 * r_z)
    log_terms = torch.where(
        parts.weights > 0, torch.log1p(d2 / dof), torch.zeros_like(d2)
    )
    return FusedStats(
        m00=parts.m00, m01=parts.m01, m11=parts.m11, v=parts.v,
        scale_sum=parts.scale_sum, num_valid=parts.num_valid,
        log_sum=torch.sum(log_terms, dim=-1),
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
    lib.dvo_fused_stats_batched.argtypes = [
        ptr, ptr, ptr, ctypes.c_int, ctypes.c_int, ptr, ptr, ptr, ptr, ptr, ptr,
    ]
    lib.dvo_fused_stats_batched.restype = ctypes.c_int
    lib.dvo_fused_partials.argtypes = [ptr, ptr, ptr, ctypes.c_int, ptr, ptr, ptr, ptr]
    lib.dvo_fused_partials.restype = ctypes.c_int
    for name in ("dvo_fused_stats_tile", "dvo_fused_stats_pairs"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    return lib


def _check_packs(who, sampled, refpack, batched=False):
    """The kernels take two float32, contiguous CUDA packs of one shape on
    one device: [8, N], or [B, 8, N] for the batched entry point; raise on
    anything else."""
    want = "[B, 8, N]" if batched else "[8, N]"
    for name, t in (("sampled", sampled), ("refpack", refpack)):
        if not isinstance(t, torch.Tensor) or not t.is_cuda:
            raise ValueError(f"{who}: {name} must be a CUDA tensor")
        if t.dtype != torch.float32:
            raise ValueError(f"{who}: {name} must be float32, got {t.dtype}")
        if (
            t.dim() != (3 if batched else 2)
            or t.shape[-2] != 8
            or t.shape != sampled.shape
        ):
            raise ValueError(f"{who}: {name} must be {want} with one shape, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous")
    if refpack.device != sampled.device:
        raise ValueError(f"{who}: sampled and refpack on different devices")


def _kernel_params(intrinsics: Intrinsics, dof, first_iter, precision3, device):
    """The kernels' params [..., 8] = (fx, fy, dof, first, P00, P01, P11, 0),
    one row per stream for ``precision3`` [..., 3], built on the device with
    torch ops: launching reads no value back.  ``first_iter`` is one flag
    for every stream or one per stream."""
    f32 = torch.float32
    precision3 = precision3.to(device=device, dtype=f32)
    batch = precision3.shape[:-1]
    first = torch.as_tensor(first_iter, device=device).to(f32)
    return torch.cat(
        [
            torch.tensor([intrinsics.fx, intrinsics.fy, dof], dtype=f32, device=device)
            .expand(batch + (3,)),
            first.expand(batch).unsqueeze(-1),
            precision3,
            torch.zeros(batch + (1,), dtype=f32, device=device),
        ],
        dim=-1,
    )


def _gram_partials_scratch(lib, n, device, batch=()):
    """The kernels' per-block float64 Gram partials [..., ceil(n / tile), 136]."""
    blocks = -(-n // lib.dvo_fused_stats_tile())
    return torch.empty(
        tuple(batch) + (blocks, lib.dvo_fused_stats_pairs()), dtype=torch.float64, device=device
    )


def _launch_fused_stats(sampled, refpack, precision3, first_iter, intrinsics, dof, batch):
    """Allocate the outputs and scratch and launch one call: ``batch`` ()
    runs ``dvo_fused_stats`` on [8, N] packs, (B,) ``dvo_fused_stats_batched``
    on [B, 8, N].  Every field of the result has the leading ``batch``."""
    n = sampled.shape[-1]
    device = sampled.device
    lib = _kernel_library()
    f32 = torch.float32
    params = _kernel_params(intrinsics, dof, first_iter, precision3, device).contiguous()
    gram_partials = _gram_partials_scratch(lib, n, device, batch)
    ll_partials = torch.empty(gram_partials.shape[:-1], dtype=torch.float64, device=device)
    gram = torch.empty(batch + (16, 16), dtype=f32, device=device)
    prec = torch.empty(batch + (3,), dtype=f32, device=device)
    log_sum = torch.empty(batch or (1,), dtype=f32, device=device)
    head = (sampled.data_ptr(), refpack.data_ptr(), params.data_ptr(), n)
    tail = (gram_partials.data_ptr(), gram.data_ptr(), prec.data_ptr(), ll_partials.data_ptr(),
            log_sum.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    if batch:
        err = lib.dvo_fused_stats_batched(*head, batch[0], *tail)
    else:
        err = lib.dvo_fused_stats(*head, *tail)
    if err != 0:
        raise RuntimeError(f"fused_stats kernel launch failed, CUDA error {err}")
    m00, m01, m11, v, scale_sum, num_valid = _unpack_gram(gram)
    return FusedStats(
        m00=m00, m01=m01, m11=m11, v=v, scale_sum=scale_sum,
        num_valid=num_valid, log_sum=log_sum if batch else log_sum[0],
    )


def fused_stats_cuda(
    sampled, refpack, precision3, first_iter, intrinsics: Intrinsics, dof: float = 5.0
) -> FusedStats:
    """The CUDA kernel (``csrc/fused_stats.cu``, ``dvo_fused_stats``): four
    launches on the current stream, no host synchronisation.
    ``fused_stats_cuda.launches`` counts the calls that launched it."""
    _check_packs("fused_stats_cuda", sampled, refpack)
    stats = _launch_fused_stats(sampled, refpack, precision3, first_iter, intrinsics, dof, ())
    fused_stats_cuda.launches += 1
    return stats


fused_stats_cuda.launches = 0


def fused_stats_batched_cuda(
    sampled, refpack, precision3, first_iter, intrinsics: Intrinsics, dof: float = 5.0
) -> FusedStats:
    """The batched CUDA entry point (``csrc/fused_stats.cu``,
    ``dvo_fused_stats_batched``): B streams' statistics in four launches on
    the current stream, no host synchronisation.  ``sampled``/``refpack``
    [B, 8, N], ``precision3`` [B, 3], ``first_iter`` [] or [B]; every field
    of the result has a leading [B], stream b's bit-equal to
    ``fused_stats_cuda`` on stream b's packs.  Each call adds one to
    ``fused_stats_batched_cuda.launches``."""
    _check_packs("fused_stats_batched_cuda", sampled, refpack, batched=True)
    batch = sampled.shape[0]
    if tuple(precision3.shape) != (batch, 3):
        raise ValueError(
            f"fused_stats_batched_cuda: precision3 must be [{batch}, 3], got {tuple(precision3.shape)}"
        )
    stats = _launch_fused_stats(sampled, refpack, precision3, first_iter, intrinsics, dof, (batch,))
    fused_stats_batched_cuda.launches += 1
    return stats


fused_stats_batched_cuda.launches = 0


def fused_stats(
    sampled, refpack, precision3, first_iter, intrinsics: Intrinsics, dof: float = 5.0
) -> FusedStats:
    """Dispatch on the tensors' device: CPU tensors take the plain twin,
    CUDA tensors the kernel (the batched entry point for [B, 8, N] packs);
    any other device raises."""
    kind = sampled.device.type
    if kind == "cpu":
        return fused_stats_plain(sampled, refpack, precision3, first_iter, intrinsics, dof)
    if kind == "cuda":
        kernel = fused_stats_batched_cuda if sampled.dim() == 3 else fused_stats_cuda
        return kernel(sampled, refpack, precision3, first_iter, intrinsics, dof)
    raise ValueError(f"fused_stats: no implementation for device {sampled.device}")


def fused_partials_rows_cuda(
    sampled, refpack, precision3, first_iter, intrinsics: Intrinsics, dof: float = 5.0
):
    """The CUDA single-pass kernel (``csrc/fused_stats.cu``,
    ``dvo_fused_partials``): two launches on the current stream, no host
    synchronisation.  Returns the Gram [16, 16] and the per-pixel rows
    rw [4, N] = (r_I, r_Z, w, mask).  Each call adds one to
    ``fused_partials_cuda.launches``."""
    _check_packs("fused_partials_cuda", sampled, refpack)
    n = sampled.shape[1]
    device = sampled.device
    lib = _kernel_library()
    params = _kernel_params(intrinsics, dof, first_iter, precision3, device)
    gram_partials = _gram_partials_scratch(lib, n, device)
    gram = torch.empty((16, 16), dtype=torch.float32, device=device)
    rw = torch.empty((4, n), dtype=torch.float32, device=device)
    err = lib.dvo_fused_partials(
        sampled.data_ptr(), refpack.data_ptr(), params.data_ptr(), n,
        gram_partials.data_ptr(), gram.data_ptr(), rw.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_partials_cuda: kernel launch failed, CUDA error {err}")
    fused_partials_cuda.launches += 1
    return gram, rw


def fused_partials_cuda(
    sampled, refpack, precision3, first_iter, intrinsics: Intrinsics, dof: float = 5.0
) -> FusedPartials:
    """The CUDA single-pass kernel as ``FusedPartials``: ``residuals`` and
    ``weights`` are views of the kernel's rw rows.
    ``fused_partials_cuda.launches`` counts the calls that launched it."""
    return partials_from_rows(
        *fused_partials_rows_cuda(sampled, refpack, precision3, first_iter, intrinsics, dof)
    )


def partials_from_rows(gram, rw) -> FusedPartials:
    """The kernel's Gram [16, 16] and rows rw [4, N] as ``FusedPartials``
    (residuals and weights are views of rw)."""
    m00, m01, m11, v, scale_sum, num_valid = _unpack_gram(gram)
    return FusedPartials(
        m00=m00, m01=m01, m11=m11, v=v, scale_sum=scale_sum, num_valid=num_valid,
        residuals=rw[:2], weights=rw[2],
    )


fused_partials_cuda.launches = 0


def fused_partials(
    sampled, refpack, precision3, first_iter, intrinsics: Intrinsics, dof: float = 5.0
) -> FusedPartials:
    """Dispatch on the tensors' device: CPU tensors take the plain twin,
    CUDA tensors the kernel; any other device raises."""
    kind = sampled.device.type
    if kind == "cpu":
        return fused_partials_plain(sampled, refpack, precision3, first_iter, intrinsics, dof)
    if kind == "cuda":
        return fused_partials_cuda(sampled, refpack, precision3, first_iter, intrinsics, dof)
    raise ValueError(f"fused_partials: no implementation for device {sampled.device}")


def assemble_normal_equations(partials, precision):
    """A, b for a 2x2 precision [..., 2, 2] from the Gram partials:
    A = sum w J^T P J, b = -sum w J^T P r."""
    p00, p01, p11 = (precision[..., i, j, None] for i, j in ((0, 0), (0, 1), (1, 1)))
    m01 = partials.m01
    A = (
        p00[..., None] * partials.m00
        + p01[..., None] * (m01 + m01.transpose(-1, -2))
        + p11[..., None] * partials.m11
    )
    A = 0.5 * (A + A.transpose(-1, -2))
    v = partials.v
    b = -(p00 * v[..., 0, :] + p01 * (v[..., 1, :] + v[..., 2, :]) + p11 * v[..., 3, :])
    return A, b


def scale_matrix(partials):
    """The weighted 2x2 scale numerator sum w r r^T as a matrix [..., 2, 2]
    (divide by n - 3 outside)."""
    s = partials.scale_sum
    return torch.stack(
        [
            torch.stack([s[..., 0], s[..., 1]], dim=-1),
            torch.stack([s[..., 1], s[..., 2]], dim=-1),
        ],
        dim=-2,
    )
