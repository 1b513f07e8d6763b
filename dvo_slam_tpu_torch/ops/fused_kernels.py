"""Fused IRLS statistics of the dense-tracking inner loop (counterpart of
``dvo_slam_tpu.ops.pallas_kernels`` and of the reference tracker's
``evaluate_fused``).

One pass over the pixels of a level computes, per pixel, the residual
pair, the t-distribution weight from the previous precision and the 12
Jacobian entries, and reduces them into the 16x16 Gram matrix of
  U = [sqrt(w) J_I (6); sqrt(w) J_Z (6); sqrt(w) r_I; sqrt(w) r_Z; mask; 0],
which holds every precision-independent sum of the normal equations
(M00 = sum w J_I^T J_I, M01, M11, the four J^T r vectors, the 2x2 scale
numerator and n).  A second pass takes the new precision from those sums
and reduces sum log1p(r^T P_new r / dof) over the valid pixels.

Three forms of it:
  * ``warp_fused_stats``: one whole IRLS evaluation of the tracker, from
    the warp T on: warp and depth-buffered sample of the current frame's
    quad table, the statistics, and the iteration's tail (new precision,
    log-likelihood, normal equations, constraint count) ->
    ``WarpFusedStats``;
  * ``fused_stats_*``: the statistics from an already sampled pack;
  * ``fused_partials``: the Gram plus the per-pixel residuals and weights,
    for a caller that reduces the Gram over several ranks before it can
    take the precision (the pixel-sharded alignment).

Two implementations of each, one result:
  * ``warp_fused_stats_plain`` / ``fused_stats_plain`` /
    ``fused_partials_plain`` — plain PyTorch, the CPU path and the
    kernels' oracle (the reference's ``warp_and_sample_cm`` +
    ``fused_stats_xla`` + tail, ``fused_stats_xla``, ``fused_partials_xla``);
  * the hand-written CUDA kernels for Hopper in ``csrc/fused_stats.cu``
    (replacing ``fused_stats_pallas`` / ``fused_partials_pallas``):
    ``warp_fused_stats_cuda`` and ``warp_fused_stats_batched_cuda`` (B
    streams in lockstep in one call, where the reference vmaps the
    kernel), ``fused_stats_cuda`` / ``fused_stats_batched_cuda`` (the same
    two launches loading a sampled pack) and ``fused_partials_cuda``.
``warp_fused_stats`` and ``fused_partials`` pick one by the tensors'
device; the sampled-input kernels are called directly (phases 3 and 7 of
``chip_smoke.py`` hold them to ``fused_stats_plain``).  The plain
versions take a leading stream axis as they are.

Inputs are channel-major [8, N] (or [B, 8, N]):
  refpack: i, z, idx, idy, x, y, sel, 0
  sampled: i_c, z_c, idx_c, idy_c, zdx_c, zdy_c, valid, z_t
and the quad table [32, N] (or [B, 32, N]) of ``ops.interp``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _build
from . import robust
from .camera import Intrinsics
from .residuals import warp_and_sample_cm


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


class WarpFusedStats(NamedTuple):
    """One IRLS evaluation (what the tracker's ``evaluate`` returns); every
    field has a leading [B] for B streams."""

    n: torch.Tensor  # [] int32 valid constraints
    precision: torch.Tensor  # [2, 2] the new precision
    ll: torch.Tensor  # [] log-likelihood
    A: torch.Tensor  # [6, 6] normal-equation matrix
    b: torch.Tensor  # [6] normal-equation right-hand side


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


def warp_fused_stats_plain(
    refpack,  # [..., 8, N]
    quad,  # [..., 32, N] the current frame's quad table
    shape,  # (H, W) of the level
    intrinsics: Intrinsics,
    T,  # [..., 4, 4]
    P_prev,  # [..., 2, 2]
    first: bool,
    dof: float = 5.0,
    depth_buffered: bool = True,
) -> WarpFusedStats:
    """One IRLS evaluation in plain PyTorch: the CPU path and the folded
    kernel's oracle.  The warp and sample (``warp_and_sample_cm``), the
    fused statistics (``fused_stats_plain``) and the tail of the
    reference's ``evaluate_fused``: the new precision from the scale sums,
    the log-likelihood, the normal equations and the constraint count."""
    sampled = warp_and_sample_cm(
        refpack, quad, shape, intrinsics, T, depth_buffered=depth_buffered
    )
    p3 = torch.stack([P_prev[..., 0, 0], P_prev[..., 0, 1], P_prev[..., 1, 1]], dim=-1)
    first_flag = torch.tensor(int(bool(first)), dtype=torch.int32, device=refpack.device)
    stats = fused_stats_plain(sampled, refpack, p3, first_flag, intrinsics, dof)
    n = stats.num_valid.to(torch.int32)
    denom = torch.clamp(stats.num_valid - 3.0, min=1.0)
    precision_new = robust.precision_from_scale(scale_matrix(stats) / denom[..., None, None])
    det = (
        precision_new[..., 0, 0] * precision_new[..., 1, 1]
        - precision_new[..., 0, 1] * precision_new[..., 1, 0]
    )
    logdet = torch.log(torch.clamp(det, min=1e-38))
    ll = 0.5 * stats.num_valid * logdet - 0.5 * (dof + 2.0) * stats.log_sum
    A, b = assemble_normal_equations(stats, precision_new)
    return WarpFusedStats(n=n, precision=precision_new, ll=ll, A=A, b=b)


# The packed output of one stream (csrc/fused_stats.cu), in float32 words:
# the Gram [16, 16], the new precision [2, 2], A [6, 6], b [6], ll, the
# log-likelihood sum, and n as int32 bits.
OUT_STRIDE = 320
_OUT_GRAM, _OUT_PREC, _OUT_A, _OUT_B, _OUT_LL, _OUT_LOG_SUM, _OUT_N = 0, 256, 260, 296, 302, 303, 304
_LAYOUT = (OUT_STRIDE, _OUT_GRAM, _OUT_PREC, _OUT_A, _OUT_B, _OUT_LL, _OUT_LOG_SUM, _OUT_N)
_STASH_ROWS = 3  # (r_I, r_Z, mask) per pixel, between the two launches


@functools.lru_cache(maxsize=None)
def _kernel_library():
    """The built fused-stats library with its C signatures declared (built
    by nvcc at the first call in a process); raises if its packed-output
    layout is not this module's."""
    lib = _build.load_library("fused_stats").lib
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    signatures = {
        "dvo_warp_fused_stats": [p] * 4 + [i] * 6 + [f] * 9 + [p] * 4,
        "dvo_fused_stats_batched": [p] * 4 + [i] * 2 + [f] * 7 + [p] * 4,
        "dvo_fused_stats": [p] * 4 + [i] + [f] * 7 + [p] * 4,
        "dvo_fused_partials": [p] * 4 + [i] + [f] * 6 + [p] * 5,
    }
    for name, argtypes in signatures.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    lib.dvo_fused_stats_workspace_bytes.argtypes = [i, i, i]
    lib.dvo_fused_stats_workspace_bytes.restype = ctypes.c_longlong
    lib.dvo_fused_stats_layout.argtypes = [p]
    lib.dvo_fused_stats_layout.restype = None
    fields = (ctypes.c_int * len(_LAYOUT))()
    lib.dvo_fused_stats_layout(fields)
    if tuple(fields) != _LAYOUT:
        raise RuntimeError(f"fused_stats library layout {tuple(fields)} != {_LAYOUT}")
    return lib


_tickets = {}


def _ticket_buffer(device, stream, batch):
    """The kernels' per-stream tickets (int32, zero between launches; each
    launch's last block resets its own): one buffer per device and CUDA
    stream, allocated once and grown for a call with more streams."""
    key = (device.index, stream)
    buf = _tickets.get(key)
    if buf is None or buf.numel() < batch:
        buf = torch.zeros(max(batch, 64), dtype=torch.int32, device=device)
        _tickets[key] = buf
    return buf


def _scalars(intrinsics: Intrinsics, dof):
    """(fx, fy, fx / 255, fy / 255, dof, dof + 2, (dof + 2) / 2): the
    Python numbers the plain version computes with, which ctypes rounds to
    float32 as PyTorch rounds a scalar operand."""
    return (intrinsics.fx, intrinsics.fy, intrinsics.fx / 255.0, intrinsics.fy / 255.0,
            dof, dof + 2.0, 0.5 * (dof + 2.0))


def _check_cuda(who, name, t, shape):
    """``t`` must be a float32, contiguous CUDA tensor of ``shape``."""
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError(f"{who}: {name} must be a CUDA tensor")
    if t.dtype != torch.float32:
        raise ValueError(f"{who}: {name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{who}: {name} must be {list(shape)}, got {list(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{who}: {name} must be contiguous")


def _check_packs(who, sampled, refpack, batched=False):
    """The sampled-input kernels take two float32, contiguous CUDA packs of
    one shape on one device: [8, N], or [B, 8, N] for the batched entry
    point; raise on anything else."""
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


def _workspace(lib, n, batch, rows, device):
    return torch.empty(
        lib.dvo_fused_stats_workspace_bytes(n, batch, rows), dtype=torch.uint8, device=device
    )


def _stash(workspace, batch, n):
    """The stash (r_I, r_Z, mask) [..., 3, N] at the head of a workspace."""
    count = _STASH_ROWS * n * (batch[0] if batch else 1)
    return workspace[: 4 * count].view(torch.float32).view(tuple(batch) + (_STASH_ROWS, n))


def _unpack_out(out) -> WarpFusedStats:
    """Views of the packed output [..., 320] as ``WarpFusedStats``."""
    batch = tuple(out.shape[:-1])
    return WarpFusedStats(
        n=out.view(torch.int32)[..., _OUT_N],
        precision=out[..., _OUT_PREC:_OUT_PREC + 4].view(batch + (2, 2)),
        ll=out[..., _OUT_LL],
        A=out[..., _OUT_A:_OUT_A + 36].view(batch + (6, 6)),
        b=out[..., _OUT_B:_OUT_B + 6],
    )


def packed_stats(out) -> FusedStats:
    """The Gram blocks and the log-likelihood sum of a kernel's packed
    output [..., 320] as ``FusedStats``."""
    gram = out[..., _OUT_GRAM:_OUT_GRAM + 256].view(tuple(out.shape[:-1]) + (16, 16))
    m00, m01, m11, v, scale_sum, num_valid = _unpack_gram(gram)
    return FusedStats(m00=m00, m01=m01, m11=m11, v=v, scale_sum=scale_sum,
                      num_valid=num_valid, log_sum=out[..., _OUT_LOG_SUM])


def _launch_warp(who, refpack, quad, shape, intrinsics, T, P_prev, first, dof, depth_buffered):
    """Check the inputs and launch ``dvo_warp_fused_stats`` once -> (the
    packed output [..., 320], the workspace whose head is the stash)."""
    batch = tuple(refpack.shape[:-2])
    n = refpack.shape[-1]
    height, width = shape
    if height * width != n:
        raise ValueError(f"{who}: level shape {tuple(shape)} does not hold N = {n} pixels")
    T = T.contiguous() if isinstance(T, torch.Tensor) else T
    P_prev = P_prev.contiguous() if isinstance(P_prev, torch.Tensor) else P_prev
    _check_cuda(who, "refpack", refpack, batch + (8, n))
    _check_cuda(who, "quad", quad, batch + (32, n))
    _check_cuda(who, "T", T, batch + (4, 4))
    _check_cuda(who, "P_prev", P_prev, batch + (2, 2))
    device = refpack.device
    if any(t.device != device for t in (quad, T, P_prev)):
        raise ValueError(f"{who}: inputs on different devices")
    lib = _kernel_library()
    streams = batch[0] if batch else 1
    stream = _build.current_stream(device)
    workspace = _workspace(lib, n, streams, _STASH_ROWS, device)
    out = torch.empty(batch + (OUT_STRIDE,), dtype=torch.float32, device=device)
    fx, fy, gx, gy, dof_, dof_plus_2, ll_scale = _scalars(intrinsics, dof)
    err = lib.dvo_warp_fused_stats(
        refpack.data_ptr(), quad.data_ptr(), T.data_ptr(), P_prev.data_ptr(),
        n, height, width, streams, int(bool(first)), int(bool(depth_buffered)),
        fx, fy, intrinsics.ox, intrinsics.oy, gx, gy, dof_, dof_plus_2, ll_scale,
        workspace.data_ptr(), _ticket_buffer(device, stream, streams).data_ptr(),
        out.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"{who}: kernel launch failed, CUDA error {err}")
    (warp_fused_stats_batched_cuda if batch else warp_fused_stats_cuda).launches += 1
    return out, workspace


def _require_dim(who, refpack, dims):
    if not isinstance(refpack, torch.Tensor) or refpack.dim() not in dims:
        shapes = " or ".join(("[8, N]", "[B, 8, N]")[d - 2] for d in dims)
        raise ValueError(f"{who}: refpack must be a {shapes} CUDA tensor")


def warp_fused_stats_rows_cuda(
    refpack, quad, shape, intrinsics: Intrinsics, T, P_prev, first: bool, dof: float = 5.0,
    depth_buffered: bool = True,
):
    """The folded kernel (``csrc/fused_stats.cu``, ``dvo_warp_fused_stats``)
    with everything it computes, for the checks: two launches on the
    current stream, no host synchronisation, nothing read from the host.
    ``refpack`` [8, N] / [B, 8, N], ``quad`` [32, N] / [B, 32, N], ``T``
    [..., 4, 4], ``P_prev`` [..., 2, 2], float32 CUDA tensors.  Returns
    (``WarpFusedStats``, the Gram blocks and log sum as ``FusedStats``, the
    stash (r_I, r_Z, mask) [..., 3, N]), all views of the call's own
    buffers.  Each call adds one to ``warp_fused_stats_batched_cuda.launches``
    for [B, ...] inputs, else to ``warp_fused_stats_cuda.launches``."""
    who = "warp_fused_stats_rows_cuda"
    _require_dim(who, refpack, (2, 3))
    out, workspace = _launch_warp(
        who, refpack, quad, shape, intrinsics, T, P_prev, first, dof, depth_buffered
    )
    stash = _stash(workspace, tuple(refpack.shape[:-2]), refpack.shape[-1])
    return _unpack_out(out), packed_stats(out), stash


def warp_fused_stats_cuda(
    refpack, quad, shape, intrinsics: Intrinsics, T, P_prev, first: bool, dof: float = 5.0,
    depth_buffered: bool = True,
) -> WarpFusedStats:
    """One stream's IRLS evaluation by the folded kernel (the tracker's
    call): ``refpack`` [8, N], ``quad`` [32, N], ``T`` [4, 4], ``P_prev``
    [2, 2] CUDA tensors.  Each call adds one to
    ``warp_fused_stats_cuda.launches``."""
    who = "warp_fused_stats_cuda"
    _require_dim(who, refpack, (2,))
    return _unpack_out(_launch_warp(
        who, refpack, quad, shape, intrinsics, T, P_prev, first, dof, depth_buffered
    )[0])


warp_fused_stats_cuda.launches = 0


def warp_fused_stats_batched_cuda(
    refpack, quad, shape, intrinsics: Intrinsics, T, P_prev, first: bool, dof: float = 5.0,
    depth_buffered: bool = True,
) -> WarpFusedStats:
    """B streams' IRLS evaluations by the folded kernel in one call of two
    launches: ``refpack`` [B, 8, N], ``quad`` [B, 32, N], ``T`` [B, 4, 4],
    ``P_prev`` [B, 2, 2]; stream b's outputs bit-equal to
    ``warp_fused_stats_cuda`` on its inputs.  Each call adds one to
    ``warp_fused_stats_batched_cuda.launches``."""
    who = "warp_fused_stats_batched_cuda"
    _require_dim(who, refpack, (3,))
    return _unpack_out(_launch_warp(
        who, refpack, quad, shape, intrinsics, T, P_prev, first, dof, depth_buffered
    )[0])


warp_fused_stats_batched_cuda.launches = 0


def warp_fused_stats(
    refpack, quad, shape, intrinsics: Intrinsics, T, P_prev, first: bool, dof: float = 5.0,
    depth_buffered: bool = True,
) -> WarpFusedStats:
    """One IRLS evaluation of the tracker, dispatched on the tensors'
    device: CPU tensors take the plain version, CUDA tensors the folded
    kernel (the batched entry point for [B, 8, N] refpacks); any other
    device raises."""
    kind = refpack.device.type
    args = (refpack, quad, shape, intrinsics, T, P_prev, first, dof, depth_buffered)
    if kind == "cpu":
        return warp_fused_stats_plain(*args)
    if kind == "cuda":
        kernel = warp_fused_stats_batched_cuda if refpack.dim() == 3 else warp_fused_stats_cuda
        return kernel(*args)
    raise ValueError(f"warp_fused_stats: no implementation for device {refpack.device}")


def _sampled_inputs(who, sampled, refpack, precision3, first_iter, batched):
    """(batch, precision3 [B, 3], first flags [B] int32) on the packs'
    device, for the sampled-input entry points."""
    _check_packs(who, sampled, refpack, batched)
    batch = tuple(sampled.shape[:-2])
    if tuple(precision3.shape) != batch + (3,):
        raise ValueError(f"{who}: precision3 must be {list(batch + (3,))}, got {list(precision3.shape)}")
    device = sampled.device
    p3 = precision3.to(device=device, dtype=torch.float32).contiguous()
    flags = torch.as_tensor(first_iter, device=device).to(torch.int32).expand(batch or (1,))
    return batch, p3, flags.contiguous()


def _launch_fused_stats(who, sampled, refpack, precision3, first_iter, intrinsics, dof, batched):
    """One call of ``dvo_fused_stats`` ([8, N] packs) or
    ``dvo_fused_stats_batched`` ([B, 8, N]) -> ``FusedStats`` with the
    leading batch, views of the call's packed output."""
    batch, p3, flags = _sampled_inputs(who, sampled, refpack, precision3, first_iter, batched)
    n = sampled.shape[-1]
    device = sampled.device
    lib = _kernel_library()
    streams = batch[0] if batch else 1
    stream = _build.current_stream(device)
    workspace = _workspace(lib, n, streams, _STASH_ROWS, device)
    out = torch.empty(batch + (OUT_STRIDE,), dtype=torch.float32, device=device)
    head = (sampled.data_ptr(), refpack.data_ptr(), p3.data_ptr(), flags.data_ptr(), n)
    tail = (*_scalars(intrinsics, dof), workspace.data_ptr(),
            _ticket_buffer(device, stream, streams).data_ptr(), out.data_ptr(), stream)
    if batched:
        err = lib.dvo_fused_stats_batched(*head, streams, *tail)
    else:
        err = lib.dvo_fused_stats(*head, *tail)
    if err != 0:
        raise RuntimeError(f"{who}: kernel launch failed, CUDA error {err}")
    return packed_stats(out)


def fused_stats_cuda(
    sampled, refpack, precision3, first_iter, intrinsics: Intrinsics, dof: float = 5.0
) -> FusedStats:
    """The statistics kernel from a sampled pack (``csrc/fused_stats.cu``,
    ``dvo_fused_stats``, the counterpart of ``fused_stats_pallas``): the
    folded kernel's two launches with the sampled values loaded instead of
    warped and gathered.  ``fused_stats_cuda.launches`` counts the calls."""
    stats = _launch_fused_stats("fused_stats_cuda", sampled, refpack, precision3, first_iter,
                                intrinsics, dof, batched=False)
    fused_stats_cuda.launches += 1
    return stats


fused_stats_cuda.launches = 0


def fused_stats_batched_cuda(
    sampled, refpack, precision3, first_iter, intrinsics: Intrinsics, dof: float = 5.0
) -> FusedStats:
    """The batched statistics kernel from sampled packs
    (``dvo_fused_stats_batched``): ``sampled``/``refpack`` [B, 8, N],
    ``precision3`` [B, 3], ``first_iter`` [] or [B]; every field of the
    result has a leading [B], stream b's bit-equal to ``fused_stats_cuda``
    on stream b's packs.  Each call adds one to
    ``fused_stats_batched_cuda.launches``."""
    stats = _launch_fused_stats("fused_stats_batched_cuda", sampled, refpack, precision3,
                                first_iter, intrinsics, dof, batched=True)
    fused_stats_batched_cuda.launches += 1
    return stats


fused_stats_batched_cuda.launches = 0


def fused_partials_rows_cuda(
    sampled, refpack, precision3, first_iter, intrinsics: Intrinsics, dof: float = 5.0
):
    """The CUDA single-pass kernel (``csrc/fused_stats.cu``,
    ``dvo_fused_partials``): one launch on the current stream, no host
    synchronisation.  Returns the Gram [16, 16] and the per-pixel rows
    rw [4, N] = (r_I, r_Z, w, mask).  Each call adds one to
    ``fused_partials_cuda.launches``."""
    _, p3, flags = _sampled_inputs("fused_partials_cuda", sampled, refpack, precision3,
                                   first_iter, batched=False)
    n = sampled.shape[1]
    device = sampled.device
    lib = _kernel_library()
    stream = _build.current_stream(device)
    workspace = _workspace(lib, n, 1, 0, device)
    out = torch.empty((OUT_STRIDE,), dtype=torch.float32, device=device)
    rw = torch.empty((4, n), dtype=torch.float32, device=device)
    err = lib.dvo_fused_partials(
        sampled.data_ptr(), refpack.data_ptr(), p3.data_ptr(), flags.data_ptr(), n,
        *_scalars(intrinsics, dof)[:6], workspace.data_ptr(),
        _ticket_buffer(device, stream, 1).data_ptr(), out.data_ptr(), rw.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_partials_cuda: kernel launch failed, CUDA error {err}")
    fused_partials_cuda.launches += 1
    return out[_OUT_GRAM:_OUT_GRAM + 256].view(16, 16), rw


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
