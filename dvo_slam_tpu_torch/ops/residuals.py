"""Warp, sample, residuals and Jacobians (port of
``dvo_slam_tpu.ops.residuals``).

Two forms, as in the reference.  The modular path (``compute_residuals``,
``normal_equations``: one op per reference kernel, channel-last, the
``xla`` backend of the tracker) evaluates the photometric and geometric
residuals r_I = (I_cur(u, v) - I_ref) / 255 and r_Z = Z_cur(u, v) - z',
the occlusion gate r_Z > -20 sigma_z(z_ref), and the Jacobians
J_I = dI . Jw(p_ref), J_Z = dZ . Jw(p_ref) - Jz(p_ref) with the ESM blend
of the intensity gradients.  Every function takes an optional leading
[B] axis (the lockstep multi-stream solve).

The fused path's gather, ``warp_and_sample_cm``: reference points come from the refpack (x, y in rows 4/5, z = depth in
row 1, unprojected once per frame); each is transformed by T, projected,
and the current frame's quad table is sampled there.  This is plain
PyTorch, as it is XLA code in the reference: the CPU path and the oracle
of the folded kernel (``fused_kernels.warp_fused_stats``), which does the
same per pixel on the card.  It batches over a leading stream axis (the lockstep
multi-stream solve: each stream its own T, refpack and quad table).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .camera import Intrinsics, unproject
from .interp import bilinear_sample_accel, bilinear_sample_quad, sample_quad


class ResidualData(NamedTuple):
    """Per-pixel residuals and Jacobians over a dense [..., N = H*W]
    layout; masked-out entries are zero, so reductions are plain sums."""

    residuals: torch.Tensor  # [..., N, 2] (r_I, r_Z)
    jacobian: torch.Tensor  # [..., N, 2, 6]
    mask: torch.Tensor  # [..., N] bool, True = valid constraint
    num_valid: torch.Tensor  # [...] int32


def depth_stddev(z):
    """Kinect axial noise sigma_z = 0.0012 + 0.0019 (z - 0.4)^2."""
    d = z - 0.4
    return 0.0012 + 0.0019 * d * d


def projection_jacobian(p):
    """Analytic 2x6 Jacobian of (projection o transform) with respect to
    the twist [v, w] at points ``p`` [..., 3], in unit-focal image
    coordinates (the focal lengths are folded into the gradients)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    z_safe = torch.where(z.abs() > 1e-12, z, torch.full_like(z, 1e-12))
    iz = 1.0 / z_safe
    iz2 = iz * iz
    zeros = torch.zeros_like(x)
    row0 = torch.stack(
        [iz, zeros, -x * iz2, -x * y * iz2, 1.0 + x * x * iz2, -y * iz], dim=-1
    )
    row1 = torch.stack(
        [zeros, iz, -y * iz2, -(1.0 + y * y * iz2), x * y * iz2, x * iz], dim=-1
    )
    return torch.stack([row0, row1], dim=-2)


def transform_z_jacobian(p):
    """Third row of d(T p)/d(twist) at points ``p`` [..., 3]:
    [0, 0, 1, y, -x, 0]."""
    x, y = p[..., 0], p[..., 1]
    zeros = torch.zeros_like(x)
    return torch.stack([zeros, zeros, torch.ones_like(x), y, -x, zeros], dim=-1)


def transform_points(depth, intrinsics: Intrinsics, T):
    """Reference points of a depth map [..., H, W] -> (points [..., N, 3],
    transformed points [..., N, 3]) under T [..., 4, 4]."""
    h, w = depth.shape[-2:]
    points = unproject(depth, intrinsics).reshape(depth.shape[:-2] + (h * w, 3))
    R = T[..., :3, :3].to(depth.dtype).unsqueeze(-1)  # [..., 3, 3, 1]
    t = T[..., :3, 3].to(depth.dtype).unsqueeze(-1)  # [..., 3, 1]
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    # the three-term products summed left to right, unfused: one rounding
    # order on every device (a matrix product's depends on its kernel)
    p_t = torch.stack(
        [R[..., j, 0, :] * x + R[..., j, 1, :] * y + R[..., j, 2, :] * z + t[..., j, :]
         for j in range(3)],
        dim=-1,
    )
    return points, p_t


def _project(p_t, intrinsics: Intrinsics):
    """Pixel coordinates (u, v) of transformed points [..., N, 3]."""
    z_t = p_t[..., 2]
    z_safe = torch.where(z_t > 1e-12, z_t, torch.full_like(z_t, 1e-12))
    u = p_t[..., 0] / z_safe * intrinsics.fx + intrinsics.ox
    v = p_t[..., 1] / z_safe * intrinsics.fy + intrinsics.oy
    return u, v


def warp_and_sample(ref_depth, cur_accel, intrinsics: Intrinsics, T, quad=None):
    """Warp the reference points of ``ref_depth`` [..., H, W] by T and
    sample the current acceleration tensor [..., H, W, 8] there (through
    the row-major quad table [..., H*W, 32] where given).  Returns
    (sampled [..., N, 8] with channel 6 the combined bounds/neighbour
    validity, z' [..., N], points [..., N, 3]).  The sample is
    depth-buffered against z', as the reference's."""
    shape = tuple(ref_depth.shape[-2:])
    points, p_t = transform_points(ref_depth, intrinsics, T)
    z_t = p_t[..., 2]
    u, v = _project(p_t, intrinsics)
    if quad is not None:
        sampled, sample_valid = bilinear_sample_quad(quad, shape, u, v, z_t)
    else:
        sampled, sample_valid = bilinear_sample_accel(cur_accel, u, v, z_t)
    sampled[..., 6] = (sample_valid & (z_t > 1e-12)).to(sampled.dtype)
    return sampled, z_t, points


def warp_and_sample_cm(
    refpack_cm,  # [..., 8, N] channel-major (i, z, idx, idy, x, y, sel, 0)
    quad_cm,  # [..., 32, N] quad table of the current frame
    shape,  # (H, W) of the level
    intrinsics: Intrinsics,
    T,  # [..., 4, 4]
    depth_buffered: bool = True,  # TrackerConfig.depth_buffered_sampling
):
    """Channel-major warp + sample.  Returns ``sampled [..., 8, N]``:
    channels 0-5 the sampled i, z, idx, idy, zdx, zdy, channel 6 the
    combined bounds/neighbour validity, channel 7 the transformed depth z'.
    The sample is depth-buffered against z' unless ``depth_buffered`` is
    off.  One stream: [8, N], [32, N], [4, 4]; B streams: [B, 8, N],
    [B, 32, N], [B, 4, 4] (the reference's ``stream_index`` lockstep).
    Each call adds one to ``warp_and_sample_cm.calls`` (the tracker's
    evaluation on the card folds this into its kernel and never calls it)."""
    warp_and_sample_cm.calls += 1
    x, y, z = refpack_cm[..., 4, :], refpack_cm[..., 5, :], refpack_cm[..., 1, :]
    R = T[..., :3, :3].to(refpack_cm.dtype).unsqueeze(-1)  # [..., 3, 3, 1]
    t = T[..., :3, 3].to(refpack_cm.dtype).unsqueeze(-1)  # [..., 3, 1]
    p_x = R[..., 0, 0, :] * x + R[..., 0, 1, :] * y + R[..., 0, 2, :] * z + t[..., 0, :]
    p_y = R[..., 1, 0, :] * x + R[..., 1, 1, :] * y + R[..., 1, 2, :] * z + t[..., 1, :]
    z_t = R[..., 2, 0, :] * x + R[..., 2, 1, :] * y + R[..., 2, 2, :] * z + t[..., 2, :]
    z_safe = torch.where(z_t > 1e-12, z_t, torch.full_like(z_t, 1e-12))
    u = p_x / z_safe * intrinsics.fx + intrinsics.ox
    v = p_y / z_safe * intrinsics.fy + intrinsics.oy
    sampled, sample_valid = sample_quad(
        quad_cm, shape, u, v, z_expected=z_t if depth_buffered else None
    )
    validity = sample_valid & (z_t > 1e-12)
    sampled[..., 6, :] = validity.to(sampled.dtype)
    sampled[..., 7, :] = z_t
    return sampled


warp_and_sample_cm.calls = 0


def compute_residuals(
    ref_intensity,  # [..., H, W]
    ref_depth,  # [..., H, W]
    ref_idx,
    ref_idy,
    sel_mask,  # [..., H, W] bool: the selected reference points
    cur_accel,  # [..., H, W, 8]
    intrinsics: Intrinsics,
    T,  # [..., 4, 4] reference -> current
) -> ResidualData:
    """One residual and Jacobian evaluation over a pyramid level.  The
    sample is always depth-buffered against the transformed depth, as the
    reference's is, whatever ``TrackerConfig.depth_buffered_sampling``
    says (ROADMAP C).  Each call adds one to ``compute_residuals.calls``."""
    compute_residuals.calls += 1
    flat = ref_intensity.shape[:-2] + (ref_intensity.shape[-2] * ref_intensity.shape[-1],)
    dtype = ref_intensity.dtype
    points, p_t = transform_points(ref_depth, intrinsics, T)
    z_t = p_t[..., 2]
    u, v = _project(p_t, intrinsics)
    sampled, sample_valid = bilinear_sample_accel(cur_accel, u, v, z_t)

    i_ref = ref_intensity.reshape(flat)
    r_i = (sampled[..., 0] - i_ref) * (1.0 / 255.0)
    r_z = sampled[..., 1] - z_t

    # occlusion rejection against the reference depth's noise band
    not_occluded = r_z > -20.0 * depth_stddev(ref_depth.reshape(flat))
    mask = sel_mask.reshape(flat) & sample_valid & (z_t > 1e-12) & not_occluded

    # gradient weights: ESM blend for intensity, current only for depth,
    # focal-length scaled
    gi_x = 0.5 * (sampled[..., 2] + ref_idx.reshape(flat)) * (intrinsics.fx / 255.0)
    gi_y = 0.5 * (sampled[..., 3] + ref_idy.reshape(flat)) * (intrinsics.fy / 255.0)
    gz_x = sampled[..., 4] * intrinsics.fx
    gz_y = sampled[..., 5] * intrinsics.fy

    jw = projection_jacobian(points)  # [..., N, 2, 6]
    jz = transform_z_jacobian(points)  # [..., N, 6]
    j_i = gi_x.unsqueeze(-1) * jw[..., 0, :] + gi_y.unsqueeze(-1) * jw[..., 1, :]
    j_z = gz_x.unsqueeze(-1) * jw[..., 0, :] + gz_y.unsqueeze(-1) * jw[..., 1, :] - jz

    maskf = mask.to(dtype)
    return ResidualData(
        residuals=torch.stack([r_i, r_z], dim=-1) * maskf.unsqueeze(-1),
        jacobian=torch.stack([j_i, j_z], dim=-2) * maskf[..., None, None],
        mask=mask,
        num_valid=mask.sum(dim=-1, dtype=torch.int32),
    )


compute_residuals.calls = 0


def normal_equations(residual_data: ResidualData, weights, precision):
    """The 6x6 normal equations A = sum_i w_i J_i^T P J_i and
    b = -sum_i w_i J_i^T P r_i, as contractions over the pixels; A is
    symmetrised.  ``weights`` [..., N], ``precision`` [..., 2, 2].

    With a leading stream axis, b is contracted stream by stream in the
    one-stream call's shape (a matrix-vector product; the batched
    contraction is a batched matrix product, which rounds otherwise), so
    that each stream's b is its one-stream call's bits; A's batched
    product already is."""
    J = residual_data.jacobian  # [..., N, 2, 6]
    r = residual_data.residuals  # [..., N, 2]
    wJ = weights[..., None, None] * J
    PJ = torch.einsum("...ab,...nbj->...naj", precision, J)
    A = torch.einsum("...nai,...naj->...ij", wJ, PJ)
    A = 0.5 * (A + A.transpose(-1, -2))
    Pr = r @ precision.transpose(-1, -2)
    if wJ.dim() == 3:
        return A, -torch.einsum("...nai,...na->...i", wJ, Pr)
    streams = zip(wJ.reshape((-1,) + wJ.shape[-3:]), Pr.reshape((-1,) + Pr.shape[-2:]))
    b = torch.stack([torch.einsum("...nai,...na->...i", wJ_s, Pr_s) for wJ_s, Pr_s in streams])
    return A, -b.reshape(wJ.shape[:-3] + (6,))
