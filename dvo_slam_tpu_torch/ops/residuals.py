"""Warp and sample: the gather half of the residual chain (port of
``warp_and_sample_cm`` from ``dvo_slam_tpu.ops.residuals``).

Reference points come from the refpack (x, y in rows 4/5, z = depth in
row 1, unprojected once per frame); each is transformed by T, projected,
and the current frame's quad table is sampled there.  This is plain
PyTorch, as it is XLA code in the reference; the fused kernel consumes
its output.  It batches over a leading stream axis (the lockstep
multi-stream solve: each stream its own T, refpack and quad table).
"""

from __future__ import annotations

import torch

from .camera import Intrinsics
from .interp import sample_quad


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
    [B, 32, N], [B, 4, 4] (the reference's ``stream_index`` lockstep)."""
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
