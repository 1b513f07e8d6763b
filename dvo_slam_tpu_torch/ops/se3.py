"""SE(3) Lie-group operations on tensors (port of ``dvo_slam_tpu.ops.se3``).

Twist convention matches Sophus and the reference: ``xi = [v, w]`` with
translation first and rotation last; poses are 4x4 homogeneous matrices.
Small angles take the same Taylor branches as the reference, selected
with ``torch.where`` so that no value is read back to the host.
"""

from __future__ import annotations

import torch

# Below this squared angle (theta < 0.1 rad) the exp/log coefficient
# functions switch to two-term Taylor series: their closed forms cancel
# catastrophically in float32 there, the truncation error is ~1e-8.
_SMALL_ANGLE_SQ = 1e-2


def hat_so3(w):
    """3-vector -> skew-symmetric matrix, so that hat(w) @ x == cross(w, x)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zeros, -wz, wy], dim=-1),
            torch.stack([wz, zeros, -wx], dim=-1),
            torch.stack([-wy, wx, zeros], dim=-1),
        ],
        dim=-2,
    )


def vee_so3(W):
    """Inverse of :func:`hat_so3`."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _exp_coefficients(theta_sq):
    """(A, B, C) with R = I + A*what + B*what^2 and V = I + B*what + C*what^2,
    float32-stable at every angle: B through the half-angle identity, A and
    C through two-term Taylor series below theta = 0.1."""
    safe = torch.clamp(theta_sq, min=_SMALL_ANGLE_SQ)
    theta = torch.sqrt(safe)
    small = theta_sq < _SMALL_ANGLE_SQ
    a = torch.where(
        small,
        1.0 - theta_sq / 6.0 + theta_sq * theta_sq / 120.0,
        torch.sin(theta) / theta,
    )
    half = 0.5 * torch.sqrt(theta_sq)
    sin_half = torch.sin(half)
    b = torch.where(
        theta_sq < 1e-12,
        0.5 - theta_sq / 24.0,
        2.0 * sin_half * sin_half / torch.clamp(theta_sq, min=1e-12),
    )
    c = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0, (1.0 - a) / safe)
    return a, b, c


def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device)


def _homogeneous(top):
    """[..., 3, 4] -> [..., 4, 4] with the (0, 0, 0, 1) bottom row."""
    bottom = torch.zeros(top.shape[:-2] + (1, 4), dtype=top.dtype, device=top.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def log_so3(R):
    """Rotation matrix -> rotation vector, with theta from
    atan2(|skew(R)|, (tr - 1) / 2) (well conditioned at small angles)."""
    skew = 0.5 * (R - R.transpose(-1, -2))
    w_raw = vee_so3(skew)  # norm == sin(theta)
    sin_theta = torch.sqrt(torch.sum(w_raw * w_raw, dim=-1))
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = 0.5 * (trace - 1.0)
    theta = torch.atan2(sin_theta, cos_theta)
    theta_sq = theta * theta
    small = theta_sq < _SMALL_ANGLE_SQ
    factor = torch.where(
        small,
        1.0 + theta_sq / 6.0,
        theta / torch.clamp(sin_theta, min=1e-12),
    )
    return factor[..., None] * w_raw


def exp_se3(xi):
    """Twist [v, w] -> 4x4 homogeneous transform (Sophus::SE3::exp)."""
    v, w = xi[..., :3], xi[..., 3:]
    theta_sq = torch.sum(w * w, dim=-1)
    a, b, c = _exp_coefficients(theta_sq)
    what = hat_so3(w)
    what_sq = what @ what
    eye = _eye3(xi)
    R = eye + a[..., None, None] * what + b[..., None, None] * what_sq
    V = eye + b[..., None, None] * what + c[..., None, None] * what_sq
    t = torch.einsum("...ij,...j->...i", V, v)
    return _homogeneous(torch.cat([R, t[..., None]], dim=-1))


def log_se3(T):
    """4x4 homogeneous transform -> twist [v, w] (Sophus::SE3::log)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = log_so3(R)
    theta_sq = torch.sum(w * w, dim=-1)
    a, b, _ = _exp_coefficients(theta_sq)
    safe = torch.clamp(theta_sq, min=_SMALL_ANGLE_SQ)
    small = theta_sq < _SMALL_ANGLE_SQ
    # V^{-1} = I - what/2 + d * what^2, d = (1 - a/(2b)) / theta^2
    d = torch.where(
        small, 1.0 / 12.0 + theta_sq / 720.0, (1.0 - a / (2.0 * b)) / safe
    )
    what = hat_so3(w)
    what_sq = what @ what
    V_inv = _eye3(T) - 0.5 * what + d[..., None, None] * what_sq
    v = torch.einsum("...ij,...j->...i", V_inv, t)
    return torch.cat([v, w], dim=-1)


def inverse(T):
    """Inverse of a rigid transform (exploits the SE(3) structure)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    t_inv = -torch.einsum("...ij,...j->...i", Rt, t)
    return _homogeneous(torch.cat([Rt, t_inv[..., None]], dim=-1))


def identity(dtype=torch.float32, device=None):
    return torch.eye(4, dtype=dtype, device=device)
