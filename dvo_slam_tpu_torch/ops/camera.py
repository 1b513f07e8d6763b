"""Pinhole camera model and per-pyramid-level intrinsics (port of
``dvo_slam_tpu.ops.camera``).

``Intrinsics`` stays a hashable NamedTuple of Python floats: the
constants enter the tensor math as scalars, never as device tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Intrinsics(NamedTuple):
    """Pinhole intrinsics (fx, fy, ox, oy)."""

    fx: float
    fy: float
    ox: float
    oy: float

    def scale(self, factor: float) -> "Intrinsics":
        """Uniform scaling of the whole K matrix (offsets included), as the
        reference does for pyramid levels."""
        return Intrinsics(
            self.fx * factor, self.fy * factor, self.ox * factor, self.oy * factor
        )

    def at_level(self, level: int) -> "Intrinsics":
        """Intrinsics for pyramid level ``level`` (halved per level)."""
        return self.scale(0.5**level)

    def matrix(self, dtype=torch.float32, device=None):
        """The 3x3 camera matrix K."""
        return torch.tensor(
            [[self.fx, 0.0, self.ox], [0.0, self.fy, self.oy], [0.0, 0.0, 1.0]],
            dtype=dtype, device=device,
        )


# TUM RGB-D intrinsics, as used by the reference benchmark driver.
TUM_FR1 = Intrinsics(517.3, 516.5, 318.6, 255.3)
TUM_FR2 = Intrinsics(520.9, 521.0, 325.1, 249.7)
TUM_FR3 = Intrinsics(535.4, 539.2, 320.1, 247.6)
TUM_DEFAULT = Intrinsics(525.0, 525.0, 319.5, 239.5)


def unproject(depth, intrinsics: Intrinsics):
    """Back-project a depth map [..., H, W] to camera-frame points
    [..., H, W, 3]."""
    h, w = depth.shape[-2:]
    u = torch.arange(w, dtype=depth.dtype, device=depth.device)[None, :]
    v = torch.arange(h, dtype=depth.dtype, device=depth.device)[:, None]
    # divided by tensors: PyTorch's CUDA division by a Python scalar
    # multiplies by its rounded reciprocal, the CPU divides
    x = (u - intrinsics.ox) / torch.full_like(u, intrinsics.fx) * depth
    y = (v - intrinsics.oy) / torch.full_like(v, intrinsics.fy) * depth
    return torch.stack([x, y, depth], dim=-1)


def project(points, intrinsics: Intrinsics):
    """Project camera-frame points [..., 3] to pixel coordinates [..., 2];
    the division is guarded so masked lanes stay finite."""
    z = points[..., 2]
    z_safe = torch.where(z.abs() > 1e-12, z, torch.full_like(z, 1e-12))
    u = points[..., 0] / z_safe * intrinsics.fx + intrinsics.ox
    v = points[..., 1] / z_safe * intrinsics.fy + intrinsics.oy
    return torch.stack([u, v], dim=-1)
