"""RGB-D image pyramids as dense masked tensors (port of
``dvo_slam_tpu.ops.pyramid``).

The 2x2 mean and the stride-2 depth pick are plain slicing here: the
reference's one-hot matmul form exists only because stride-2 lane
slicing is slow on the TPU.  The mean keeps the reference's rounding
order, ``0.5*a + 0.5*b`` along rows and then along columns, so levels
built from u8/u16 input are bit-equal to the reference's.

Channel layout of the acceleration pack (reference order i, z, idx, idy,
zdx, zdy):
  0: intensity            4: depth x-derivative
  1: depth                5: depth y-derivative
  2: intensity x-deriv    6: validity (1.0 where z, zdx, zdy all valid)
  3: intensity y-deriv    7: zero padding
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class PyramidLevel(NamedTuple):
    """One pyramid level of an RGB-D frame, dense with masks.

    ``intensity`` is 0..255 float grayscale; ``depth`` is meters with 0.0
    at invalid pixels; ``valid`` marks valid depth; ``zvalid`` also
    requires both depth derivatives valid.
    """

    intensity: torch.Tensor  # [H, W] float32
    depth: torch.Tensor  # [H, W] float32, 0 where invalid
    valid: torch.Tensor  # [H, W] bool
    idx: torch.Tensor  # [H, W] float32, d(intensity)/dx
    idy: torch.Tensor  # [H, W] float32
    zdx: torch.Tensor  # [H, W] float32, 0 where invalid
    zdy: torch.Tensor  # [H, W] float32
    zvalid: torch.Tensor  # [H, W] bool

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.intensity.shape)


def convert_raw_depth(raw_depth_u16, depth_scale: float = 5000.0):
    """Raw 16-bit depth -> (meters, valid) with 0 marking invalid (TUM
    scale 1/5000, zero raw depth = invalid).  Takes any integer tensor or
    array; uint16 is widened to int32 first, as PyTorch has few uint16
    kernels."""
    raw = torch.as_tensor(raw_depth_u16)
    if raw.dtype == torch.uint16:
        raw = raw.to(torch.int32)
    valid = raw > 0
    depth = torch.where(
        valid, raw.to(torch.float32) / depth_scale, torch.zeros((), device=raw.device)
    )
    return depth, valid


def _edge_pad(img, axis):
    """Clamp-to-edge pad of one pixel on both sides of ``axis`` (0 or 1)."""
    if axis == 1:
        return torch.cat([img[:, :1], img, img[:, -1:]], dim=1)
    return torch.cat([img[:1], img, img[-1:]], dim=0)


def central_diff_x(img):
    """d(img)/dx by central differences with clamped borders:
    0.5 * (img[y, min(x+1, W-1)] - img[y, max(x-1, 0)])."""
    padded = _edge_pad(img, 1)
    return 0.5 * (padded[:, 2:] - padded[:, :-2])


def central_diff_y(img):
    """d(img)/dy, same scheme as :func:`central_diff_x` along rows."""
    padded = _edge_pad(img, 0)
    return 0.5 * (padded[2:, :] - padded[:-2, :])


# A depth central difference above this (meters per pixel) spans a depth
# discontinuity, not a surface; such derivatives are marked invalid (see
# the reference's MAX_DEPTH_DERIVATIVE_M for the measured rationale).
MAX_DEPTH_DERIVATIVE_M = 0.3


def _masked_central_diff(depth, valid, max_derivative=MAX_DEPTH_DERIVATIVE_M):
    """Depth derivatives, valid only where both clamped neighbours are
    valid and the difference spans no discontinuity (0 disables the gate)."""
    px = _edge_pad(depth, 1)
    vx = _edge_pad(valid, 1)
    zdx = 0.5 * (px[:, 2:] - px[:, :-2])
    zdx_valid = vx[:, 2:] & vx[:, :-2]
    py = _edge_pad(depth, 0)
    vy = _edge_pad(valid, 0)
    zdy = 0.5 * (py[2:, :] - py[:-2, :])
    zdy_valid = vy[2:, :] & vy[:-2, :]
    if max_derivative > 0:
        zdx_valid = zdx_valid & (zdx.abs() <= max_derivative)
        zdy_valid = zdy_valid & (zdy.abs() <= max_derivative)
    zero = torch.zeros((), dtype=depth.dtype, device=depth.device)
    zdx = torch.where(zdx_valid, zdx, zero)
    zdy = torch.where(zdy_valid, zdy, zero)
    return zdx, zdy, zdx_valid & zdy_valid


def downsample_intensity(img):
    """2x2 mean downsample to floor(h/2) x floor(w/2): rows first, then
    columns, each as 0.5*a + 0.5*b (the reference's rounding order)."""
    h, w = img.shape
    h2, w2 = h // 2, w // 2
    rows = 0.5 * img[0 : 2 * h2 : 2] + 0.5 * img[1 : 2 * h2 : 2]
    return 0.5 * rows[:, 0 : 2 * w2 : 2] + 0.5 * rows[:, 1 : 2 * w2 : 2]


def downsample_depth(depth, valid):
    """Keep every second pixel (no averaging across surfaces); output is
    floor(h/2) x floor(w/2), like the mean downsampler."""
    h, w = depth.shape
    h2, w2 = h // 2, w // 2
    return (
        depth[0 : 2 * h2 : 2, 0 : 2 * w2 : 2].contiguous(),
        valid[0 : 2 * h2 : 2, 0 : 2 * w2 : 2].contiguous(),
    )


def make_level(
    intensity, depth, valid, max_depth_derivative: float = MAX_DEPTH_DERIVATIVE_M
) -> PyramidLevel:
    """Assemble one pyramid level: derivatives and validity masks."""
    zdx, zdy, deriv_valid = _masked_central_diff(depth, valid, max_depth_derivative)
    return PyramidLevel(
        intensity=intensity,
        depth=depth,
        valid=valid,
        idx=central_diff_x(intensity),
        idy=central_diff_y(intensity),
        zdx=zdx,
        zdy=zdy,
        zvalid=valid & deriv_valid,
    )


def build_pyramid(
    intensity, depth, valid, num_levels: int, skip_below: int = 0
) -> Tuple[PyramidLevel, ...]:
    """Build a ``num_levels``-deep pyramid from level-0 tensors (intensity
    mean-downsampled, depth subsampled).  Levels below ``skip_below`` are
    ``None``: their derivatives and masks are never computed."""
    levels = [make_level(intensity, depth, valid) if skip_below <= 0 else None]
    for lvl in range(1, num_levels):
        intensity = downsample_intensity(intensity)
        depth, valid = downsample_depth(depth, valid)
        levels.append(
            make_level(intensity, depth, valid) if lvl >= skip_below else None
        )
    return tuple(levels)


def build_acceleration_cm(level: PyramidLevel):
    """Channel-major acceleration pack [8, H*W] for the fused solver path."""
    n = level.intensity.numel()
    return torch.stack(
        [
            level.intensity.reshape(n),
            level.depth.reshape(n),
            level.idx.reshape(n),
            level.idy.reshape(n),
            level.zdx.reshape(n),
            level.zdy.reshape(n),
            level.zvalid.to(level.intensity.dtype).reshape(n),
            torch.zeros(n, dtype=level.intensity.dtype, device=level.intensity.device),
        ]
    )


def selection_mask(
    level: PyramidLevel,
    intensity_derivative_threshold: float = 0.0,
    depth_derivative_threshold: float = 0.0,
):
    """Reference-point selection as a dense boolean map: valid z and depth
    derivatives, and any of the four derivative magnitudes strictly above
    its threshold (flat pixels are excluded at zero thresholds)."""
    grad_ok = (
        (level.idx.abs() > intensity_derivative_threshold)
        | (level.idy.abs() > intensity_derivative_threshold)
        | (level.zdx.abs() > depth_derivative_threshold)
        | (level.zdy.abs() > depth_derivative_threshold)
    )
    return level.zvalid & grad_ok
