"""Bilinear sampling through the channel-major quad table (port of the
quad-table part of ``dvo_slam_tpu.ops.interp``).

Validity travels as an explicit channel: a sample is valid only if its
2x2 support is inside the image and (plain form) all four neighbours are
valid, or (depth-buffered form) at least one neighbour contributes.

The reference's ``custom_vmap`` gather rules and its tuple/lane-offset
samplers work around XLA's gather lowering on the TPU and have no
counterpart here: the gather is ``quad[:, idx]``.
"""

from __future__ import annotations

import torch

VALID_CHANNEL = 6
DEPTH_BUFFER_M = 0.05  # reference: interpolation.cpp:71 (z_eps = z - 0.05)


def build_quad_table_cm(accel_cm, width: int):
    """Channel-major quad table [32, H*W]: rows 0-7 are the pixel's 8
    channels, 8-15 its right neighbour, 16-23 below, 24-31 below-right.
    Rows at the right/bottom border wrap; the bounds test never uses them."""
    right = torch.roll(accel_cm, -1, dims=1)
    down = torch.roll(accel_cm, -width, dims=1)
    down_right = torch.roll(accel_cm, -(width + 1), dims=1)
    return torch.cat([accel_cm, right, down, down_right], dim=0)


def _sample_quad_cols(quad_cm, shape, u, v, z_expected=None):
    """Full bilinear sample through one [32, N] quad table: one column
    gather brings each pixel's 2x2 support.  Returns (values [8, N],
    valid [N]).

    With ``z_expected`` the sample is depth-buffered (the reference's 5 cm
    rule): a neighbour contributes only if it is valid and its depth is not
    more than 5 cm in front of the expected depth, and the weights are
    renormalised over the contributors.  When all four contribute the
    result equals the plain bilinear sample."""
    h, w = shape
    in_bounds = (u >= 0.0) & (u < w - 1) & (v >= 0.0) & (v < h - 1)

    u = torch.clamp(u, 0.0, w - 1.001)
    v = torch.clamp(v, 0.0, h - 1.001)
    x0 = torch.floor(u)
    y0 = torch.floor(v)
    x1w = u - x0
    y1w = v - y0
    x0w = 1.0 - x1w
    y0w = 1.0 - y1w

    idx = y0.to(torch.int64) * w + x0.to(torch.int64)
    idx = torch.clamp(idx, 0, h * w - 1)
    cols = quad_cm[:, idx]  # [32, N]
    a00, a10, a01, a11 = cols[:8], cols[8:16], cols[16:24], cols[24:32]

    if z_expected is None:
        values = (a00 * x0w + a10 * x1w) * y0w + (a01 * x0w + a11 * x1w) * y1w
        neighbors_valid = (
            (a00[VALID_CHANNEL] > 0.5)
            & (a10[VALID_CHANNEL] > 0.5)
            & (a01[VALID_CHANNEL] > 0.5)
            & (a11[VALID_CHANNEL] > 0.5)
        )
        return values, in_bounds & neighbors_valid

    z_eps = z_expected - DEPTH_BUFFER_M

    def keep(a):
        return ((a[VALID_CHANNEL] > 0.5) & (a[1] > z_eps)).to(u.dtype)

    w00 = x0w * y0w * keep(a00)
    w10 = x1w * y0w * keep(a10)
    w01 = x0w * y1w * keep(a01)
    w11 = x1w * y1w * keep(a11)
    wsum = w00 + w10 + w01 + w11
    values = (a00 * w00 + a10 * w10 + a01 * w01 + a11 * w11) / torch.clamp(
        wsum, min=1e-6
    )
    return values, in_bounds & (wsum > 1e-6)
