"""Bilinear sampling through the channel-major quad table (port of the
quad-table part of ``dvo_slam_tpu.ops.interp``).

Validity travels as an explicit channel: a sample is valid only if its
2x2 support is inside the image and (plain form) all four neighbours are
valid, or (depth-buffered form) at least one neighbour contributes.

Every function batches over leading dimensions.  One stream samples one
[32, N] table at [N] coordinates; B streams in lockstep sample a
[B, 32, N] table stack at [B, N] coordinates, each stream through its own
table, with ONE ``torch.gather`` for all of them.  That batched table with
a per-item index replaces the reference's ``custom_vmap`` gather rule, its
tuple of standalone per-stream tables (``lockstep_stream_indices``) and
its ``lane_offset`` flat table: all three work around XLA's gather
lowering on the TPU and have no counterpart here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

VALID_CHANNEL = 6
DEPTH_BUFFER_M = 0.05  # reference: interpolation.cpp:71 (z_eps = z - 0.05)


def build_quad_table_cm(accel_cm, width: int):
    """Channel-major quad table [..., 32, H*W]: rows 0-7 are the pixel's 8
    channels, 8-15 its right neighbour, 16-23 below, 24-31 below-right.
    Rows at the right/bottom border wrap; the bounds test never uses them."""
    right = torch.roll(accel_cm, -1, dims=-1)
    down = torch.roll(accel_cm, -width, dims=-1)
    down_right = torch.roll(accel_cm, -(width + 1), dims=-1)
    return torch.cat([accel_cm, right, down, down_right], dim=-2)


class QuadIndex(NamedTuple):
    """Where one bilinear sample reads: the top-left pixel of its 2x2
    support, its four bilinear weight factors and the bounds test (all
    [..., N])."""

    idx: torch.Tensor  # int64 flat index of the top-left neighbour
    x0w: torch.Tensor
    x1w: torch.Tensor
    y0w: torch.Tensor
    y1w: torch.Tensor
    in_bounds: torch.Tensor  # bool


def quad_index(shape, u, v) -> QuadIndex:
    """The sample positions (u, v) [..., N] on an (H, W) level."""
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
    return QuadIndex(idx, x0w, x1w, y0w, y1w, in_bounds)


def gather_quad(quad_cm, idx):
    """Columns ``idx`` [..., N] of the quad table [..., 32, H*W] ->
    [..., 32, N].  One table: one column gather.  A batch of tables: one
    ``torch.gather`` in which each item reads its own table."""
    if quad_cm.dim() == 2:
        return quad_cm[:, idx]
    index = idx.unsqueeze(-2).expand(idx.shape[:-1] + (quad_cm.shape[-2], idx.shape[-1]))
    return torch.gather(quad_cm, -1, index)


def combine_quad(cols, q: QuadIndex, z_expected=None):
    """The bilinear sample from the gathered 2x2 support ``cols``
    [..., 32, N] -> (values [..., 8, N], valid [..., N]).

    With ``z_expected`` the sample is depth-buffered (the reference's 5 cm
    rule): a neighbour contributes only if it is valid and its depth is not
    more than 5 cm in front of the expected depth, and the weights are
    renormalised over the contributors.  When all four contribute the
    result equals the plain bilinear sample."""
    a00, a10, a01, a11 = cols[..., :8, :], cols[..., 8:16, :], cols[..., 16:24, :], cols[..., 24:32, :]
    x0w, x1w, y0w, y1w = (t.unsqueeze(-2) for t in (q.x0w, q.x1w, q.y0w, q.y1w))

    if z_expected is None:
        values = (a00 * x0w + a10 * x1w) * y0w + (a01 * x0w + a11 * x1w) * y1w
        neighbors_valid = (
            (a00[..., VALID_CHANNEL, :] > 0.5)
            & (a10[..., VALID_CHANNEL, :] > 0.5)
            & (a01[..., VALID_CHANNEL, :] > 0.5)
            & (a11[..., VALID_CHANNEL, :] > 0.5)
        )
        return values, q.in_bounds & neighbors_valid

    z_eps = z_expected - DEPTH_BUFFER_M

    def keep(a):
        return ((a[..., VALID_CHANNEL, :] > 0.5) & (a[..., 1, :] > z_eps)).to(q.x0w.dtype)

    w00 = q.x0w * q.y0w * keep(a00)
    w10 = q.x1w * q.y0w * keep(a10)
    w01 = q.x0w * q.y1w * keep(a01)
    w11 = q.x1w * q.y1w * keep(a11)
    wsum = w00 + w10 + w01 + w11
    values = (
        a00 * w00.unsqueeze(-2) + a10 * w10.unsqueeze(-2)
        + a01 * w01.unsqueeze(-2) + a11 * w11.unsqueeze(-2)
    ) / torch.clamp(wsum, min=1e-6).unsqueeze(-2)
    return values, q.in_bounds & (wsum > 1e-6)


def sample_quad(quad_cm, shape, u, v, z_expected=None):
    """Full bilinear sample through the quad table: one column gather
    brings each pixel's 2x2 support.  ``quad_cm`` [32, N] with (u, v,
    z_expected) [N], or a stack [B, 32, N] with [B, N] coordinates (one
    gather for all B streams).  Returns (values [..., 8, N], valid
    [..., N]); depth-buffered when ``z_expected`` is given."""
    q = quad_index(shape, u, v)
    return combine_quad(gather_quad(quad_cm, q.idx), q, z_expected)
