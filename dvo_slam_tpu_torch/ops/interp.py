"""Bilinear sampling (port of ``dvo_slam_tpu.ops.interp``): through the
channel-major quad table (the fused path), of the channel-last [H, W, 8]
acceleration tensor (the modular path), and of single images (the warps).

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


def _neighbours(shape, u, v):
    """:func:`quad_index` of samples at (u, v) [..., N] and the flat indices
    of their four neighbours (top-left, top-right, bottom-left,
    bottom-right: the clamp keeps the top-left pixel off the last row and
    column)."""
    q = quad_index(shape, u, v)
    w = shape[1]
    return q, (q.idx, q.idx + 1, q.idx + w, q.idx + w + 1)


def _gather_rows(flat, idx):
    """Rows ``idx`` [..., N] of ``flat`` [..., M, C] -> [..., N, C]."""
    if flat.dim() == 2:
        return flat[idx]
    return torch.gather(flat, -2, idx.unsqueeze(-1).expand(idx.shape + (flat.shape[-1],)))


def bilinear_sample_accel(accel, u, v, z_expected=None):
    """Sample the acceleration tensor [..., H, W, 8] at (u, v) [..., N]:
    the four-gather form of the modular path.  Returns (values [..., N, 8],
    valid [..., N]); the bounds keep the 2x2 support inside the image
    (0 <= u < W-1, 0 <= v < H-1).  Without ``z_expected`` a sample needs
    all four neighbours valid; with it the sample is depth-buffered (the
    5 cm rule of :func:`combine_quad`)."""
    h, w, c = accel.shape[-3:]
    q, neighbours = _neighbours((h, w), u, v)
    flat = accel.reshape(accel.shape[:-3] + (h * w, c))
    a00, a10, a01, a11 = (_gather_rows(flat, i) for i in neighbours)
    x0w, x1w, y0w, y1w = (t.unsqueeze(-1) for t in (q.x0w, q.x1w, q.y0w, q.y1w))
    in_bounds = q.in_bounds

    if z_expected is None:
        values = (a00 * x0w + a10 * x1w) * y0w + (a01 * x0w + a11 * x1w) * y1w
        neighbors_valid = (
            (a00[..., VALID_CHANNEL] > 0.5)
            & (a10[..., VALID_CHANNEL] > 0.5)
            & (a01[..., VALID_CHANNEL] > 0.5)
            & (a11[..., VALID_CHANNEL] > 0.5)
        )
        return values, in_bounds & neighbors_valid

    z_eps = z_expected - DEPTH_BUFFER_M

    def keep(a):
        return ((a[..., VALID_CHANNEL] > 0.5) & (a[..., 1] > z_eps)).to(u.dtype)

    w00 = q.x0w * q.y0w * keep(a00)
    w10 = q.x1w * q.y0w * keep(a10)
    w01 = q.x0w * q.y1w * keep(a01)
    w11 = q.x1w * q.y1w * keep(a11)
    wsum = w00 + w10 + w01 + w11
    values = (
        a00 * w00.unsqueeze(-1) + a10 * w10.unsqueeze(-1)
        + a01 * w01.unsqueeze(-1) + a11 * w11.unsqueeze(-1)
    ) / torch.clamp(wsum, min=1e-6).unsqueeze(-1)
    return values, in_bounds & (wsum > 1e-6)


def build_quad_table(accel):
    """Row-major quad table [..., H*W, 32] of an acceleration tensor
    [..., H, W, 8]: the transpose of :func:`build_quad_table_cm`."""
    h, w, c = accel.shape[-3:]
    accel_cm = accel.reshape(accel.shape[:-3] + (h * w, c)).transpose(-1, -2)
    return build_quad_table_cm(accel_cm, w).transpose(-1, -2)


def bilinear_sample_quad(quad, shape, u, v, z_expected=None):
    """Bilinear sampling through the row-major quad table [..., H*W, 32]:
    :func:`sample_quad` on its transpose.  Returns (values [..., N, 8],
    valid [..., N])."""
    values, valid = sample_quad(quad.transpose(-1, -2), shape, u, v, z_expected)
    return values.transpose(-1, -2), valid


def bilinear_with_depth_buffer(intensity, depth, depth_valid, u, v, z_expected):
    """Depth-buffered bilinear interpolation of an intensity image [H, W]
    at (u, v) [N] (the reference's Interpolation::bilinearWithDepthBuffer):
    a neighbour contributes only if its depth is valid and not more than
    5 cm in front of ``z_expected`` [N]; the weights renormalise over the
    contributors, and a sample without one is invalid.  Returns (values
    [N], valid [N])."""
    h, w = intensity.shape
    q, idx = _neighbours((h, w), u, v)
    flat_i = intensity.reshape(h * w)
    flat_z = depth.reshape(h * w)
    flat_ok = depth_valid.reshape(h * w)
    z_eps = z_expected - DEPTH_BUFFER_M
    zero = torch.zeros((), dtype=u.dtype, device=u.device)
    val = torch.zeros_like(u)
    weight_sum = torch.zeros_like(u)
    for i, wgt in zip(idx, (q.x0w * q.y0w, q.x1w * q.y0w, q.x0w * q.y1w, q.x1w * q.y1w)):
        contributes = flat_ok[i] & (flat_z[i] > z_eps)
        wgt = torch.where(contributes, wgt, zero)
        val = val + wgt * flat_i[i]
        weight_sum = weight_sum + wgt
    valid = q.in_bounds & (weight_sum > 0.0)
    values = torch.where(valid, val / torch.clamp(weight_sum, min=1e-12), zero)
    return values, valid


def bilinear_sample_image(img, u, v):
    """Plain bilinear sample of a single-channel image [H, W] at (u, v)
    [N]; out-of-bounds samples are 0 and invalid.  Returns (values [N],
    valid [N])."""
    accel = img[..., None]
    padded = torch.cat(
        [accel] * 6 + [torch.ones_like(accel), torch.zeros_like(accel)], dim=-1
    )
    values, _ = bilinear_sample_accel(padded, u, v)
    h, w = img.shape
    in_bounds = (u >= 0.0) & (u < w - 1) & (v >= 0.0) & (v < h - 1)
    return torch.where(in_bounds, values[:, 0], torch.zeros_like(u)), in_bounds
