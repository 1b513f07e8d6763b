"""Image warping, normals and error images (port of
``dvo_slam_tpu.ops.warp``): the inverse intensity warp (plain or
depth-buffered), the forward depth and intensity warps with a z-buffer,
the footprint-splat forward depth warp, surface normals and the intensity
error image.

Dense [H, W] operations on the tensors' device, used by the viewers and
for debugging, never inside the solver loop.  The scatter-min of the
forward warps is ``scatter_reduce(..., "amin")``; the transformed points
round as the modular path's do (``residuals.transform_points``).
"""

from __future__ import annotations

import torch

from .camera import Intrinsics, unproject
from .interp import bilinear_sample_accel, bilinear_with_depth_buffer
from .pyramid import PyramidLevel, build_acceleration
from .residuals import transform_points


def _scatter_min(n: int, idx, values):
    """A z-buffer [n] of +inf with ``values`` scattered in by minimum."""
    zbuf = torch.full((n,), float("inf"), dtype=values.dtype, device=values.device)
    return zbuf.scatter_reduce(0, idx, values, reduce="amin")


def _safe(z):
    return torch.where(z.abs() > 1e-12, z, torch.full_like(z, 1e-12))


def warp_intensity_inverse(
    ref_depth, ref_valid, cur_level: PyramidLevel, intrinsics: Intrinsics, T,
    use_depth_buffer: bool = True,
):
    """Pull the current frame's intensity back into the reference view:
    each reference pixel with valid depth is transformed by T, projected,
    and the current intensity sampled there, depth-buffered against the
    transformed depth by default (neighbours more than 5 cm in front are
    left out).  Returns (warped [H, W], valid [H, W])."""
    h, w = ref_depth.shape
    n = h * w
    _, p = transform_points(ref_depth, intrinsics, T)
    z = torch.clamp(p[:, 2], min=1e-12)
    u = p[:, 0] / z * intrinsics.fx + intrinsics.ox
    v = p[:, 1] / z * intrinsics.fy + intrinsics.oy
    if use_depth_buffer:
        values, ok = bilinear_with_depth_buffer(
            cur_level.intensity, cur_level.depth, cur_level.valid, u, v, p[:, 2]
        )
    else:
        sampled, ok = bilinear_sample_accel(build_acceleration(cur_level), u, v)
        values = sampled[:, 0]
    valid = ref_valid.reshape(n) & ok & (p[:, 2] > 1e-12)
    warped = torch.where(valid, values, torch.zeros_like(values))
    return warped.reshape(h, w), valid.reshape(h, w)


def warp_depth_forward(depth, valid, intrinsics: Intrinsics, T):
    """Push the reference depth into the target view: nearest-pixel splat
    of the transformed z, collisions resolved by the nearest depth.
    Returns (depth [H, W], valid [H, W]); pixels nothing hits are
    invalid."""
    h, w = depth.shape
    n = h * w
    _, p = transform_points(depth, intrinsics, T)
    z = p[:, 2]
    z_safe = torch.clamp(z, min=1e-12)
    u = torch.round(p[:, 0] / z_safe * intrinsics.fx + intrinsics.ox).to(torch.int32)
    v = torch.round(p[:, 1] / z_safe * intrinsics.fy + intrinsics.oy).to(torch.int32)
    ok = valid.reshape(n) & (z > 1e-12) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    flat_idx = torch.where(ok, v * w + u, torch.zeros_like(u)).to(torch.int64)
    zbuf = _scatter_min(n, flat_idx, torch.where(ok, z, torch.full_like(z, float("inf"))))
    out_valid = torch.isfinite(zbuf)
    return (torch.where(out_valid, zbuf, torch.zeros_like(zbuf)).reshape(h, w),
            out_valid.reshape(h, w))


def warp_intensity_forward(intensity, depth, valid, intrinsics: Intrinsics, T):
    """Push the reference intensity into the target view: each pixel with
    valid depth writes its intensity at the floor pixel of its projection;
    collisions resolve by the nearest depth (a z-buffer pass, then the
    winners write).  Returns (intensity [H, W], valid [H, W])."""
    h, w = depth.shape
    n = h * w
    _, p = transform_points(depth, intrinsics, T)
    z = p[:, 2]
    z_safe = _safe(z)
    u = torch.floor(p[:, 0] / z_safe * intrinsics.fx + intrinsics.ox).to(torch.int32)
    v = torch.floor(p[:, 1] / z_safe * intrinsics.fy + intrinsics.oy).to(torch.int32)
    ok = (
        valid.reshape(n) & (depth.reshape(n) > 1e-6) & (z > 1e-12)
        & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    )
    idx = torch.where(ok, v * w + u, torch.zeros_like(u)).to(torch.int64)
    zbuf = _scatter_min(n, idx, torch.where(ok, z, torch.full_like(z, float("inf"))))
    # second pass: the winning source writes its intensity
    wins = ok & (z <= zbuf[idx])
    flat_i = intensity.reshape(n)
    out = torch.zeros(n, dtype=intensity.dtype, device=intensity.device).scatter_reduce(
        0, torch.where(wins, idx, torch.zeros_like(idx)),
        torch.where(wins, flat_i, torch.zeros_like(flat_i)), reduce="amax",
    )
    out_valid = torch.isfinite(zbuf)
    return (torch.where(out_valid, out, torch.zeros_like(out)).reshape(h, w),
            out_valid.reshape(h, w))


def warp_depth_forward_advanced(depth, valid, intrinsics: Intrinsics, T, max_footprint: int = 4):
    """Footprint-splat forward depth warp (the reference's
    warpDepthForwardAdvanced): each source pixel fills an x_length by
    y_length rectangle at the floor pixel of its projection with the
    scatter-min of the transformed z, the lengths coming from the
    rotation's pixel stretch

      x_length = ceil(r00 + r01 fx/fy + (-r20 - r21 fx/fy) x/z) + 1
      y_length = ceil(r11 + r10 fy/fx + (-r21 - r20 fy/fx) y/z) + 1,

    as ``max_footprint``^2 masked scatter-min passes (exact for lengths up
    to ``max_footprint``).  Returns (depth [H, W], valid [H, W])."""
    h, w = depth.shape
    n = h * w
    points, p = transform_points(depth, intrinsics, T)
    R = T[:3, :3].to(depth.dtype)
    z_t_safe = _safe(p[:, 2])

    fx_fy = intrinsics.fx / intrinsics.fy
    fy_fx = intrinsics.fy / intrinsics.fx
    z_factor1 = R[0, 0] + R[0, 1] * fx_fy
    x_factor1 = -R[2, 0] - R[2, 1] * fx_fy
    z_factor2 = R[1, 1] + R[1, 0] * fy_fx
    y_factor2 = -R[2, 1] - R[2, 0] * fy_fx

    z_src_safe = _safe(points[:, 2])
    x_len = torch.ceil(z_factor1 + x_factor1 * points[:, 0] / z_src_safe) + 1.0
    y_len = torch.ceil(z_factor2 + y_factor2 * points[:, 1] / z_src_safe) + 1.0

    u0 = torch.floor(p[:, 0] / z_t_safe * intrinsics.fx + intrinsics.ox).to(torch.int32)
    v0 = torch.floor(p[:, 1] / z_t_safe * intrinsics.fy + intrinsics.oy).to(torch.int32)
    src_ok = valid.reshape(n)
    inf = torch.full_like(p[:, 2], float("inf"))

    zbuf = torch.full((n,), float("inf"), dtype=depth.dtype, device=depth.device)
    for dy in range(max_footprint):
        for dx in range(max_footprint):
            u = u0 + dx
            v = v0 + dy
            ok = (
                src_ok & (dx < x_len) & (dy < y_len)
                & (u >= 0) & (u < w) & (v >= 0) & (v < h)
            )
            idx = torch.where(ok, v * w + u, torch.zeros_like(u)).to(torch.int64)
            zbuf = zbuf.scatter_reduce(0, idx, torch.where(ok, p[:, 2], inf), reduce="amin")
    out_valid = torch.isfinite(zbuf)
    return (torch.where(out_valid, zbuf, torch.zeros_like(zbuf)).reshape(h, w),
            out_valid.reshape(h, w))


def _edge_pad(x, dim: int):
    """``x`` with its first and last slices along ``dim`` repeated once."""
    first = x.narrow(dim, 0, 1)
    last = x.narrow(dim, x.shape[dim] - 1, 1)
    return torch.cat([first, x, last], dim=dim)


def compute_normals(depth, valid, intrinsics: Intrinsics):
    """Per-pixel unit surface normals from the cross product of the point
    cloud's central differences.  Returns (normals [H, W, 3], valid
    [H, W])."""
    pts = unproject(depth, intrinsics)
    dx = _edge_pad(pts, 1)
    dy = _edge_pad(pts, 0)
    tx = 0.5 * (dx[:, 2:] - dx[:, :-2])
    ty = 0.5 * (dy[2:, :] - dy[:-2, :])
    nrm = torch.linalg.cross(tx, ty, dim=-1)
    length = torch.sqrt(torch.sum(nrm * nrm, dim=-1, keepdim=True))
    vx = _edge_pad(valid, 1)
    vy = _edge_pad(valid, 0)
    ok = valid & vx[:, 2:] & vx[:, :-2] & vy[2:, :] & vy[:-2, :] & (length[..., 0] > 1e-12)
    normals = nrm / torch.clamp(length, min=1e-12)
    return torch.where(ok.unsqueeze(-1), normals, torch.zeros_like(normals)), ok


def intensity_error_image(ref_level: PyramidLevel, cur_level: PyramidLevel,
                          intrinsics: Intrinsics, T):
    """|I_cur(warp(x)) - I_ref(x)| in the reference view, zero where the
    depth-buffered inverse warp is invalid.  Returns (error [H, W], valid
    [H, W])."""
    warped, valid = warp_intensity_inverse(
        ref_level.depth, ref_level.valid, cur_level, intrinsics, T
    )
    err = (warped - ref_level.intensity).abs()
    return torch.where(valid, err, torch.zeros_like(err)), valid
