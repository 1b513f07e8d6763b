"""Synthetic RGB-D scenes, camera paths and the renderer of the benchmark's
frames: a frozen copy of ``dvo_slam_tpu_torch/utils/synthetic.py``
(``render_frame``, the scenes, ``circular_trajectory``) and of
``dvo_slam_tpu_torch/odometry.py``'s ``render_sequence``, so that the
yardstick's inputs stay what they are when the program changes.  It imports
nothing of the program; ``intrinsics`` is any object with ``fx``, ``fy``,
``ox``, ``oy``.

Every frame is an exact pinhole rendering of procedurally textured planes
(a slanted wall, a floor and, in the occluded scene, a finite foreground
slab), so frames and their ground-truth poses come from numbers alone.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np



class Plane(NamedTuple):
    point: np.ndarray  # [3] a point on the plane (world)
    normal: np.ndarray  # [3] unit normal (world)
    axis_u: np.ndarray  # [3] in-plane texture u axis
    axis_v: np.ndarray  # [3] in-plane texture v axis
    phase: float  # texture phase offset, decorrelates the two planes
    extent: Tuple[float, float] | None = None  # (half_u, half_v); None = infinite


def _texture(u: np.ndarray, v: np.ndarray, phase: float) -> np.ndarray:
    """Smooth multi-frequency texture in [0, 255]."""
    val = (
        0.50 * np.sin(2.3 * u + 1.7 * v + phase)
        + 0.30 * np.sin(6.1 * u - 4.3 * v + 2.0 * phase)
        + 0.15 * np.sin(12.7 * u + 9.1 * v + 1.1)
        + 0.05 * np.sin(25.3 * u - 17.9 * v + 2.7)
    )
    return (val * 0.5 + 0.5) * 255.0


def default_scene() -> List[Plane]:
    """A wall ~2.4 m ahead slanted toward the camera, plus a floor."""
    wall = Plane(
        point=np.array([0.0, 0.0, 2.4]),
        normal=_unit(np.array([0.25, 0.1, -1.0])),
        axis_u=_unit(np.array([1.0, 0.0, 0.25])),
        axis_v=_unit(np.array([0.0, 1.0, 0.1])),
        phase=0.0,
    )
    floor = Plane(
        point=np.array([0.0, 0.9, 0.0]),
        normal=_unit(np.array([0.0, -1.0, 0.02])),
        axis_u=_unit(np.array([1.0, 0.0, 0.0])),
        axis_v=_unit(np.array([0.0, 0.02, 1.0])),
        phase=1.3,
    )
    return [wall, floor]


def _unit(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


def occluded_scene() -> List[Plane]:
    """default_scene plus a finite foreground slab ~1.1 m ahead.

    The slab's silhouette cuts a >1 m depth discontinuity through the
    image, so warped samples cross occlusion edges: this is the scene that
    makes the occlusion gate (residuals.py) and the 5 cm depth-buffered
    interpolation (interpolation.cpp:55-110) observable — the reference's
    real-world stressor that two infinite planes can never produce.
    """
    slab = Plane(
        point=np.array([0.12, -0.05, 1.1]),
        normal=_unit(np.array([-0.1, 0.05, -1.0])),
        axis_u=_unit(np.array([1.0, 0.0, -0.1])),
        axis_v=_unit(np.array([0.0, 1.0, 0.05])),
        phase=2.6,
        extent=(0.28, 0.22),
    )
    return default_scene() + [slab]


def render_frame(
    pose_wc: np.ndarray,
    intrinsics,
    shape: Tuple[int, int],
    scene: Sequence[Plane] | None = None,
    depth_noise: float = 0.0,
    intensity_noise: float = 0.0,
    invalid_fraction: float = 0.0,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Render (intensity [H,W], depth [H,W], valid [H,W]) from camera pose
    ``pose_wc`` (camera-to-world).  Depth is the camera-frame z of the
    nearest plane hit; pixels whose rays miss every plane are invalid."""
    scene = default_scene() if scene is None else scene
    h, w = shape
    u = np.arange(w, dtype=np.float64)[None, :].repeat(h, axis=0)
    v = np.arange(h, dtype=np.float64)[:, None].repeat(w, axis=1)
    rays_cam = np.stack(
        [
            (u - intrinsics.ox) / intrinsics.fx,
            (v - intrinsics.oy) / intrinsics.fy,
            np.ones_like(u),
        ],
        axis=-1,
    )  # camera-frame rays with z = 1 so the hit parameter IS the depth
    R = pose_wc[:3, :3]
    c = pose_wc[:3, 3]
    rays_world = rays_cam @ R.T

    best_depth = np.full((h, w), np.inf)
    intensity = np.zeros((h, w))
    for plane in scene:
        denom = rays_world @ plane.normal
        num = (plane.point - c) @ plane.normal
        with np.errstate(divide="ignore", invalid="ignore"):
            t = num / denom
        hit = (denom < -1e-9) | (denom > 1e-9)
        hit &= t > 0.05
        pts = c + t[..., None] * rays_world
        tex_u = (pts - plane.point) @ plane.axis_u
        tex_v = (pts - plane.point) @ plane.axis_v
        if plane.extent is not None:
            hit &= (np.abs(tex_u) <= plane.extent[0]) & (
                np.abs(tex_v) <= plane.extent[1]
            )
        closer = hit & (t < best_depth)
        tex = _texture(tex_u, tex_v, plane.phase)
        intensity = np.where(closer, tex, intensity)
        best_depth = np.where(closer, t, best_depth)

    valid = np.isfinite(best_depth)
    depth = np.where(valid, best_depth, 0.0)

    rng = np.random.default_rng(seed)
    if intensity_noise > 0:
        intensity = intensity + rng.normal(0.0, intensity_noise, intensity.shape)
        intensity = np.clip(intensity, 0.0, 255.0)
    if depth_noise > 0:
        depth = np.where(valid, depth + rng.normal(0.0, depth_noise, depth.shape), 0.0)
    if invalid_fraction > 0:
        drop = rng.random(depth.shape) < invalid_fraction
        valid = valid & ~drop
        depth = np.where(valid, depth, 0.0)

    return (
        intensity.astype(np.float32),
        depth.astype(np.float32),
        valid,
    )


def circular_trajectory(
    num_frames: int,
    radius: float = 0.05,
    rot_amplitude: float = 0.02,
    z_amplitude: float = 0.02,
) -> np.ndarray:
    """Smooth looping camera path (camera-to-world poses [N, 4, 4]).

    Small-motion loop so consecutive frames overlap heavily (mimicking a
    30 Hz handheld camera) while the full loop closes — exercising both
    odometry and loop-closure code paths.
    """
    poses = []
    for i in range(num_frames):
        a = 2.0 * np.pi * i / max(num_frames, 1)
        t = np.array(
            [radius * np.cos(a), radius * np.sin(a), z_amplitude * np.sin(2 * a)]
        )
        rot = np.array(
            [
                rot_amplitude * np.sin(a),
                rot_amplitude * np.cos(a),
                0.5 * rot_amplitude * np.sin(2 * a),
            ]
        )
        poses.append(_pose_from_rt(rot, t))
    return np.asarray(poses)


def _pose_from_rt(rotvec: np.ndarray, t: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(rotvec)
    if theta < 1e-12:
        R = np.eye(3)
    else:
        k = rotvec / theta
        K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        R = np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * K @ K
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def render_sequence(poses, shape, intrinsics, scene=None, seed0=0):
    """Camera-format frames along ``poses``: u8 intensity and u16 depth
    [N, H, W] (1/5000 m, 0 invalid) with sensor noise drawn from seed
    ``seed0 + i`` for frame i (the copy of the program's
    ``odometry.render_sequence``, one thread)."""
    n = len(poses)
    intensity_u8 = np.zeros((n,) + tuple(shape), np.uint8)
    depth_u16 = np.zeros((n,) + tuple(shape), np.uint16)
    for i in range(n):
        intensity, depth, valid = render_frame(
            poses[i], intrinsics, shape, scene=scene, seed=seed0 + i,
            depth_noise=0.002, intensity_noise=1.0,
        )
        intensity_u8[i] = np.clip(intensity, 0, 255).astype(np.uint8)
        depth_u16[i] = np.where(valid, depth * 5000.0, 0).astype(np.uint16)
    return intensity_u8, depth_u16


SCENES = {"default": default_scene, "occluded": occluded_scene}


def render_frames_torch(poses, intrinsics, shape, planes, device, chunk: int = 16):
    """``render_frame`` without noise for every pose of ``poses`` [L, 4, 4]
    at once, in float64 PyTorch on ``device``: (intensity [L, H, W]
    float32, depth [L, H, W] float32, validity [L, H, W] bool), equal to
    ``render_frame`` to float64 rounding."""
    import torch

    f64 = dict(dtype=torch.float64, device=device)
    h, w = shape
    v, u = torch.meshgrid(torch.arange(h, **f64), torch.arange(w, **f64), indexing="ij")
    rays_cam = torch.stack([(u - intrinsics.ox) / intrinsics.fx,
                            (v - intrinsics.oy) / intrinsics.fy, torch.ones_like(u)], -1)
    out_i, out_z, out_v = [], [], []
    for start in range(0, len(poses), chunk):
        P = torch.as_tensor(np.asarray(poses[start:start + chunk]), **f64)
        rays = torch.einsum("hwj,lij->lhwi", rays_cam, P[:, :3, :3])
        c = P[:, :3, 3]
        best = torch.full(rays.shape[:-1], float("inf"), **f64)
        intensity = torch.zeros(rays.shape[:-1], **f64)
        for plane in planes:
            n = torch.as_tensor(plane.normal, **f64)
            p0 = torch.as_tensor(plane.point, **f64)
            denom = rays @ n
            num = (p0 - c) @ n
            hit = (denom < -1e-9) | (denom > 1e-9)
            t = num[:, None, None] / torch.where(hit, denom, torch.ones_like(denom))
            hit &= t > 0.05
            rel = c[:, None, None, :] + t[..., None] * rays - p0
            tex_u = rel @ torch.as_tensor(plane.axis_u, **f64)
            tex_v = rel @ torch.as_tensor(plane.axis_v, **f64)
            if plane.extent is not None:
                hit &= (tex_u.abs() <= plane.extent[0]) & (tex_v.abs() <= plane.extent[1])
            closer = hit & (t < best)
            phase = plane.phase
            tex = (0.50 * torch.sin(2.3 * tex_u + 1.7 * tex_v + phase)
                   + 0.30 * torch.sin(6.1 * tex_u - 4.3 * tex_v + 2.0 * phase)
                   + 0.15 * torch.sin(12.7 * tex_u + 9.1 * tex_v + 1.1)
                   + 0.05 * torch.sin(25.3 * tex_u - 17.9 * tex_v + 2.7))
            intensity = torch.where(closer, (tex * 0.5 + 0.5) * 255.0, intensity)
            best = torch.where(closer, t, best)
        valid = torch.isfinite(best)
        out_i.append(intensity.to(torch.float32))
        out_z.append(torch.where(valid, best, torch.zeros_like(best)).to(torch.float32))
        out_v.append(valid)
    return torch.cat(out_i), torch.cat(out_z), torch.cat(out_v)
