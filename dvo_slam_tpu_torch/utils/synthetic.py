"""Synthetic RGB-D sequence generation with exact ground truth (a NumPy
copy of ``dvo_slam_tpu.utils.synthetic`` that takes the port's
``Intrinsics``, so the port renders its test and benchmark frames without
importing the JAX package; the parity tests hold the two bit-equal).

Every frame is an exact pinhole rendering of the same procedurally
textured world surfaces, so a tracker's estimate can be gated against
exact SE(3) ground truth.

Scene: two slanted textured planes (a "wall" and a "floor"), each an exact
ray-plane intersection — no meshes, no rasterization, fully vectorized
NumPy.  Texture is a band-limited multi-frequency sinusoid mix: smooth
enough for gradient-based alignment, rich enough to constrain all 6 DoF.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np

from ..ops.camera import Intrinsics


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
    intrinsics: Intrinsics,
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


def linear_trajectory(num_frames: int, step: np.ndarray, rot_step: np.ndarray) -> np.ndarray:
    """Constant-velocity camera path."""
    poses = []
    for i in range(num_frames):
        poses.append(_pose_from_rt(np.asarray(rot_step) * i, np.asarray(step) * i))
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
