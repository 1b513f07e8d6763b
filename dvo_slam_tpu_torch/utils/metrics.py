"""Research metrics from the reference's experiment tooling (the port's
copy of ``dvo_slam_tpu.utils.metrics``).

Parity for dvo_benchmark/src/experiment.cpp: the frustum-overlap measure
between two camera poses (:22-61) and the Jensen-Bregman LogDet matrix
divergence (:125-129) used to compare information matrices/covariances.
"""

from __future__ import annotations

import numpy as np


def frustum_overlap(
    pose_a: np.ndarray,
    pose_b: np.ndarray,
    intrinsics,
    shape,
    depth_range=(0.4, 5.0),
    samples_per_axis: int = 8,
) -> float:
    """Fraction of camera A's viewing frustum visible from camera B.

    Monte-Carlo-free version of the reference's frustum-overlap metric
    (experiment.cpp:22-61): sample a regular grid in A's frustum
    (pixel x pixel x depth), transform into B, and count the fraction
    that projects inside B's image with positive depth.
    """
    h, w = shape
    us = np.linspace(0, w - 1, samples_per_axis)
    vs = np.linspace(0, h - 1, samples_per_axis)
    zs = np.linspace(depth_range[0], depth_range[1], samples_per_axis)
    uu, vv, zz = np.meshgrid(us, vs, zs)
    x = (uu - intrinsics.ox) / intrinsics.fx * zz
    y = (vv - intrinsics.oy) / intrinsics.fy * zz
    pts_a = np.stack([x, y, zz], axis=-1).reshape(-1, 3)

    rel = np.linalg.inv(np.asarray(pose_b)) @ np.asarray(pose_a)
    pts_b = pts_a @ rel[:3, :3].T + rel[:3, 3]
    z = pts_b[:, 2]
    ok = z > 1e-6
    u = np.where(ok, pts_b[:, 0] / np.maximum(z, 1e-6) * intrinsics.fx + intrinsics.ox, -1)
    v = np.where(ok, pts_b[:, 1] / np.maximum(z, 1e-6) * intrinsics.fy + intrinsics.oy, -1)
    inside = ok & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    return float(inside.mean())


def jensen_bregman_logdet(A: np.ndarray, B: np.ndarray) -> float:
    """Jensen-Bregman LogDet divergence between SPD matrices:
    log det((A+B)/2) - 0.5 log det(A B)   (experiment.cpp:125-129)."""
    A = np.asarray(A, np.float64)
    B = np.asarray(B, np.float64)
    s1, ld_mid = np.linalg.slogdet(0.5 * (A + B))
    s2, ld_a = np.linalg.slogdet(A)
    s3, ld_b = np.linalg.slogdet(B)
    if min(s1, s2, s3) <= 0:
        return float("inf")
    return float(ld_mid - 0.5 * (ld_a + ld_b))
