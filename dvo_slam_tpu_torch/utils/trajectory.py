"""Trajectory IO and evaluation in the TUM RGB-D benchmark format (the
port's copy of ``dvo_slam_tpu.utils.trajectory``).

TUM trajectory files (``t x y z qx qy qz qw``, the reference's
map_serializer.cpp:44-65 and benchmark_slam.cpp:490-504), and the TUM
benchmark's accuracy metrics: ATE-RMSE after rigid alignment and RPE.
Host-side NumPy."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

__all__ = [
    "associate_trajectories",
    "ate_rmse",
    "pose_to_tum_line",
    "quaternion_to_rotation",
    "read_tum_trajectory",
    "rotation_to_quaternion",
    "rpe_rmse",
    "umeyama_alignment",
    "write_tum_trajectory",
]


def rotation_to_quaternion(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (x, y, z, w), TUM component order."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2.0
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diagonal(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2.0
        q = np.zeros(4)
        q[i] = 0.25 * s
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        q[3] = (R[k, j] - R[j, k]) / s
        x, y, z, w = q
    q = np.array([x, y, z, w])
    return q / np.linalg.norm(q)


def quaternion_to_rotation(q: np.ndarray) -> np.ndarray:
    """Quaternion (x, y, z, w) -> rotation matrix."""
    x, y, z, w = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def pose_to_tum_line(timestamp: float, T: np.ndarray) -> str:
    q = rotation_to_quaternion(np.asarray(T)[:3, :3])
    t = np.asarray(T)[:3, 3]
    return (
        f"{timestamp:.6f} {t[0]:.9f} {t[1]:.9f} {t[2]:.9f} "
        f"{q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}"
    )


def write_tum_trajectory(path, timestamps: Sequence[float], poses: Sequence[np.ndarray]):
    """Write a TUM-format trajectory file, sorted by timestamp
    (the reference sorts graph vertices the same way,
    map_serializer.cpp:44-65)."""
    order = np.argsort(np.asarray(timestamps))
    with open(path, "w") as f:
        for i in order:
            f.write(pose_to_tum_line(timestamps[i], poses[i]) + "\n")


def read_tum_trajectory(path) -> Tuple[np.ndarray, np.ndarray]:
    """Read TUM trajectory/groundtruth -> (timestamps [N], poses [N, 4, 4])."""
    stamps: List[float] = []
    poses: List[np.ndarray] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(v) for v in line.split()]
            if len(vals) < 8:
                continue
            T = np.eye(4)
            T[:3, :3] = quaternion_to_rotation(np.array(vals[4:8]))
            T[:3, 3] = vals[1:4]
            stamps.append(vals[0])
            poses.append(T)
    return np.asarray(stamps), np.asarray(poses)


def associate_trajectories(
    stamps_a: np.ndarray, stamps_b: np.ndarray, max_dt: float = 0.02
) -> Tuple[np.ndarray, np.ndarray]:
    """Nearest-timestamp association (the reference's findClosestEntry,
    dvo_benchmark/include/dvo_benchmark/file_reader.h and tools.h:62-105)
    -> (indices into a, indices into b) of the pairs within ``max_dt``."""
    idx_b = np.searchsorted(stamps_b, stamps_a)
    idx_b = np.clip(idx_b, 1, len(stamps_b) - 1)
    left = stamps_b[idx_b - 1]
    right = stamps_b[idx_b]
    choose_left = (stamps_a - left) < (right - stamps_a)
    nearest = np.where(choose_left, idx_b - 1, idx_b)
    dt = np.abs(stamps_b[nearest] - stamps_a)
    keep = dt <= max_dt
    return np.nonzero(keep)[0], nearest[keep]


def umeyama_alignment(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Rigid alignment (no scale) of src -> dst point sets [N, 3] (Horn)
    -> the [4, 4] transform."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    cov = (dst - mu_d).T @ (src - mu_s) / len(src)
    u, _, vt = np.linalg.svd(cov)
    s = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s[2, 2] = -1
    R = u @ s @ vt
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = mu_d - R @ mu_s
    return T


def ate_rmse(
    est_stamps: np.ndarray,
    est_poses: np.ndarray,
    gt_stamps: np.ndarray,
    gt_poses: np.ndarray,
    max_dt: float = 0.02,
) -> float:
    """Absolute trajectory error RMSE after time association + alignment
    (the TUM benchmark's evaluate_ate); NaN with fewer than two pairs."""
    ia, ib = associate_trajectories(est_stamps, gt_stamps, max_dt)
    if len(ia) < 2:
        return float("nan")
    est = est_poses[ia][:, :3, 3]
    gt = gt_poses[ib][:, :3, 3]
    A = umeyama_alignment(est, gt)
    est_aligned = est @ A[:3, :3].T + A[:3, 3]
    err = est_aligned - gt
    return float(np.sqrt((err**2).sum(axis=1).mean()))


def rpe_rmse(
    est_stamps: np.ndarray,
    est_poses: np.ndarray,
    gt_stamps: np.ndarray,
    gt_poses: np.ndarray,
    delta: int = 1,
    max_dt: float = 0.02,
) -> Tuple[float, float]:
    """Relative pose error RMSE over a fixed frame delta
    -> (translational m, rotational rad)."""
    ia, ib = associate_trajectories(est_stamps, gt_stamps, max_dt)
    if len(ia) <= delta:
        return float("nan"), float("nan")
    est = est_poses[ia]
    gt = gt_poses[ib]
    terrs, rerrs = [], []
    for i in range(len(est) - delta):
        de = np.linalg.inv(est[i]) @ est[i + delta]
        dg = np.linalg.inv(gt[i]) @ gt[i + delta]
        e = np.linalg.inv(dg) @ de
        terrs.append(np.linalg.norm(e[:3, 3]))
        angle = np.clip((np.trace(e[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
        rerrs.append(np.arccos(angle))
    return float(np.sqrt(np.mean(np.square(terrs)))), float(
        np.sqrt(np.mean(np.square(rerrs)))
    )
