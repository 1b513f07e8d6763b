"""Trajectory evaluation: ATE-RMSE after rigid alignment, the TUM
benchmark's accuracy metric (the port's copy of the metric functions of
``dvo_slam_tpu.utils.trajectory``).  Host-side NumPy."""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["associate_trajectories", "ate_rmse", "umeyama_alignment"]


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
