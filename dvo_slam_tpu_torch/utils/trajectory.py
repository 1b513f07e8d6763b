"""Trajectory evaluation: ATE-RMSE after rigid alignment, the TUM
benchmark's accuracy metric.  Re-exported from
``dvo_slam_tpu.utils.trajectory``, which imports only NumPy."""

from dvo_slam_tpu.utils.trajectory import (
    associate_trajectories,
    ate_rmse,
    umeyama_alignment,
)

__all__ = ["associate_trajectories", "ate_rmse", "umeyama_alignment"]
