"""Online frame-to-frame visual odometry, no keyframes (port of
``dvo_slam_tpu.models.camera_tracker``).

The reference's CameraDenseTracker ROS node
(dvo_ros/src/camera_dense_tracking.cpp): maintains a reference frame,
matches each incoming frame against it, accumulates the global transform,
and on tracking failure keeps the old reference and counts frames since
the last success (camera_dense_tracking.cpp:269-298).  ROS pub/sub is
replaced by plain return values and an optional callback.  Frames are
built on ``device``, the card unless the caller names another.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from .. import default_device
from ..config import TrackerConfig
from ..ops.camera import Intrinsics
from ..utils import timers
from .dense_tracker import TrackingResult
from .frames import BatchedMatcher, Frame
from .local_tracker import result_is_nan


class CameraTracker:
    """Streaming frame-to-frame odometry with failure handling."""

    def __init__(
        self,
        intrinsics: Intrinsics,
        cfg: Optional[TrackerConfig] = None,
        pose_callback: Optional[Callable[[float, np.ndarray, np.ndarray], None]] = None,
        device=None,
    ):
        self.cfg = cfg or TrackerConfig()
        self.intrinsics = intrinsics
        self.device = default_device(device)
        self.matcher = BatchedMatcher(self.cfg, intrinsics)
        self.pose_callback = pose_callback
        self.reset()

    def reset(self, initial_pose: Optional[np.ndarray] = None):
        """Reference: reset on init / resolution change
        (camera_dense_tracking.cpp:87-106)."""
        self.reference: Optional[Frame] = None
        self.pose = np.eye(4) if initial_pose is None else np.asarray(initial_pose)
        self.frames_since_last_success = 0
        self.last_result: Optional[TrackingResult] = None

    def make_frame(self, intensity, depth, valid, timestamp: float) -> Frame:
        return Frame.from_arrays(
            intensity, depth, valid, timestamp, self.cfg.num_levels, device=self.device
        )

    def make_frame_raw(self, intensity_u8, depth_u16, timestamp: float) -> Frame:
        """Live-camera ingest: raw u8/u16 converted on the device, solver
        artifacts prepared with the pyramid, so that update() finds them."""
        return Frame.from_raw(
            intensity_u8, depth_u16, timestamp, self.cfg.num_levels,
            prepare_for=(self.cfg, self.intrinsics), device=self.device,
        )

    def update(self, frame: Frame) -> np.ndarray:
        """Track one frame; returns the accumulated world pose
        (camera_dense_tracking.cpp:187-309).  Span: ``dvo.update``, of the
        frame's ``frame_id``."""
        with timers.span("dvo.update", frame=frame.frame_id):
            return self._update(frame)

    def _update(self, frame: Frame) -> np.ndarray:
        if self.reference is None:
            self.reference = frame
            self._publish(frame.timestamp)
            return self.pose

        init = None
        if self.cfg.use_initial_estimate and self.last_result is not None:
            init = np.asarray(self.last_result.transformation, np.float64)

        result = self.matcher.match(self.reference, frame, init)
        if result_is_nan(result):
            # keep the old reference, count the failure
            # (camera_dense_tracking.cpp:293-298)
            self.frames_since_last_success += 1
            self._publish(frame.timestamp)
            return self.pose

        self.frames_since_last_success = 0
        self.last_result = result
        self.pose = self.pose @ np.asarray(result.transformation, np.float64)
        self.reference = frame
        self._publish(frame.timestamp, result)
        return self.pose

    def covariance(self) -> np.ndarray:
        """6x6 pose covariance from the last information matrix (the
        PoseWithCovarianceStamped payload, camera_dense_tracking.cpp:311-345)."""
        if self.last_result is None:
            return np.eye(6)
        info = np.asarray(self.last_result.information, np.float64)
        try:
            return np.linalg.inv(info)
        except np.linalg.LinAlgError:
            return np.full((6, 6), np.inf)

    def _publish(self, timestamp: float, result: Optional[TrackingResult] = None):
        if self.pose_callback is not None:
            self.pose_callback(timestamp, self.pose.copy(), self.covariance())
