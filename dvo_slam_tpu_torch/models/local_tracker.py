"""LocalTracker: per-frame dual registration and local-map lifecycle
(port of ``dvo_slam_tpu.models.local_tracker``).

The reference LocalTracker (dvo_slam/src/local_tracker.cpp): every
incoming frame is aligned simultaneously against the current keyframe and
against the last frame.  The reference runs the two DenseTracker::match
calls on TBB threads (local_tracker.cpp:180-185); here they are two
streams of one lockstep solve (``BatchedMatcher.match_many``, the batched
folded kernel on the card), read back once.

Accept/reject of the combined vote decides whether the frame extends the
current LocalMap or completes it and seeds a new one from the last frame
(local_tracker.cpp:192-213).
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from .. import default_device
from ..config import TrackerConfig
from ..ops.camera import Intrinsics
from ..utils import timers
from .dense_tracker import TrackingResult
from .frames import BatchedMatcher, Frame
from .local_map import LocalMap

# An accept criterion: (local_tracker, r_odometry, r_keyframe) -> bool.
# Criteria may replace result fields via returned overrides (the cleaned-up
# version of the reference's const_cast mutation, keyframe_tracker.cpp:137-153).
AcceptCriterion = Callable[["LocalTracker", TrackingResult, TrackingResult], bool]


def result_is_nan(r: TrackingResult) -> bool:
    return bool(np.isnan(np.asarray(r.transformation)).any())


class LocalTracker:
    """Dual-registration front end over batched dense alignment.  Frames
    must live on ``device``: the card unless the caller names another
    (``default_device``)."""

    def __init__(
        self, intrinsics: Intrinsics, cfg: Optional[TrackerConfig] = None, device=None
    ):
        self.cfg = cfg or TrackerConfig()
        self.intrinsics = intrinsics
        self.device = default_device(device)
        self.matcher = BatchedMatcher(self.cfg, intrinsics)
        self.local_map: Optional[LocalMap] = None
        self.last_keyframe_pose = np.eye(4)
        self._last_frame: Optional[Frame] = None
        self._force = False
        self.accept_criteria: List[AcceptCriterion] = []
        self.map_initialized_callbacks: List[Callable] = []
        self.map_complete_callbacks: List[Callable] = []

    # -- signals ----------------------------------------------------------
    def add_accept_criterion(self, c: AcceptCriterion):
        self.accept_criteria.append(c)

    def add_map_initialized_callback(self, c: Callable):
        self.map_initialized_callbacks.append(c)

    def add_map_complete_callback(self, c: Callable):
        self.map_complete_callbacks.append(c)

    def force_complete_current_local_map(self):
        """Reference: LocalTracker::forceCompleteCurrentLocalMap."""
        self._force = True

    def _check_device(self, *frames: Frame):
        for frame in frames:
            device = frame.levels[self.cfg.first_level].intensity.device
            if device != self.device:
                raise ValueError(f"frame on {device}, the tracker runs on {self.device}")

    # -- lifecycle --------------------------------------------------------
    def init_new_local_map(
        self,
        keyframe: Frame,
        frame: Frame,
        keyframe_pose: np.ndarray,
        r_odometry: Optional[TrackingResult] = None,
    ):
        """Start the first local map (local_tracker.cpp:127-155)."""
        self._check_device(keyframe, frame)
        if r_odometry is None:
            r_odometry = self.matcher.match(keyframe, frame, None)
        self.last_keyframe_pose = np.asarray(r_odometry.transformation, np.float64)
        self._init_map(keyframe, frame, r_odometry, keyframe_pose)

    def _init_map(
        self,
        keyframe: Frame,
        frame: Frame,
        r_odometry: TrackingResult,
        keyframe_pose: np.ndarray,
    ):
        transformation = np.asarray(r_odometry.transformation, np.float64)
        information = np.asarray(r_odometry.information, np.float64)
        if not np.isfinite(transformation).all():
            # NaN in map initialization -> identity reset
            # (local_tracker.cpp:141-148)
            transformation = np.eye(4)
            information = np.eye(6)
        self.local_map = LocalMap.create(keyframe, keyframe_pose)
        self.local_map.add_frame(frame)
        self.local_map.add_keyframe_measurement(transformation, information)
        self._last_frame = frame
        for cb in self.map_initialized_callbacks:
            cb(self, self.local_map, r_odometry)

    def update(self, frame: Frame) -> np.ndarray:
        """Track one frame; returns its absolute pose estimate
        (local_tracker.cpp:157-216)."""
        assert self.local_map is not None, "call init_new_local_map first"
        self._check_device(frame)

        # dual alignment as batch of 2: [keyframe-match, odometry-match].
        # The reference passes last_keyframe_pose^{-1} into the init slot,
        # which match() consumes as the first warp increment
        # (local_tracker.cpp:174); the pose-space API inverts internally, so
        # the equivalent pose-space init is the previous keyframe pose.
        with timers.span("dvo.kf.dual_match"):
            r_keyframe, r_odometry = self.matcher.match_many(
                [
                    (
                        self.local_map.keyframe,
                        frame,
                        self.last_keyframe_pose if self.cfg.use_initial_estimate else None,
                    ),
                    (self._last_frame, frame, None),
                ]
            )
        with timers.span("dvo.kf.decision"):
            force = self._force or result_is_nan(r_odometry) or result_is_nan(r_keyframe)

            # collect all votes (criteria run for their side effects even when
            # forced, matching the reference's signal invocation order,
            # local_tracker.cpp:192)
            accept = True
            for criterion in self.accept_criteria:
                vote, r_odometry, r_keyframe = criterion(self, r_odometry, r_keyframe)
                accept = accept and vote

            if accept and not force:
                self.local_map.add_frame(frame)
                self.local_map.add_odometry_measurement(
                    np.asarray(r_odometry.transformation, np.float64),
                    np.asarray(r_odometry.information, np.float64),
                )
                self.local_map.add_keyframe_measurement(
                    np.asarray(r_keyframe.transformation, np.float64),
                    np.asarray(r_keyframe.information, np.float64),
                )
                self.last_keyframe_pose = np.asarray(r_keyframe.transformation, np.float64)
                self._last_frame = frame
            else:
                self._force = False
                old_map = self.local_map
                old_pose = old_map.current_frame_pose()
                new_keyframe = old_map.current_frame
                for cb in self.map_complete_callbacks:
                    cb(self, old_map)
                # the retiring keyframe leaves active tracking: release its
                # tracking-config prepared artifacts (the Frame itself stays in
                # the graph for loop-closure validation)
                self.matcher.evict(old_map.keyframe)
                self._init_map(new_keyframe, frame, r_odometry, old_pose)
                self.last_keyframe_pose = np.asarray(r_odometry.transformation, np.float64)

            return self.local_map.current_frame_pose()
