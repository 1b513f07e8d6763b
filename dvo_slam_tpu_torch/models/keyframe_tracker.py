"""KeyframeTracker: the top-level SLAM facade and keyframe policy (port of
``dvo_slam_tpu.models.keyframe_tracker``).

The reference KeyframeTracker (dvo_slam/src/keyframe_tracker.cpp): it
wires the LocalTracker's accept vote to the keyframe-switch criteria and
feeds completed local maps to the KeyframeGraph back end.  Frames live on
the tracker's device, the card unless the caller names another.

Criteria (AND-combined, in the reference's registration order,
keyframe_tracker.cpp:66-71):
  1. entropy ratio vs the first frame  > min_entropy_ratio   (:105-121)
  2. divergence rejection with identity-reset                (:123-158)
  3. translational distance to keyframe < max distance       (:160-163)
  4. equation-system constraint ratio                        (:165-168)
  5. condition-number telemetry (always accepts)             (:170-195)
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from .. import default_device
from ..config import SlamConfig
from ..ops.camera import Intrinsics
from ..utils import timers
from .constraints import ConstraintProposalValidator
from .dense_tracker import TrackingResult
from .evaluation import LogLikelihoodEvaluation
from .frames import BatchedMatcher, Frame
from .keyframe_graph import KeyframeGraph, SessionMap
from .local_map import LocalMap
from .local_tracker import LocalTracker


class KeyframeTracker:
    """Keyframe-based dense SLAM: front end, policy and back end."""

    def __init__(
        self,
        intrinsics: Intrinsics,
        cfg: Optional[SlamConfig] = None,
        use_threading: Optional[bool] = None,
        graph: Optional[KeyframeGraph] = None,
        device=None,
    ):
        """``graph``: attach an existing back end instead of creating one.
        ``use_threading``: the back end on its worker thread (default: the
        graph config's ``use_multi_threading``, on).  ``device``: where
        frames and matches live, the card unless named
        (``default_device``)."""
        self.cfg = cfg or SlamConfig()
        self.intrinsics = intrinsics
        self.device = default_device(device)
        self.graph = graph if graph is not None else KeyframeGraph(
            intrinsics, self.cfg.graph, self.cfg.tracker, use_threading=use_threading
        )
        self.lt = LocalTracker(intrinsics, self.cfg.tracker, device=self.device)
        self.lt.add_map_initialized_callback(self._on_map_initialized)
        self.lt.add_map_complete_callback(self._on_map_complete)
        for criterion in (
            self._criterion_evaluation,
            self._criterion_divergence,
            self._criterion_distance,
            self._criterion_constraint_ratio,
            self._criterion_condition_number,
        ):
            self.lt.add_accept_criterion(criterion)

        self._evaluation = None
        self._last_transform_to_keyframe = np.eye(4)
        self._initial_transformation = np.eye(4)
        self._previous: Optional[Frame] = None
        self._last_frame_id: Optional[int] = None
        self.diagnostics: dict = {}

    # -- map lifecycle -----------------------------------------------------
    def _on_map_initialized(self, lt, local_map: LocalMap, r_odometry: TrackingResult):
        """Reference: keyframe_tracker.cpp:86-96."""
        self._last_transform_to_keyframe = np.asarray(r_odometry.transformation, np.float64)
        self._evaluation = LogLikelihoodEvaluation(r_odometry)

    def _on_map_complete(self, lt, local_map: LocalMap):
        """Reference: keyframe_tracker.cpp:98-103."""
        local_map.evaluation = self._evaluation
        self.graph.add(local_map)

    # -- accept criteria ---------------------------------------------------
    def _criterion_evaluation(self, lt, r_odometry, r_keyframe):
        ratio = self._evaluation.ratio_with_first(r_keyframe)
        accept = ratio > self.cfg.keyframe.min_entropy_ratio
        if accept:
            self._evaluation.add(r_keyframe)
        self.diagnostics["entropy_ratio"] = ratio
        return accept, r_odometry, r_keyframe

    def _criterion_divergence(self, lt, r_odometry, r_keyframe):
        """Divergence rejection with result rewriting (the reference's
        const_cast, keyframe_tracker.cpp:123-158): odometry reset to the
        identity with nominal information, the keyframe estimate reset to
        the last good transform to the keyframe."""
        odo_t = float(np.linalg.norm(np.asarray(r_odometry.transformation)[:3, 3]))
        kf_t = float(np.linalg.norm(np.asarray(r_keyframe.transformation)[:3, 3]))
        reject = odo_t > 0.1 or kf_t > 1.5 * self.cfg.keyframe.max_translational_distance
        if reject:
            r_odometry = r_odometry._replace(
                transformation=np.eye(4), information=np.eye(6) * (0.008 * 0.008)
            )
            r_keyframe = r_keyframe._replace(
                transformation=np.asarray(self._last_transform_to_keyframe, np.float64)
            )
        self._last_transform_to_keyframe = np.asarray(r_keyframe.transformation, np.float64)
        return not reject, r_odometry, r_keyframe

    def _criterion_distance(self, lt, r_odometry, r_keyframe):
        kf_t = float(np.linalg.norm(np.asarray(r_keyframe.transformation)[:3, 3]))
        return kf_t < self.cfg.keyframe.max_translational_distance, r_odometry, r_keyframe

    def _criterion_constraint_ratio(self, lt, r_odometry, r_keyframe):
        pixels = max(int(r_keyframe.last_level.valid_pixels), 1)
        ratio = int(r_keyframe.last_level.valid_constraints) / pixels
        self.diagnostics["constraint_ratio"] = ratio
        return (ratio > self.cfg.keyframe.min_equation_system_constraint_ratio,
                r_odometry, r_keyframe)

    def _criterion_condition_number(self, lt, r_odometry, r_keyframe):
        """Telemetry only, always accepts (keyframe_tracker.cpp:170-195)."""
        for name, r in (("odometry", r_odometry), ("keyframe", r_keyframe)):
            info = np.asarray(r.information, np.float64)
            ev = np.sort(np.abs(np.linalg.eigvalsh(info)))
            self.diagnostics[f"condition_number_{name}"] = ev[-1] / ev[0] if ev[0] > 0 else np.inf
        return True, r_odometry, r_keyframe

    # -- runtime reconfiguration (KeyframeTracker::configureTracking,
    #    -KeyframeSelection, -Mapping, keyframe_tracker.cpp:333-352) -------
    def configure_tracking(self, tracker_cfg):
        """Swap the dense-tracking config: new matchers for the front end
        and a new validator for the back end (after draining its queue, as
        the reference locks reconfiguration against the running tracker,
        camera_dense_tracking.cpp:135-156)."""
        self.graph.wait_for_queue()
        self.cfg = dataclasses.replace(self.cfg, tracker=tracker_cfg)
        self.lt.cfg = tracker_cfg
        self.lt.matcher = BatchedMatcher(tracker_cfg, self.intrinsics)
        self.graph.tracker_cfg = tracker_cfg
        self.graph.validator = ConstraintProposalValidator(
            self.intrinsics, self.graph.cfg, tracker_cfg
        )

    def configure_keyframe_selection(self, keyframe_cfg):
        self.cfg = dataclasses.replace(self.cfg, keyframe=keyframe_cfg)

    def configure_mapping(self, graph_cfg):
        self.graph.wait_for_queue()
        self.cfg = dataclasses.replace(self.cfg, graph=graph_cfg)
        self.graph.cfg = graph_cfg
        self.graph.validator = ConstraintProposalValidator(
            self.intrinsics, graph_cfg, self.graph.tracker_cfg
        )

    # -- public API (keyframe_tracker.h:36-66) -----------------------------
    def init(self, initial_transformation: Optional[np.ndarray] = None):
        self._initial_transformation = (
            np.eye(4) if initial_transformation is None else np.asarray(initial_transformation)
        )

    def make_frame(self, intensity, depth, valid, timestamp: float) -> Frame:
        return Frame.from_arrays(intensity, depth, valid, timestamp, self.cfg.tracker.num_levels,
                                 device=self.device)

    def make_frame_raw(self, intensity_u8, depth_u16, timestamp: float) -> Frame:
        """Live-camera ingest: raw u8/u16 arrays, converted on the device,
        with the solver artifacts prepared for the tracker's first match
        (the reference's per-frame handleImages path,
        camera_dense_tracking.cpp:187-309)."""
        return Frame.from_raw(
            intensity_u8, depth_u16, timestamp, self.cfg.tracker.num_levels,
            prepare_for=(self.cfg.tracker, self.intrinsics), device=self.device,
        )

    def update(self, frame: Frame) -> np.ndarray:
        """Track one frame; returns its absolute pose
        (keyframe_tracker.cpp:227-246).  Span ``dvo.kf.update``, with the
        frame's id."""
        self._last_frame_id = frame.frame_id
        with timers.span("dvo.kf.update", frame=frame.frame_id):
            if self._previous is None:
                self._previous = frame
                return self._initial_transformation
            if self.lt.local_map is None:
                self.lt.init_new_local_map(self._previous, frame, self._initial_transformation)
                return self.lt.local_map.current_frame_pose()
            return self.lt.update(frame)

    def force_keyframe(self):
        self.lt.force_complete_current_local_map()

    def finish(self):
        """Flush the current local map and run the final optimization
        (keyframe_tracker.cpp:248-251 and the benchmark driver's
        forceKeyframe on the last frame, benchmark_slam.cpp:477-481); its
        span carries the last tracked frame's id."""
        if self.lt.local_map is not None and self.lt.local_map.num_frames > 0:
            self._on_map_complete(self.lt, self.lt.local_map)
            self.lt.local_map = None
        self.graph.final_optimization(frame=self._last_frame_id)

    def end_session(self) -> SessionMap:
        """End the session (the batch program's end, benchmark_slam.cpp:
        477-484): ``finish``, the optimised map to the host in one piece
        (``KeyframeGraph.session_map``), and the back end's worker joined,
        also when the final pass raises.  The tracker takes no frame after
        it; a new session takes a new tracker."""
        try:
            self.finish()
            return self.graph.session_map()
        finally:
            self.graph.shutdown()

    def trajectory(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.graph.trajectory()
