"""LocalMap: the mini pose graph covering one keyframe's lifetime (port of
``dvo_slam_tpu.models.local_map``).

The reference's g2o-backed LocalMap (dvo_slam/src/local_map.cpp):
one fixed keyframe vertex plus one vertex per tracked frame, with odometry
edges (previous -> current) and keyframe edges (keyframe -> current),
optimized when the map completes (local_map.cpp:208-213 runs 50 LM
iterations), on the CPU in float64 (``pose_graph``).

Vertex keys are small integers: 0 = keyframe, 1.. = frames in order.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..utils import timers
from .frames import Frame
from .pose_graph import PoseGraph


class LocalMap:
    """Mini pose graph for one keyframe's lifetime."""

    def __init__(self, keyframe: Frame, keyframe_pose: np.ndarray):
        self.keyframe = keyframe
        self.graph = PoseGraph()
        self.graph.add_vertex(0, np.asarray(keyframe_pose, np.float64), fixed=True)
        # Only the keyframe and the current frame stay resident (the
        # reference holds just those two pyramids, local_map.cpp:59);
        # intermediate frames contribute vertices + timestamps only.
        self._num_frames = 0
        self._frame_timestamps: List[float] = [keyframe.timestamp]
        self.current_frame: Optional[Frame] = None
        self.evaluation = None
        # (from_key, to_key, measurement, information) records for merging
        # into the global graph
        self.odometry_edges: List[Tuple[int, int, np.ndarray, np.ndarray]] = []
        self.keyframe_edges: List[Tuple[int, int, np.ndarray, np.ndarray]] = []

    @staticmethod
    def create(keyframe: Frame, keyframe_pose: np.ndarray) -> "LocalMap":
        return LocalMap(keyframe, keyframe_pose)

    @property
    def num_frames(self) -> int:
        return self._num_frames

    @property
    def frame_timestamps(self) -> List[float]:
        return list(self._frame_timestamps)

    def keyframe_pose(self) -> np.ndarray:
        return self.graph.vertex_pose(0).astype(np.float64)

    def set_keyframe_pose(self, pose: np.ndarray):
        """Re-anchor: move the keyframe and rigidly re-seat every frame from
        its keyframe-edge measurement (local_map.cpp:153-168)."""
        self.graph.set_vertex_pose(0, pose)
        for _, to_key, meas, _ in self.keyframe_edges:
            self.graph.set_vertex_pose(to_key, pose @ meas)

    def add_frame(self, frame: Frame):
        self.current_frame = frame
        self._num_frames += 1
        self._frame_timestamps.append(frame.timestamp)
        self.graph.add_vertex(self._num_frames, np.eye(4))

    def add_odometry_measurement(self, transform: np.ndarray, information: np.ndarray):
        """Edge previous frame -> current frame (local_map.cpp:196-199)."""
        cur = self._num_frames
        prev = cur - 1
        self.graph.add_edge(prev, cur, transform, information)
        self.odometry_edges.append(
            (prev, cur, np.asarray(transform, np.float64), np.asarray(information, np.float64))
        )

    def add_keyframe_measurement(self, transform: np.ndarray, information: np.ndarray):
        """Edge keyframe -> current frame; also seats the current vertex at
        keyframe_pose @ transform (local_map.cpp:202-206)."""
        cur = self._num_frames
        self.graph.add_edge(0, cur, transform, information)
        self.graph.set_vertex_pose(cur, self.keyframe_pose() @ np.asarray(transform, np.float64))
        self.keyframe_edges.append(
            (0, cur, np.asarray(transform, np.float64), np.asarray(information, np.float64))
        )

    def current_frame_pose(self) -> np.ndarray:
        if self._num_frames == 0:
            return self.keyframe_pose()
        return self.graph.vertex_pose(self._num_frames).astype(np.float64)

    def frame_pose(self, i: int) -> np.ndarray:
        return self.graph.vertex_pose(i).astype(np.float64)

    def last_keyframe_edge(self) -> Tuple[np.ndarray, np.ndarray]:
        """(measurement, information) of the keyframe -> last-frame edge —
        the edge the back end promotes to a keyframe edge
        (keyframe_graph.cpp:786-794)."""
        _, _, meas, info = self.keyframe_edges[-1]
        return meas, info

    def optimize(self, iterations: int = 50) -> np.ndarray:
        """Refine the mini graph (local_map.cpp:208-213); returns the chi2
        history (the reference's returns nothing).  Span
        ``dvo.localmap.optimize``, on the thread that inserts the map (the
        back end's worker)."""
        with timers.span("dvo.localmap.optimize"):
            return self.graph.optimize(iterations=iterations)
