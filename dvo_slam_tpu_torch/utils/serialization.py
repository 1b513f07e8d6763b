"""Checkpoint / resume for the SLAM state (the port's copy of
``dvo_slam_tpu.utils.serialization``, on the port's ``PoseGraph`` and
``KeyframeGraph``; the .npz layout is the same, so a checkpoint written by
either package loads in the other).

The reference has no checkpointing — persistence is output-only trajectory
files (SURVEY.md section 5 "Checkpoint/resume: none").  This module adds
it: the full pose-graph state (vertices
with keys/poses/timestamps, edges with measurements/information/levels/
robust flags, keyframe records) round-trips through a single .npz so a
mapping session can be interrupted, resumed, or re-optimized offline.

Keyframe image pyramids are not checkpointed by default (they are
re-derivable from the dataset and dominate size); pass a ``frame_provider`` to
``load_keyframe_graph_state`` to rebuild them when further loop
closing is needed.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np

from ..models.keyframe_graph import KeyframeGraph
from ..models.pose_graph import PoseGraph


def _encode_key(key) -> str:
    return json.dumps(key if not isinstance(key, tuple) else list(key))


def _decode_key(s: str):
    v = json.loads(s)
    return tuple(v) if isinstance(v, list) else v


def save_pose_graph(path: str, graph: PoseGraph, extra: Optional[dict] = None):
    """Serialize a PoseGraph (vertices, edges, flags) to an .npz file."""
    n, e = graph.num_vertices, graph.num_edges
    keys = [None] * n
    for key, idx in graph._vertex_ids.items():
        keys[idx] = _encode_key(key)
    np.savez_compressed(
        path,
        poses=graph.poses[:n],
        fixed=graph.fixed[:n],
        vertex_keys=np.asarray(keys),
        edge_i=graph.edge_i[:e],
        edge_j=graph.edge_j[:e],
        measurements=graph.measurements[:e],
        information=graph.information[:e],
        edge_active=graph.edge_active[:e],
        robust=graph.robust[:e],
        edge_level=graph.edge_level[:e],
        extra=json.dumps(extra or {}),
    )


def load_pose_graph(path: str) -> PoseGraph:
    """Rebuild a PoseGraph from an .npz checkpoint."""
    data = np.load(path, allow_pickle=False)
    n = len(data["poses"])
    e = len(data["edge_i"])
    g = PoseGraph(vertex_capacity=max(16, n), edge_capacity=max(16, e))
    keys = [_decode_key(s) for s in data["vertex_keys"]]
    for i in range(n):
        g.add_vertex(keys[i], data["poses"][i], fixed=bool(data["fixed"][i]))
    for k in range(e):
        g.add_edge(
            keys[int(data["edge_i"][k])],
            keys[int(data["edge_j"][k])],
            data["measurements"][k],
            data["information"][k],
            robust=bool(data["robust"][k]),
            level=int(data["edge_level"][k]),
        )
        if not data["edge_active"][k]:
            g.deactivate_edges([k])
    return g


def checkpoint_extra(path: str) -> dict:
    data = np.load(path, allow_pickle=False)
    return json.loads(str(data["extra"]))


def save_keyframe_graph(path: str, kg: KeyframeGraph):
    """Checkpoint the global SLAM back-end state: graph, keyframe records
    (with their evaluation running statistics), vertex timestamps, and the
    pending-promotion state that lets keyframe insertion CONTINUE after a
    restore (keyframe_graph.py: _pending_* is the next map's anchor)."""
    from ..models.evaluation import evaluation_state

    kg.wait_for_queue()  # the optimizer worker may still be mutating state
    extra = {
        "timestamps": {_encode_key(k): float(v) for k, v in kg.timestamps.items()},
        "keyframes": [
            {
                "id": k.id,
                "timestamp": k.timestamp,
                "pose": np.asarray(k.pose).tolist(),
                "evaluation": evaluation_state(k.evaluation),
            }
            for k in kg.keyframes
        ],
        "frame_counter": kg._frame_counter,
        "existing_constraints": [sorted(p) for p in kg._existing_constraints],
        "pending": None
        if kg._pending_key is None
        else {
            "key": _encode_key(kg._pending_key),
            "edge": kg._pending_edge,
            "meas": np.asarray(kg._pending_meas).tolist(),
        },
    }
    save_pose_graph(path, kg.graph, extra)


class _NoFrame:
    """Timestamp-only frame placeholder for restored keyframes whose
    pyramids were not re-attached (pass frame_provider to rebuild them)."""

    __slots__ = ("timestamp", "levels")

    def __init__(self, ts):
        self.timestamp = ts
        self.levels = None


def load_keyframe_graph_state(path: str, kg: KeyframeGraph, frame_provider=None):
    """Restore graph + bookkeeping into a fresh KeyframeGraph.

    ``frame_provider``: optional ``timestamp -> Frame`` callback that
    re-derives each keyframe's image pyramid from the dataset (pyramids
    are not checkpointed — they dominate size and are re-renderable).
    With frames attached the restored graph supports the FULL workflow:
    continued keyframe insertion (pending-promotion state is restored),
    loop-closure re-search + dense re-validation, and final optimization.
    Without it, keyframes carry timestamp-only placeholders — enough to
    continue optimization, export trajectories, or re-anchor.
    """
    from ..models.evaluation import RestoredEvaluation
    from ..models.frames import Keyframe

    kg.wait_for_queue()
    kg.graph = load_pose_graph(path)
    extra = checkpoint_extra(path)
    kg.timestamps = {_decode_key(k): v for k, v in extra["timestamps"].items()}
    kg._frame_counter = extra["frame_counter"]
    kg._existing_constraints = {frozenset(p) for p in extra["existing_constraints"]}
    pending = extra.get("pending")
    if pending is not None:
        kg._pending_key = _decode_key(pending["key"])
        kg._pending_edge = pending["edge"]
        kg._pending_meas = np.asarray(pending["meas"], np.float64)
    kg.keyframes = []
    for rec in extra["keyframes"]:
        frame = (
            frame_provider(rec["timestamp"])
            if frame_provider is not None
            else _NoFrame(rec["timestamp"])
        )
        ev = rec.get("evaluation")
        kg.keyframes.append(
            Keyframe(
                id=rec["id"],
                frame=frame,
                pose=np.asarray(rec["pose"]),
                evaluation=None if ev is None else RestoredEvaluation(ev),
            )
        )
    return kg
