"""KeyframeGraph: the global pose-graph SLAM back end (port of
``dvo_slam_tpu.models.keyframe_graph``).

The reference's g2o-backed KeyframeGraph (dvo_slam/src/keyframe_graph.cpp).
Structure of the global graph:

  * keyframe vertices keyed ("kf", k), the chain of local-map keyframes;
  * odometry vertices keyed ("f", n), the intermediate frames, joined by
    edges at level 2 (out of the incremental optimization, in the dense
    final pass: the reference's negative-id renumbering and edge levels,
    keyframe_graph.cpp:741-817);
  * loop-closure edges between keyframes with Cauchy robustification.

When a LocalMap completes, its keyframe vertex is the previous map's last
frame: the reference renumbers and promotes it with g2o changeId
(keyframe_graph.cpp:759-794); here the promotion is a rename of the
pending vertex key.

The optimization thread and queue of the reference (keyframe_graph.cpp:
401-432) are on by default (``GraphConfig.use_multi_threading``, the
reference's UseMultiThreading, config.cpp:38): graph work runs on a worker
thread that consumes the queue, its validation waves launching on the card
beside the tracker (both on the thread's current CUDA stream); an
exception poisons the graph and surfaces at the next wait point
(wait_for_queue / trajectory / shutdown).  ``use_threading=False`` runs it
synchronously, for deterministic runs.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from ..config import GraphConfig, TrackerConfig
from ..ops.camera import Intrinsics
from ..utils import timers
from ..utils.timers import PhaseTimers
from .constraints import ConstraintProposal, ConstraintProposalValidator
from .frames import Keyframe
from .local_map import LocalMap
from .pose_graph import PoseGraph

ODOMETRY_EDGE_LEVEL = 2  # reference: keyframe_graph.cpp:771
WORKER_NAME = "dvo.graph.worker"  # the back end's thread, as its spans name it

# what the back end did (``KeyframeGraph.counts``): maps queued and the queue's
# depth, summed and at its largest, when each was added (the backlog);
# keyframes inserted; candidates found and proposals validated over the
# insertions' searches; validation waves, their chunks and streams (a chunk
# of n pairs runs at B = 2n); constraints accepted; optimisations and the
# edges pruned.  Each count has one writer at a time:
# ``add``'s the caller's thread, the others the worker or, once the queue is
# drained, the final pass
COUNTS = ("maps_added", "backlog", "backlog_max", "keyframes", "candidates",
          "proposals_validated", "waves", "wave_chunks", "wave_streams",
          "constraints_accepted", "optimizations", "edges_pruned")


class SessionMap(NamedTuple):
    """A session's product on the host (``KeyframeGraph.session_map``): the
    final graph's vertices by timestamp, and the edges the final pass
    started from, whose endpoints are rows of the vertices; ``kept`` marks
    those still active at its end (without a final pass: the active edges,
    all kept, and ``start_poses`` the poses)."""

    stamps: np.ndarray  # [N] seconds
    poses: np.ndarray  # [N, 4, 4] float64, camera to world
    start_poses: np.ndarray  # [N, 4, 4] float64: the poses the final pass started from
    keyframe: np.ndarray  # [N] bool: a keyframe vertex
    fixed: np.ndarray  # [N] bool: the gauge
    edge_i: np.ndarray  # [E] int64
    edge_j: np.ndarray  # [E] int64
    measurement: np.ndarray  # [E, 4, 4] float64, T_i^-1 T_j when the edge holds
    information: np.ndarray  # [E, 6, 6] float64
    robust: np.ndarray  # [E] bool: a Cauchy-robust (loop) edge
    kept: np.ndarray  # [E] bool: not pruned by the final pass
    weight: np.ndarray  # [E] the robust kernel's weight at the final poses


class KeyframeGraph:
    """Global keyframe pose graph with loop-closure search + validation."""

    def __init__(
        self,
        intrinsics: Intrinsics,
        cfg: Optional[GraphConfig] = None,
        tracker_cfg: Optional[TrackerConfig] = None,
        use_threading: Optional[bool] = None,
        validator: Optional[ConstraintProposalValidator] = None,
    ):
        self.cfg = cfg or GraphConfig()
        if use_threading is None:
            # reference default: the optimizer thread is on
            # (UseMultiThreading, config.cpp:38)
            use_threading = self.cfg.use_multi_threading
        self.tracker_cfg = tracker_cfg or TrackerConfig()
        self.intrinsics = intrinsics
        # an injected validator lets a fresh graph share the previous
        # one's (a warm restart)
        self.validator = validator or ConstraintProposalValidator(
            intrinsics, self.cfg, self.tracker_cfg
        )
        self.keyframes: List[Keyframe] = []
        self.graph = PoseGraph(vertex_capacity=64, edge_capacity=128)
        self.timestamps: Dict[object, float] = {}
        self.map_changed_callbacks: List[Callable] = []
        self._frame_counter = 0
        self._pending_key = None  # odometry key of the next keyframe vertex
        self._pending_edge: Optional[int] = None  # its keyframe edge index
        self._pending_meas: Optional[np.ndarray] = None
        self._existing_constraints = set()  # frozenset({id_a, id_b})
        # the reference's back-end phase stopwatches
        # (keyframe_graph.cpp:438-443: constraint_search / validation /
        # insert / optimization + the final pass)
        self.timers = PhaseTimers()
        self.counts = dict.fromkeys(COUNTS, 0)
        # the poses and the optimised edges' mask as the final pass's rounds
        # start (``session_map``)
        self._pass_start: Optional[Tuple[np.ndarray, np.ndarray]] = None

        self._queue: "queue.Queue[LocalMap]" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._shutdown = False
        self._worker_error: Optional[BaseException] = None
        self._poisoned = False  # see add()/_worker
        if use_threading:
            self._thread = threading.Thread(target=self._worker, name=WORKER_NAME, daemon=True)
            self._thread.start()

    # -- public API (reference: keyframe_graph.h:44-75) -------------------
    def add_map_changed_callback(self, cb: Callable):
        self.map_changed_callbacks.append(cb)

    def add(self, local_map: LocalMap):
        """Queue a completed local map (keyframe_graph.cpp:161-174).

        A graph whose worker failed is POISONED: the promotion state
        (_pending_key/_pending_meas) refers to the map before the
        failure, so inserting further maps would silently mis-anchor the
        trajectory — add() refuses instead (restore from a checkpoint or
        build a fresh graph)."""
        if self._poisoned:
            raise RuntimeError(
                "keyframe graph poisoned by an earlier worker failure; "
                "its pending-promotion state is stale — restore from a "
                "checkpoint or start a fresh graph"
            )
        counts = self.counts
        counts["maps_added"] += 1
        if self._thread is not None:
            depth = self._queue.qsize()
            counts["backlog"] += depth
            counts["backlog_max"] = max(counts["backlog_max"], depth)
            self._queue.put(local_map)
        else:
            self._new_keyframe(local_map)

    def wait_for_queue(self):
        """Block until the worker drained the queue; re-raise the FIRST
        worker exception here (the reference's thread would die silently —
        a deferred failure must still fail the caller).  The exception is
        raised ONCE; the poisoned flag persists (see add()).

        No-op when called FROM the worker thread: map_changed callbacks
        fire on the worker inside _new_keyframe (before task_done), and a
        callback reading trajectory()/edge_errors() would otherwise join
        the worker's own unfinished queue item and hang forever."""
        if self._thread is not None:
            if threading.current_thread() is self._thread:
                return
            self._queue.join()
        self._raise_worker_error()

    def _raise_worker_error(self):
        if self._worker_error is not None:
            err, self._worker_error = self._worker_error, None
            raise RuntimeError(
                "keyframe-graph worker failed while processing a local map"
            ) from err

    def shutdown(self, timeout: float = 30.0, raise_errors: bool = True):
        """Stop the worker.  If it fails to exit within ``timeout`` the
        hazard is raised, NOT swallowed: a zombie worker still inside a
        validation wave would race a successor graph sharing the same
        validator (corrupting its prepared-artifact caches).

        ``raise_errors=False`` discards a captured worker error instead of
        re-raising it — the path for callers DISCARDING the graph (e.g.
        StreamingSLAM.reset after a poisoned back end): the documented
        recovery action must not itself raise the failure it recovers
        from.  The zombie-worker hazard above is raised regardless."""
        self._shutdown = True
        if self._thread is not None:
            self._queue.put(None)
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                raise RuntimeError(
                    f"keyframe-graph worker did not exit within {timeout}s; "
                    "refusing to orphan it (it may still be mutating the "
                    "validator caches)"
                )
            self._thread = None
        if raise_errors:
            self._raise_worker_error()
        else:
            self._worker_error = None

    def _worker(self):
        """Queue consumer (reference: execOptimization thread,
        keyframe_graph.cpp:401-432).  The FIRST exception poisons the
        graph: later queued maps are drained but NOT applied (their
        anchor, the pending-promotion state, is stale) — dying here
        instead would hang every later wait_for_queue()."""
        while True:
            m = self._queue.get()
            try:
                if m is None or self._shutdown:
                    return
                if not self._poisoned:
                    self._new_keyframe(m)
            except BaseException as e:  # surfaced at the next wait point
                self._worker_error = e
                self._poisoned = True
            finally:
                self._queue.task_done()

    # -- keyframe insertion ------------------------------------------------
    def _insert_new_keyframe(self, m: LocalMap) -> Keyframe:
        """Merge a completed local map into the global graph
        (reference: insertNewKeyframe, keyframe_graph.cpp:741-817)."""
        new_id = len(self.keyframes) + 1
        kf_key = ("kf", new_id)

        if self.keyframes:
            # Re-anchor the local map: its keyframe is the previous map's
            # last frame, whose graph pose is the previous keyframe pose
            # composed with the pending keyframe-edge measurement
            # (keyframe_graph.cpp:744-753).
            prev_pose = self.graph.vertex_pose(("kf", new_id - 1)).astype(np.float64)
            m.set_keyframe_pose(prev_pose @ self._pending_meas)

        m.optimize(50)

        edge_level = 0 if self.cfg.optimization_use_dense_graph else ODOMETRY_EDGE_LEVEL

        if self.keyframes:
            # promote the pending odometry vertex to the new keyframe vertex
            self.graph.rename_vertex(self._pending_key, kf_key)
            self.graph.set_vertex_pose(kf_key, m.keyframe_pose())
            # promote its keyframe edge to level 0 (keyframe_graph.cpp:786-794)
            self.graph.set_edge_level(self._pending_edge, 0)
        else:
            self.graph.add_vertex(kf_key, m.keyframe_pose(), fixed=True)
        self.timestamps[kf_key] = m.keyframe.timestamp

        # insert the map's frames as odometry vertices with its optimized
        # poses, and all its edges at the odometry level
        frame_keys = {0: kf_key}
        ts = m.frame_timestamps
        for i in range(1, m.num_frames + 1):
            key = ("f", self._frame_counter)
            self._frame_counter += 1
            frame_keys[i] = key
            self.graph.add_vertex(key, m.frame_pose(i))
            self.timestamps[key] = ts[i]
        for frm, to, meas, info in m.odometry_edges:
            self.graph.add_edge(
                frame_keys[frm], frame_keys[to], meas, info, level=edge_level
            )
        last_kf_edge_idx = None
        for frm, to, meas, info in m.keyframe_edges:
            last_kf_edge_idx = self.graph.add_edge(
                frame_keys[frm], frame_keys[to], meas, info, level=edge_level
            )

        # the map's last frame seeds the next keyframe
        self._pending_key = frame_keys[m.num_frames]
        self._pending_edge = last_kf_edge_idx
        self._pending_meas, _ = m.last_keyframe_edge()

        keyframe = Keyframe(
            id=new_id,
            frame=m.keyframe,
            pose=self.graph.vertex_pose(kf_key).astype(np.float64),
            evaluation=m.evaluation,
        )
        self.keyframes.append(keyframe)
        return keyframe

    # -- constraint search -------------------------------------------------
    def _find_candidates(self, keyframe: Keyframe) -> List[Keyframe]:
        """Radius search over keyframe translations
        (reference: keyframe_constraint_search.cpp:41-72 via FLANN kd-tree;
        at O(100s) of keyframes a brute-force distance check is faster than
        building a tree)."""
        if len(self.keyframes) < 2:
            return []
        positions = np.stack([k.pose[:3, 3] for k in self.keyframes])
        d = np.linalg.norm(positions - keyframe.pose[:3, 3], axis=1)
        radius = self.cfg.new_constraint_search_radius
        return [k for k, di in zip(self.keyframes, d) if di <= radius]

    def _make_proposals(
        self, keyframe: Keyframe, candidates: List[Keyframe]
    ) -> List[ConstraintProposal]:
        """Identity + relative-pose initialization per candidate
        (keyframe_graph.cpp:583-584)."""
        proposals = []
        for c in candidates:
            proposals.append(ConstraintProposal.with_identity(keyframe, c))
            proposals.append(ConstraintProposal.with_relative(keyframe, c))
        return proposals

    def _insert_constraints(self, proposals: List[ConstraintProposal]) -> int:
        """Insert accepted loop edges; returns the max keyframe-id distance
        (reference: insertNewKeyframeConstraints, keyframe_graph.cpp:595-636)."""
        self.counts["constraints_accepted"] += len(proposals)
        max_distance = -1
        for p in proposals:
            pair = frozenset({p.reference.id, p.current.id})
            self._existing_constraints.add(pair)
            self.graph.add_edge(
                ("kf", p.reference.id),
                ("kf", p.current.id),
                np.asarray(p.result.transformation, np.float64),
                np.asarray(p.result.information, np.float64),
                robust=self.cfg.use_robust_kernel,
                level=0,
            )
            max_distance = max(max_distance, abs(p.reference.id - p.current.id))
        return max_distance

    def _update_keyframe_poses(self):
        """Write optimized graph poses back to the keyframe records
        (keyframe_graph.cpp:676-686)."""
        for k in self.keyframes:
            k.pose = self.graph.vertex_pose(("kf", k.id)).astype(np.float64)

    def _fire_map_changed(self):
        for cb in self.map_changed_callbacks:
            cb(self)

    def _new_keyframe(self, m: LocalMap):
        """Process one completed local map
        (reference: newKeyframe, keyframe_graph.cpp:434-498).  Span
        ``dvo.graph.keyframe``, with the keyframe's frame id, around
        ``dvo.graph.search``, the wave and ``dvo.graph.optimize``."""
        with timers.span("dvo.graph.keyframe", frame=m.keyframe.frame_id):
            with self.timers.timing("constraint_insert"):
                keyframe = self._insert_new_keyframe(m)
            self.counts["keyframes"] += 1
            if len(self.keyframes) == 1:
                return

            with self.timers.timing("constraint_search"), timers.span("dvo.graph.search"):
                candidates = self._find_candidates(keyframe)
                proposals = self._make_proposals(keyframe, candidates)
            self.counts["candidates"] += len(candidates)
            self.counts["proposals_validated"] += len(proposals)
            with self.timers.timing("constraint_validation"):
                proposals = self._validate(proposals)
            with self.timers.timing("constraint_insert"):
                max_distance = self._insert_constraints(proposals)

            if max_distance >= self.cfg.min_constraint_distance:
                with self.timers.timing("constraint_optimization"):
                    self._optimize(self.cfg.optimization_iterations // 2, max_level=0)
                    if self.cfg.optimization_remove_outliers:
                        self._remove_outliers(self.cfg.optimization_outlier_weight_threshold)
                    self._optimize(self.cfg.optimization_iterations // 2, max_level=0)
                    self._update_keyframe_poses()

            self._fire_map_changed()

    def _validate(self, proposals: List[ConstraintProposal]) -> List[ConstraintProposal]:
        """One validation wave, counted."""
        counts = self.counts
        counts["waves"] += 1
        pairs = self.validator.two_stage.MAX_PAIRS
        counts["wave_chunks"] += -(-len(proposals) // pairs)
        counts["wave_streams"] += 2 * len(proposals)
        return self.validator.validate(proposals)

    def _optimize(self, iterations: int, max_level: int):
        """One optimisation of the pose graph (span ``dvo.graph.optimize``),
        counted."""
        with timers.span("dvo.graph.optimize"):
            self.graph.optimize(iterations, max_level=max_level, tol=self.cfg.optimization_tol)
        self.counts["optimizations"] += 1

    def _remove_outliers(self, threshold: float) -> int:
        removed = self.graph.remove_outlier_edges(threshold)
        self.counts["edges_pruned"] += removed
        return removed

    # -- final optimization -------------------------------------------------
    def final_optimization(self, frame: Optional[int] = None):
        """Dense final pass (reference: finalOptimization,
        keyframe_graph.cpp:216-292): re-search constraints for every
        keyframe, enable all edges, alternate optimize + outlier pruning.
        Span ``dvo.graph.final``, from the queue's drain to the last
        pruning, with ``frame`` as its frame id."""
        with timers.span("dvo.graph.final", frame=frame):
            self.wait_for_queue()

            # Re-search over all keyframes as batched validation waves.  The
            # reference loops per keyframe with a TBB pool
            # (keyframe_graph.cpp:229-254); the result is the same: candidate
            # search reads the pre-pass poses either way and the validator
            # keeps the best proposal per pair.  One direction per unseen pair
            # suffices: stage 1 builds the reverse-direction proposals as its
            # cross-validation inverses and keeps the better accepted
            # direction, and a retry of a rejected pair in the same wave would
            # see the same poses and initials.
            groups: List[List[ConstraintProposal]] = []  # one group per pair
            seen = set(self._existing_constraints)
            with self.timers.timing("constraint_search"), timers.span("dvo.graph.search"):
                for keyframe in self.keyframes:
                    for c in self._find_candidates(keyframe):
                        if abs(c.id - keyframe.id) <= 1:
                            continue
                        pair = frozenset({c.id, keyframe.id})
                        if pair in seen:
                            continue
                        seen.add(pair)
                        groups.append(self._make_proposals(keyframe, [c]))
            # Validate in sub-waves bounded by distinct touched frames: one
            # wave would hold every touched keyframe's prepared artifacts (about
            # 16 MB each at 640x480) at once, while the validator's LRU evicts
            # only between validate() calls.  Sub-waves advance in whole pair
            # groups (a pair split across waves would defeat keep-best-per-pair
            # and insert duplicate edges); pairs are unique across waves, so
            # keep-best per wave is keep-best overall.
            with self.timers.timing("constraint_validation"):
                accepted: List[ConstraintProposal] = []
                budget = self.validator.MAX_CACHED_FRAMES
                start = 0
                while start < len(groups):
                    frames: set = set()
                    end = start
                    while end < len(groups):
                        g = groups[end]
                        f = frames | {
                            id(fr)
                            for p in g
                            for fr in (p.reference.frame, p.current.frame)
                        }
                        if len(f) > budget and end > start:
                            break
                        frames = f
                        end += 1
                    wave = [p for g in groups[start:end] for p in g]
                    accepted.extend(self._validate(wave))
                    start = end
            with self.timers.timing("constraint_insert"):
                self._insert_constraints(accepted)

            max_level = 0
            if self.cfg.final_optimization_use_dense_graph:
                self.graph.set_all_edge_levels(0)
            g = self.graph
            self._pass_start = (g.poses[:g.num_vertices].copy(),
                                g.edge_active[:g.num_edges] & (g.edge_level[:g.num_edges] <= max_level))

            # The reference always runs the full 10-round schedule
            # (keyframe_graph.cpp:266-281); early exit is opt-in.
            with self.timers.timing("final_optimization"):
                for _ in range(10):
                    self._optimize(max(self.cfg.final_optimization_iterations // 10, 1), max_level)
                    removed = 0
                    if self.cfg.final_optimization_remove_outliers:
                        removed = self._remove_outliers(
                            self.cfg.final_optimization_outlier_weight_threshold
                        )
                    if self.cfg.final_optimization_early_exit and removed == 0:
                        break

        self._update_keyframe_poses()
        self._fire_map_changed()

    # -- trajectory export ---------------------------------------------------
    def trajectory(self) -> Tuple[np.ndarray, np.ndarray]:
        """All graph vertices sorted by timestamp -> (stamps, poses [N,4,4])
        (reference: TrajectorySerializer, map_serializer.cpp:44-65)."""
        self.wait_for_queue()  # a busy worker is still mutating the graph
        items = []
        for key in self.graph.vertex_keys():
            ts = self.timestamps.get(key)
            if ts is None:
                continue
            items.append((ts, self.graph.vertex_pose(key).astype(np.float64)))
        items.sort(key=lambda x: x[0])
        if not items:
            return np.zeros(0), np.zeros((0, 4, 4))
        stamps, poses = zip(*items)
        return np.asarray(stamps), np.asarray(poses)

    def session_map(self) -> SessionMap:
        """The graph as it stands, on the host in one piece: every vertex
        that has a timestamp, by timestamp, and the edges between them that
        the final pass started from (the active ones where no pass ran),
        each with whether it is still active and its robust weight at the
        current poses."""
        self.wait_for_queue()
        g = self.graph
        keys = sorted((k for k in g.vertex_keys() if k in self.timestamps),
                      key=lambda k: self.timestamps[k])
        rows = {g.vertex_index(k): row for row, k in enumerate(keys)}
        index = np.array([g.vertex_index(k) for k in keys], np.int64)
        n_e = g.num_edges
        start_poses, started = (g.poses[:g.num_vertices], g.edge_active[:n_e]) \
            if self._pass_start is None else self._pass_start
        edges = np.nonzero(started)[0]
        edges = edges[[int(g.edge_i[e]) in rows and int(g.edge_j[e]) in rows for e in edges]]
        weight, _ = g.edge_diagnostics()
        return SessionMap(
            stamps=np.array([self.timestamps[k] for k in keys], np.float64),
            poses=g.poses[index].astype(np.float64),
            start_poses=start_poses[index].astype(np.float64),
            keyframe=np.array([k[0] == "kf" for k in keys], bool),
            fixed=g.fixed[index].copy(),
            edge_i=np.array([rows[int(g.edge_i[e])] for e in edges], np.int64),
            edge_j=np.array([rows[int(g.edge_j[e])] for e in edges], np.int64),
            measurement=g.measurements[edges].astype(np.float64),
            information=g.information[edges].astype(np.float64),
            robust=g.robust[edges].copy(),
            kept=g.edge_active[edges].copy(),
            weight=np.asarray(weight, np.float64)[edges],
        )

    def edge_errors(self):
        """Per-edge diagnostics dump (reference: EdgeErrorSerializer,
        map_serializer.cpp:76-93)."""
        self.wait_for_queue()
        w, chi2 = self.graph.edge_diagnostics()
        return w, chi2
