"""Entry adapter: whole DVO-SLAM sessions over a recording, the program's
``models/keyframe_tracker.KeyframeTracker`` as the reference's batch program
runs it (``dvo_benchmark``'s ``benchmark_slam.cpp``): a session is ``init``,
then ``make_frame_raw`` + ``update`` for each frame of the recording with
the keyframe graph's worker thread on, then ``end_session``: the keyframe
forced on the last frame, the worker's queue drained, the dense final
pass, the optimised map copied to the host and the worker joined.  Each
pass over the recording is one session on a new tracker; ``start_pass``
ends the session in progress inside the window, so a pass's time holds
the back end's backlog, the final pass and the map's copy.  The session
open when the window closes ends in ``finish``, outside the timing.

The check (``judge``) reads the window's first whole session against the
plain references, each working from the raw frames or the map again:

* the front end: frames of the session drawn from the seed, each with the
  keyframe it was tracked against and its pose relative to that keyframe
  as the local map holds it (``info``: the keyframe edge's measurement, so
  the number does not depend on where the worker has moved the keyframe
  since); the reference tracker (``reference/tracker``, float64) aligns
  the keyframe's chain up to the frame as ``entries/keyframe_tracker.py``
  does;
* the loop constraints: robust keyframe-to-keyframe edges of the final
  graph, drawn from the seed, aligned by the reference tracker at the
  validation's fine settings from the ground truth, as there;
* the map, twice over.  Its optimality: the plain pose-graph reference
  (``reference/pose_graph``, float64) started from the program's
  optimised poses on the edges the program's final pass kept and run to
  the cost's minimum; the gap of each vertex between the program's pose
  and where the reference ends, both relative to the first vertex, is
  how far the program's map is from the optimum of its own graph.  Its
  pruning: the reference's final pass (the same rounds of optimisation
  and outlier pruning) from the graph the program's pass started from;
  every edge kept by one and pruned by the other is a mismatch.

The numbers compared are the 90th percentiles of the translation and
rotation gaps of the front end and the loop constraints, the widest
translation gap of the map, and the map's pruning mismatches
(``limits/<cell>.json``, PERF.md).  The map's other gaps are printed
beside them: their sound floor is the float32 rounding of the poses the
program stores, too close to a map solved in float32 to be held.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from slam_bench import manifest, program
from slam_bench.reference import pose_graph as ref_pg

WARM_UP_FRAMES = 8  # the warm-up session: the first match (B = 1) and dual matches (B = 2)
FINAL_ROUNDS = 10  # the final pass's rounds of optimisation and pruning (keyframe_graph.cpp:266-281)

# the live SLAM cell's adapter: its reference alignments and samplers
_kt = manifest.entry("keyframe_tracker")


def _tracker_class():
    from dvo_slam_tpu_torch.models.keyframe_tracker import KeyframeTracker

    if not hasattr(KeyframeTracker, "end_session"):
        raise RuntimeError("the program's KeyframeTracker has no end_session: it cannot end a "
                           "session with the map on the host")
    return KeyframeTracker


class Entry:
    def __init__(self, config: dict, device):
        self.config = config
        self.device = device
        self.tracker_class = _tracker_class()
        self.kt = None
        self.frames_in_session = 0
        self.first_map = None  # the window's first whole session
        self.ended = 0  # sessions ended inside the window
        self.counts: dict = {}  # the back end's counts summed over those sessions
        self.session_s: list = []  # each of those sessions, its start to its map on the host
        self.end_s: list = []  # the end of each: the final pass, the map's copy, the join
        self._started = 0.0
        self._frame = None

    def _new_session(self):
        self.kt = self.tracker_class(program.intrinsics(self.config),
                                     program.slam_config(self.config), device=self.device)
        self.kt.init()
        self.frames_in_session = 0
        self._started = time.perf_counter()

    def end_session(self):
        """The open session's map and the back end's counts."""
        kt, self.kt = self.kt, None
        session_map = kt.end_session()
        return session_map, dict(kt.graph.counts)

    def start_pass(self):
        if self.kt is not None and self.frames_in_session:
            ending = time.perf_counter()
            session_map, counts = self.end_session()
            self.session_s.append(time.perf_counter() - self._started)
            self.end_s.append(time.perf_counter() - ending)
            if self.first_map is None:
                self.first_map = session_map
            self.ended += 1
            for key, value in counts.items():
                self.counts[key] = self.counts.get(key, 0) + value
        self._new_session()

    def ingest(self, intensity_u8, depth_u16, stamp: float):
        return self.kt.make_frame_raw(intensity_u8, depth_u16, stamp)

    def update(self, frame) -> np.ndarray:
        self._frame = frame
        self.frames_in_session += 1
        return self.kt.update(frame)

    def info(self) -> dict:
        """``keyframe``: the timestamp of the keyframe the frame was tracked
        against (its own for a session's first frame); ``relative``: its
        pose relative to that keyframe as the local map holds it (the last
        keyframe edge's measurement)."""
        m = self.kt.lt.local_map
        if m is None:
            return {"keyframe": float(self._frame.timestamp), "relative": np.eye(4)}
        return {"keyframe": float(m.keyframe.timestamp), "relative": m.keyframe_edges[-1][2]}

    def counters(self) -> dict:
        """The launch counts of kernels 1 and 1b, and the lockstep
        evaluations by (level, streams)."""
        from dvo_slam_tpu_torch.models import frames

        return {**program.kernel_launches(), "evaluations": dict(frames.batch_evaluations)}

    def timers(self) -> dict:
        """The sessions ended inside the window, their seconds and their
        ends' seconds, and the back end's counts over them
        (``KeyframeGraph.counts``)."""
        return {"sessions": self.ended, "session_s": list(self.session_s),
                "end_s": list(self.end_s), "counts": dict(self.counts)}

    def finish(self) -> dict:
        """The open session ended (outside the timing), and the window's
        first whole session's map with its loop constraints as (reference
        keyframe stamp, current keyframe stamp, measurement).  The open
        session is whole where the window closed on the recording's last
        frame."""
        print(f"slam_bench: sessions ended inside the window: {self.ended}, seconds each "
              f"{[round(x, 4) for x in self.session_s]}, of it the end "
              f"{[round(x, 4) for x in self.end_s]}; the open session's frames "
              f"{self.frames_in_session}", file=sys.stderr)
        if self.kt is not None:
            whole = self.frames_in_session >= int(self.config["sequence"]["frames"])
            session_map, _ = self.end_session()
            if self.first_map is None and whole:
                self.first_map = session_map
        m = self.first_map
        if m is None:
            print("slam_bench: no whole session in the window", file=sys.stderr)
            return {"map": None, "loops": [], "keyframes": 0, "sessions": self.ended}
        loops = [(m.stamps[a], m.stamps[b], m.measurement[e])
                 for e, (a, b) in enumerate(zip(m.edge_i, m.edge_j))
                 if m.kept[e] and m.robust[e] and m.keyframe[a] and m.keyframe[b]]
        return {"map": m, "loops": loops, "keyframes": int(m.keyframe.sum()),
                "sessions": self.ended}

    def coverage_line(self, run, tr) -> str:
        seen = len(tr.device_events(run.trace, program.KERNEL_NAMES[0]))
        before, after = run.counters["before"], run.counters["after"]
        ran = sum(after[k] - before[k] for k in ("kernel1", "kernel1b"))
        return (f"slam_bench: profiler coverage: kernel 1 and 1b evaluations seen by the profiler "
                f"{seen}, run by the program's counters {ran}")


def warm_up(config: dict, traffic: dict, rec, device):
    """A short session on a throwaway tracker, its end included: the first
    match (B = 1), the dual match (B = 2), the final pass's code; then a
    validation wave of each size (B = 2 to 16) on two of its frames.  Every
    graph a session can reach is captured before the window."""
    entry = Entry(config, device)
    entry.start_pass()
    frames = [entry.ingest(rec.intensity[i], rec.depth[i], float(rec.stamps[i]))
              for i in range(min(WARM_UP_FRAMES, len(rec.intensity)))]
    for frame in frames:
        entry.update(frame)
    entry.kt.graph.validator.warm_up(frames[0], frames[-1])
    entry.end_session()


def setup_counts() -> dict:
    stats = program.graph_stats()
    return {"graph_keys": stats["keys"], "capture_ms": float(stats["capture_ms"])}


def release():
    program.release_graphs()


def frontend_pairs(frames, rate: float, n: int, seed: int):
    """[(j, k)], the program's relative poses [n, 4, 4]: ``n`` frames of the
    first pass drawn from ``seed``, each with its keyframe j."""
    cands = [f for f in frames if f.pass_no == 0 and f.pose is not None
             and "relative" in f.info and _kt._index(f.info["keyframe"], rate) != f.index]
    rng = np.random.default_rng(int(seed) % (1 << 63))
    pick = sorted(rng.choice(len(cands), size=min(n, len(cands)), replace=False)) if cands else []
    pairs = [(_kt._index(cands[p].info["keyframe"], rate), cands[p].index) for p in pick]
    mine = [np.asarray(cands[p].info["relative"], np.float64) for p in pick]
    return pairs, (np.stack(mine) if mine else np.zeros((0, 4, 4)))


def map_graph(m, start: bool = False):
    """A session's graph as the pose-graph reference takes it: the final map
    (its poses and the edges the final pass kept) or, with ``start``, the
    graph the final pass started from (those poses and all its edges, in
    the map's order); the vertices the edges touch, the fixed ones first,
    float64; and the map's row of each of those vertices."""
    keep = np.ones(len(m.edge_i), bool) if start else m.kept
    ei, ej = m.edge_i[keep], m.edge_j[keep]
    used = np.zeros(len(m.stamps), bool)
    used[ei] = used[ej] = True
    fixed = m.fixed.copy()
    if not fixed[used].any():
        fixed[np.nonzero(used)[0][0]] = True  # the program's own gauge
    order = np.concatenate([np.nonzero(used & fixed)[0], np.nonzero(used & ~fixed)[0]])
    row = np.full(len(m.stamps), -1, np.int64)
    row[order] = np.arange(len(order))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    poses = m.start_poses if start else m.poses
    return ref_pg.Graph(t(poses[order]), t(fixed[order]), t(row[ei]), t(row[ej]),
                        t(m.measurement[keep]), t(m.information[keep]),
                        t(m.robust[keep].astype(bool))), order


def map_gaps(m, device, dtype=torch.float64):
    """(translation m, rotation rad) [N] of each vertex between the
    program's map and the reference's minimum from it, relative to the
    first vertex, and the reference's solution."""
    g = map_graph(m)[0].to(device=device, dtype=dtype)
    solution = ref_pg.optimize(g)
    t, r = ref_pg.pose_gaps(g.poses.to(torch.float64), solution.poses.to(torch.float64))
    return t.cpu().numpy(), r.cpu().numpy(), solution


def final_pass(m, config: dict, device):
    """The reference's final pass from the graph the program's pass started
    from, on the configuration's schedule: (its kept mask over the map's
    edges, the Cauchy weights of the map's edges at its final poses)."""
    graph = config["graph"]
    threshold = (float(graph["final_optimization_outlier_weight_threshold"])
                 if graph["final_optimization_remove_outliers"] else 0.0)
    g = map_graph(m, start=True)[0].to(device=device, dtype=torch.float64)
    poses, kept = ref_pg.final_pass(g, FINAL_ROUNDS,
                                    max(int(graph["final_optimization_iterations"]) // 10, 1),
                                    threshold)
    _, chi2 = ref_pg.residuals(g, poses)
    return kept.cpu().numpy(), ref_pg.weights(g, chi2).cpu().numpy()


def map_checks(m, config: dict, limits: dict, device) -> list:
    """The map's compared numbers (the widest translation gap, the pruning
    mismatches) and its other gaps, printed."""
    t, r, solution = map_gaps(m, device)
    kept, weight = final_pass(m, config, device)
    mismatches = int((kept != m.kept).sum())
    threshold = float(config["graph"]["final_optimization_outlier_weight_threshold"])
    margin = (np.abs(weight[m.robust] - threshold).min() / threshold if m.robust.any()
              else float("nan"))
    print(f"slam_bench: map: {len(t)} vertices, {int(m.kept.sum())} kept edges "
          f"({int((m.robust & m.kept).sum())} robust) of the final pass's {len(m.kept)}; "
          f"the reference took {solution.iterations} steps; gap p90 t {np.percentile(t, 90):.3e} m, "
          f"r {np.percentile(r, 90):.3e} rad, widest t {t.max():.3e} m (vertex {int(np.argmax(t))}), "
          f"r {r.max():.3e} rad; pruned by the pass {int((~m.kept).sum())}, by the reference's "
          f"{int((~kept).sum())}, mismatches {mismatches}; the closest robust weight to the "
          f"threshold {margin:.3e} of it", file=sys.stderr)
    return [{"name": "map_gap_t_max_m", "value": float(t.max()),
             "limit": float(limits["map_gap_t_max_m"])},
            {"name": "map_prune_mismatches", "value": mismatches,
             "limit": float(limits["map_prune_mismatches"])}]


def judge(config: dict, traffic: dict, limits: dict, rec, frames, outputs, seed: int,
          device) -> list:
    rate = float(config["sequence"]["rate_hz"])
    n = int(traffic["check_pairs"])
    front_s, fine_s = _kt.settings(config)
    checks = []
    for kind, (pairs, mine), align in (
            ("frontend", frontend_pairs(frames, rate, n, seed),
             lambda p: _kt.align_chains(front_s, rec, p, device)),
            ("loop", _kt.loop_pairs(outputs, rate, n, seed),
             lambda p: _kt.align_pairs(fine_s, rec, p, device))):
        if not pairs:
            checks.append({"name": f"{kind}_pairs_checked", "value": 0, "limit": -1})
            continue
        theirs = align(pairs)
        t, r = _kt._gaps(mine, theirs)
        j = int(np.argmax(t))
        print(f"slam_bench: {kind}: {len(pairs)} pairs checked; gap median t {np.median(t):.3e} m, "
              f"r {np.median(r):.3e} rad; widest at {pairs[j]}: {t[j]:.3e} m", file=sys.stderr)
        checks += [{"name": name, "value": float(np.percentile(v, 90)),
                    "limit": float(limits[name])}
                   for name, v in ((f"{kind}_gap_t_p90_m", t), (f"{kind}_gap_r_p90_rad", r))]
    m = outputs["map"]
    if m is None:
        checks.append({"name": "map_sessions_checked", "value": 0, "limit": -1})
        return checks
    print(f"slam_bench: map of the window's first whole session: {outputs['keyframes']} "
          f"keyframes, {outputs['sessions']} sessions in the window", file=sys.stderr)
    return checks + map_checks(m, config, limits, device)
