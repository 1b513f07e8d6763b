"""Entry adapter: DVO-SLAM, the program's ``models/keyframe_tracker.
KeyframeTracker`` (the reference's per-frame ``update``), one frame at a
time through ``make_frame_raw`` + ``update``, with the keyframe graph's
worker thread on.  After the window ``finish()`` flushes the last local
map and runs the final optimisation, outside the timing.

The check (``judge``) holds two kinds of answer to the plain reference
(``reference/tracker``, float64), each aligned again from the raw frames:

* the front end: the pose ``update`` returns for frame k is its keyframe
  j's pose times the dual match's keyframe stream (or, on the frame that
  starts a map, its odometry stream), so pose_j^-1 pose_k is the program's
  alignment of k to j.  A sample of the window's frames, drawn from the
  seed, with the keyframe each was tracked against (which the program
  reports: ``local_map.keyframe``): the reference aligns j -> j + 1 from
  the identity and then j -> m from its own j -> m - 1 up to k, the
  warm start the front end uses, at the tracker's settings;
* the back end: the loop constraints between keyframes that the final
  graph holds (the robust keyframe-to-keyframe edges that the worker's
  validation waves accepted), a sample drawn from the seed, aligned at the
  validation's fine settings (``constraint_tracker_config``: the
  tracker's levels, precision and mu, 100 iterations a level) from the
  ground-truth relative pose (the two stages' path depends on the
  program's graph poses; at these settings the fine stage converges to
  within 1e-5 m of one answer from any start near it, PERF.md).

The numbers compared are the 90th percentiles of the translation and
rotation gaps of each kind (``limits/<cell>.json``; why not the widest:
``camera_tracker``).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from slam_bench import program
from slam_bench.reference import tracker as ref

BLOCK = 16
CHAIN_BLOCK = 32  # the chains' pairs aligned at once
FINE_MAX_ITERATIONS = 100  # TrackerConfig's default, which the validation's fine stage keeps


class Entry:
    def __init__(self, config: dict, device):
        from dvo_slam_tpu_torch.models.keyframe_tracker import KeyframeTracker

        self.kt = KeyframeTracker(program.intrinsics(config), program.slam_config(config),
                                  device=device)
        self.kt.init()

    def start_pass(self):
        pass

    def ingest(self, intensity_u8, depth_u16, stamp: float):
        return self.kt.make_frame_raw(intensity_u8, depth_u16, stamp)

    def update(self, frame) -> np.ndarray:
        self._frame = frame
        return self.kt.update(frame)

    def info(self) -> dict:
        """``keyframe``: the timestamp of the keyframe the frame was tracked
        against (its own for the first frame)."""
        m = self.kt.lt.local_map
        return {"keyframe": float(m.keyframe.timestamp if m is not None else self._frame.timestamp)}

    def counters(self) -> dict:
        return program.kernel_launches()

    def timers(self) -> dict:
        summary = self.kt.graph.timers.summary()
        return {"total_s": sum(s["total_s"] for s in summary.values()),
                "phases": {k: s["total_s"] for k, s in summary.items()}}

    def finish(self) -> dict:
        """Flush, final optimisation, then the back end's answers: the
        loop constraints of the final graph as (reference keyframe stamp,
        current keyframe stamp, measurement)."""
        try:
            self.kt.finish()
            g = self.kt.graph
            stamps = g.timestamps
            loops = [(stamps[a], stamps[b], np.asarray(meas, np.float64))
                     for a, b, meas, _, robust, _ in g.graph.edge_list()
                     if robust and a[0] == "kf" and b[0] == "kf"]
            return {"loops": loops, "keyframes": len(g.keyframes)}
        finally:
            self.kt.graph.shutdown()

    def coverage_line(self, run, tr) -> str:
        seen = len(tr.device_events(run.trace, program.KERNEL_NAMES[0]))
        before, after = run.counters["before"], run.counters["after"]
        ran = sum(after[k] - before[k] for k in after)
        return (f"slam_bench: profiler coverage: kernel 1 and 1b evaluations seen by the profiler "
                f"{seen}, run by the program's counters {ran}")


def warm_up(config: dict, traffic: dict, rec, device):
    """A throwaway lap through a ``KeyframeTracker``, its final pass
    included: the dual match's and the validation waves' graphs (B = 2n)
    are captured before the window."""
    entry = Entry(config, device)
    lap = int(config["loop"]["lap_frames"])
    for i in range(min(lap, len(rec.intensity))):
        entry.update(entry.ingest(rec.intensity[i], rec.depth[i], float(rec.stamps[i])))
    entry.finish()


def setup_counts() -> dict:
    stats = program.graph_stats()
    return {"graph_keys": stats["keys"], "capture_ms": float(stats["capture_ms"])}


def release():
    program.release_graphs()


def _index(stamp: float, rate: float) -> int:
    return int(round(stamp * rate))


def align_pairs(settings: ref.Settings, rec, pairs, device, init=None, dtype=torch.float64,
                mm=torch.matmul, block: int = BLOCK) -> np.ndarray:
    """The reference's alignment of each (reference frame a, current frame
    b) [n, 4, 4], from ``init`` [n, 4, 4] (the ground-truth relative poses
    where None)."""
    k = rec.intrinsics
    if init is None:
        init = np.stack([np.linalg.inv(rec.poses[a]) @ rec.poses[b] for a, b in pairs])
    out = []
    for start in range(0, len(pairs), block):
        part = np.asarray(pairs[start:start + block])
        frames = np.concatenate([part[:, 0], part[:, 1]])
        pyr = ref.pyramid(torch.from_numpy(rec.intensity[frames]).to(device),
                          torch.from_numpy(rec.depth[frames]).to(device),
                          (k.fx, k.fy, k.ox, k.oy), settings.first_level + 1, dtype)
        n = len(part)
        cut = lambda a, b: [ref.Level(*(t[a:b] for t in lv[:-1]), K=lv.K) for lv in pyr]  # noqa: E731
        start_pose = torch.from_numpy(np.asarray(init[start:start + n])).to(device=device,
                                                                           dtype=dtype)
        a = ref.align(settings, cut(0, n), cut(n, 2 * n), start_pose, mm=mm)
        out.append(a.transformation.to(torch.float64).cpu())
    return torch.cat(out).numpy() if out else np.zeros((0, 4, 4))


def align_chains(settings: ref.Settings, rec, pairs, device, dtype=torch.float64,
                 mm=torch.matmul) -> np.ndarray:
    """The front end's answer for each (keyframe j, frame k) [n, 4, 4]: j ->
    j + 1 from the identity, then j -> m from j -> m - 1, up to k; the
    chains advance together, one frame a step."""
    current = np.stack([np.eye(4)] * len(pairs))
    for step in range(1, max(k - j for j, k in pairs) + 1):
        live = [i for i, (j, k) in enumerate(pairs) if k - j >= step]
        done = align_pairs(settings, rec, [(pairs[i][0], pairs[i][0] + step) for i in live],
                           device, init=current[live], dtype=dtype, mm=mm, block=CHAIN_BLOCK)
        current[live] = done
    return current


def settings(config: dict):
    """(front end, loop constraints) reference settings."""
    front = ref.Settings.from_config(config["tracker"])
    return front, front._replace(max_iterations=FINE_MAX_ITERATIONS)


def _gaps(a, b):
    t, r = ref.relative_gap(torch.from_numpy(a), torch.from_numpy(b))
    return t.numpy(), r.numpy()


def frontend_pairs(frames, rate: float, n: int, seed: int):
    """[(j, k)], program relative poses [n, 4, 4]: ``n`` window frames
    drawn from ``seed`` with the keyframe j each was tracked against."""
    pose = {f.index: f.pose for f in frames}
    cands = [f for f in frames if f.pose is not None and "keyframe" in f.info
             and _index(f.info["keyframe"], rate) != f.index
             and pose.get(_index(f.info["keyframe"], rate)) is not None]
    rng = np.random.default_rng(int(seed) % (1 << 63))
    pick = sorted(rng.choice(len(cands), size=min(n, len(cands)), replace=False)) if cands else []
    pairs, mine = [], []
    for p in pick:
        f = cands[p]
        j = _index(f.info["keyframe"], rate)
        pairs.append((j, f.index))
        mine.append(np.linalg.inv(pose[j]) @ f.pose)
    return pairs, (np.stack(mine) if mine else np.zeros((0, 4, 4)))


def loop_pairs(outputs: dict, rate: float, n: int, seed: int):
    loops = outputs["loops"]
    rng = np.random.default_rng((int(seed) + 1) % (1 << 63))
    pick = sorted(rng.choice(len(loops), size=min(n, len(loops)), replace=False)) if loops else []
    pairs = [(_index(loops[p][0], rate), _index(loops[p][1], rate)) for p in pick]
    mine = np.stack([loops[p][2] for p in pick]) if pick else np.zeros((0, 4, 4))
    return pairs, mine


def judge(config: dict, traffic: dict, limits: dict, rec, frames, outputs, seed: int,
          device) -> list:
    rate = float(config["sequence"]["rate_hz"])
    n = int(traffic["check_pairs"])
    front_s, fine_s = settings(config)
    checks = []
    for kind, (pairs, mine), align in (
            ("frontend", frontend_pairs(frames, rate, n, seed),
             lambda p: align_chains(front_s, rec, p, device)),
            ("loop", loop_pairs(outputs, rate, n, seed),
             lambda p: align_pairs(fine_s, rec, p, device))):
        if not pairs:
            checks.append({"name": f"{kind}_pairs_checked", "value": 0, "limit": -1})
            continue
        theirs = align(pairs)
        t, r = _gaps(mine, theirs)
        j = int(np.argmax(t))
        a, b = pairs[j]
        truth = np.linalg.inv(rec.poses[a]) @ rec.poses[b]
        off = [_gaps(x[None], truth[None])[0][0] for x in (mine[j], theirs[j])]
        print(f"slam_bench: {kind}: {len(pairs)} pairs checked; gap median t {np.median(t):.3e} m, "
              f"r {np.median(r):.3e} rad; widest at {pairs[j]}: {t[j]:.3e} m (from the ground "
              f"truth: program {off[0]:.3e} m, reference {off[1]:.3e} m)", file=sys.stderr)
        checks += [{"name": name, "value": float(np.percentile(v, 90)),
                    "limit": float(limits[name])}
                   for name, v in ((f"{kind}_gap_t_p90_m", t), (f"{kind}_gap_r_p90_rad", r))]
    print(f"slam_bench: keyframes {outputs['keyframes']}, loop constraints "
          f"{len(outputs['loops'])}", file=sys.stderr)
    return checks
