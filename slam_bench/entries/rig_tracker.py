"""Entry adapter: a rig of B cameras tracked in lockstep, the program's
``parallel/multistream.LockstepTracker``, one rig frame at a time through
``make_frames_raw`` + ``update``, whose B accumulated poses [B, 4, 4] come
back to the host together.  A rig frame is the B cameras' frames of one
instant: the harness's recording is stream 0, and stream b of 1 to B - 1 is
a recording of the configuration's ``streams[b]`` loop rendered in the
set-up (``warm_up``) with its own noise; the harness's frame at ``stamp``
goes with frame ``round(stamp * rate_hz)`` of each other stream.  A new pass
over the recording starts every stream from ``reset()``.  A rig frame fails
when any of its B poses is not finite.

Stream b's noise seed is drawn from the recording the harness hands over
(``stream_seed``: sha256 over stream 0's first intensity and depth frame
and b), so one ``--seed`` gives one rig in ``warm_up`` and in ``judge``.
The other streams' recordings stay in host memory from the set-up to the
check (``release`` leaves them).

The check (``judge``): ``check_pairs / B`` frame pairs of each stream
(recording frames i - 1 -> i of one pass), drawn from the seed among the
pairs the window completed within one pass, their relative poses against
the plain reference (``reference/tracker``) aligning the same raw frames
in float64 with the constant-velocity warm start, stream by stream
(``entries/camera_tracker``'s ``reference_poses`` and ``gaps``).  The
numbers compared are the 90th percentiles of the translation and rotation
gaps over all the pairs (``limits/<cell>.json``, PERF.md): one stream gone
wrong is a B-th of the pairs and moves them.
"""

from __future__ import annotations

import copy
import hashlib
import sys

import numpy as np
import torch

# a program without the per-frame lockstep tracker cannot run this cell: it
# fails here, as the harness loads the entry
from dvo_slam_tpu_torch.parallel.multistream import LockstepTracker

from slam_bench import manifest, program, traffic as traffic_mod

_ct = manifest.entry("camera_tracker")  # the reference's pairs and gaps

WARM_UP_FRAMES = 6  # every level's graphs at B captured before the window

# stream 0's identity -> the other streams' recordings (host memory)
_rigs: dict = {}


def streams_of(config: dict) -> int:
    return len(config["streams"])


def stream_seed(rec, b: int) -> int:
    """Stream b's noise seed: the first 56 bits of sha256 over stream 0's
    first intensity and depth frame and b."""
    h = hashlib.sha256(np.ascontiguousarray(rec.intensity[0]).tobytes())
    h.update(np.ascontiguousarray(rec.depth[0]).tobytes())
    h.update(int(b).to_bytes(4, "little"))
    return int.from_bytes(h.digest()[:7], "little")


def stream_config(config: dict, b: int) -> dict:
    """The configuration with stream b's loop and speeds in its place."""
    out = copy.deepcopy(config)
    s = config["streams"][b]
    out["loop"] = dict(s["loop"])
    out["sequence"] = {**config["sequence"], "name": s["name"],
                       "mean_translational_speed_m_s": s["mean_translational_speed_m_s"],
                       "mean_angular_speed_deg_s": s["mean_angular_speed_deg_s"]}
    return out


def _key(config: dict, rec) -> tuple:
    return (stream_seed(rec, 0), len(rec.intensity), tuple(rec.intensity.shape[1:]),
            repr(config["streams"]))


def rig(config: dict, rec, device) -> list:
    """The rig's B recordings, stream 0 ``rec``: the others rendered once
    (``traffic.make_recording`` on ``stream_config``) and kept."""
    key = _key(config, rec)
    if key not in _rigs:
        _rigs.clear()
        _rigs[key] = [traffic_mod.make_recording(stream_config(config, b), len(rec.intensity),
                                                 stream_seed(rec, b), device)
                      for b in range(1, streams_of(config))]
    return [rec] + _rigs[key]


class Entry:
    def __init__(self, config: dict, device):
        self.config = config
        self.tracker = LockstepTracker(program.tracker_config(config), program.intrinsics(config),
                                       streams_of(config), device=device)
        self.others = next(iter(_rigs.values())) if _rigs else []
        self.rate = float(config["sequence"]["rate_hz"])

    def start_pass(self):
        self.tracker.reset()

    def ingest(self, intensity_u8, depth_u16, stamp: float):
        i = int(round(stamp * self.rate))
        return self.tracker.make_frames_raw(
            [intensity_u8] + [r.intensity[i % len(r.intensity)] for r in self.others],
            [depth_u16] + [r.depth[i % len(r.depth)] for r in self.others], stamp)

    def update(self, frame) -> np.ndarray:
        return self.tracker.update(frame)

    def info(self) -> dict:
        """``levels``: the lockstep loop's iterations of the rig frame just
        tracked per level, coarse first (its slowest stream's: the batched
        evaluations it ran); ``stream_levels``: each stream's own."""
        r = self.tracker.last_result
        if r is None:
            return {}
        per = np.stack([s.iterations.numpy() for s in r.level_stats], axis=1)  # [B, levels]
        return {"levels": tuple(int(x) for x in per.max(axis=0)),
                "stream_levels": tuple(tuple(int(x) for x in row) for row in per)}

    def counters(self) -> dict:
        from dvo_slam_tpu_torch.ops import ingest

        return {**program.kernel_launches(), "ingest": ingest.ingest_cuda.pyramid_launches}

    def timers(self) -> dict:
        """The tracker's counts since it was made (the window's): rig frames,
        and by level the lockstep loop's stream-steps and the streams' own
        iterations."""
        return {"counts": self.tracker.counts()}

    def finish(self):
        return None

    def coverage_line(self, run, tr) -> str:
        before, after = run.counters["before"], run.counters["after"]
        seen = len(tr.device_events(run.trace, program.KERNEL_NAMES[0]))
        ingest_seen = len(tr.device_events(run.trace, "pyramid_kernel"))
        return (f"slam_bench: profiler coverage: kernel 1b evaluations seen by the profiler "
                f"{seen}, run by the program's counters {after['kernel1b'] - before['kernel1b']}; "
                f"ingest launches of kernel A seen {ingest_seen}, run "
                f"{after['ingest'] - before['ingest']}")


def warm_up(config: dict, traffic: dict, rec, device, frames: int = WARM_UP_FRAMES):
    """Render the rig's other streams, then track the recording's first
    rig frames on a throwaway tracker: the match graph at B and the ingest
    kernels are built before the window."""
    rig(config, rec, device)
    entry = Entry(config, device)
    entry.start_pass()
    for i in range(min(frames, len(rec.intensity))):
        entry.update(entry.ingest(rec.intensity[i], rec.depth[i], float(rec.stamps[i])))


def setup_counts() -> dict:
    stats = program.graph_stats()
    return {"graph_keys": stats["keys"], "capture_ms": float(stats["capture_ms"])}


def release():
    program.release_graphs()


def sample_pairs(frames, streams: int, per_stream: int, seed: int):
    """For each stream b, (recording index i, the program's relative pose of
    stream b's pair i - 1 -> i, the pass it came from) for ``per_stream``
    distinct indices drawn from (seed, b) among the pairs the window
    completed within one pass (the first pass that has each)."""
    poses = {(f.pass_no, f.index): f.pose for f in frames}
    found = {}
    for (p, i), pose in sorted(poses.items()):
        prev = poses.get((p, i - 1))
        if i >= 1 and i not in found and pose is not None and prev is not None:
            found[i] = (np.linalg.inv(prev) @ pose, p)
    keys = sorted(found)
    out = []
    for b in range(streams):
        rng = np.random.default_rng([int(seed) % (1 << 63), b])
        pick = (np.sort(rng.choice(keys, size=min(per_stream, len(keys)), replace=False))
                if keys else [])
        out.append([(int(i), found[int(i)][0][b], found[int(i)][1]) for i in pick])
    return out


def reference_pairs(config: dict, recs, picks, device, **precision):
    """The reference's relative poses [n, 4, 4] and iterations [n, levels]
    of each stream's picked pairs (``picks[b]``: recording indices),
    stream by stream, concatenated in stream order."""
    poses, its = [], []
    for b, idx in enumerate(picks):
        if len(idx):
            p, k = _ct.reference_poses(stream_config(config, b), recs[b], list(idx), device,
                                       **precision)
            poses.append(p)
            its.append(k)
    if not poses:
        return np.zeros((0, 4, 4)), np.zeros((0, 0), np.int64)
    return np.concatenate(poses), np.concatenate(its)


def judge(config: dict, traffic: dict, limits: dict, rec, frames, outputs, seed: int,
          device) -> list:
    streams = streams_of(config)
    recs = rig(config, rec, device)
    picked = sample_pairs(frames, streams, max(1, int(traffic["check_pairs"]) // streams), seed)
    pairs = [(b, i, pose, p) for b, part in enumerate(picked) for i, pose, p in part]
    if not pairs:
        return [{"name": "pairs_checked", "value": 0, "limit": -1}]
    mine = np.stack([pose for _, _, pose, _ in pairs])
    theirs, ref_its = reference_pairs(config, recs, [[i for i, _, _ in part] for part in picked],
                                      device)
    t, r = _ct.gaps(mine, theirs)
    levels = {(f.pass_no, f.index): f.info.get("stream_levels", ()) for f in frames}
    for j in np.argsort(-t)[:3]:
        b, i, _, p = pairs[j]
        program_its = list(levels.get((p, i), ())[b]) if levels.get((p, i)) else []
        print(f"slam_bench: stream {b} pair {i}: gap t {t[j]:.3e} m, r {r[j]:.3e} rad; "
              f"iterations per level: program {program_its}, reference {ref_its[j].tolist()}",
              file=sys.stderr)
    truth = np.stack([np.linalg.inv(recs[b].poses[i - 1]) @ recs[b].poses[i]
                      for b, i, _, _ in pairs])
    tt, _ = _ct.gaps(mine, truth)
    rt, _ = _ct.gaps(theirs, truth)
    by_stream = " ".join(f"{b}:{np.median(t[[k for k, q in enumerate(pairs) if q[0] == b]]):.2e}"
                         for b in range(streams) if any(q[0] == b for q in pairs))
    print(f"slam_bench: {len(pairs)} pairs checked over {streams} streams; gap median t "
          f"{np.median(t):.3e} m, r {np.median(r):.3e} rad (t by stream {by_stream}); against "
          f"the ground truth: program {np.median(tt):.3e} m, reference {np.median(rt):.3e} m "
          f"(medians)", file=sys.stderr)
    return [{"name": name, "value": float(np.percentile(v, 90)), "limit": float(limits[name])}
            for name, v in (("pose_gap_t_p90_m", t), ("pose_gap_r_p90_rad", r))]
