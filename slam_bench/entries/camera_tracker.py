"""Entry adapter: live frame-to-frame odometry, the program's
``models/camera_tracker.CameraTracker`` (the reference's
``camera_dense_tracking``), one frame at a time through
``make_frame_raw`` + ``update``, whose accumulated pose comes back to the
host.  A new pass over a recording starts from ``reset()``.

The check (``judge``): the relative pose of a sample of the window's
frame pairs (recording frames i - 1 -> i of one pass), drawn from the
seed, against the plain reference (``reference/tracker``) aligning the same
raw frames in float64: pair (i - 2, i - 1) from the identity, then pair
(i - 1, i) from that result, the constant-velocity warm start the tracker
uses.  The numbers compared are the 90th percentiles of the translation
and rotation gaps over the sample (``limits/<cell>.json``): a pair on
which the program and the reference end a level one iteration apart (a
near tie in the termination test) parts by up to one increment, 1e-4, so
the widest gap reads the termination rule, not the arithmetic (PERF.md).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from slam_bench import program
from slam_bench.reference import tracker as ref

BLOCK = 16  # pairs the reference aligns at once


class Entry:
    def __init__(self, config: dict, device):
        from dvo_slam_tpu_torch.models.camera_tracker import CameraTracker

        self.tracker = CameraTracker(program.intrinsics(config), program.tracker_config(config),
                                     device=device)
        self.device = torch.device(device)

    def start_pass(self):
        self.tracker.reset()

    def ingest(self, intensity_u8, depth_u16, stamp: float):
        return self.tracker.make_frame_raw(intensity_u8, depth_u16, stamp)

    def update(self, frame) -> np.ndarray:
        return self.tracker.update(frame)

    def info(self) -> dict:
        """``levels``: the IRLS iterations of the frame just tracked, per
        level, coarse first."""
        r = self.tracker.last_result
        return {"levels": tuple(int(s.iterations) for s in r.level_stats)} if r is not None else {}

    def counters(self) -> dict:
        return program.kernel_launches()

    def timers(self) -> dict:
        return {}

    def finish(self):
        return None

    def coverage_line(self, run, tr) -> str:
        seen = len(tr.device_events(run.trace, program.KERNEL_NAMES[0]))
        ran = run.counters["after"]["kernel1"] - run.counters["before"]["kernel1"]
        return (f"slam_bench: profiler coverage: kernel 1 evaluations seen by the profiler "
                f"{seen}, run by the program's counters {ran}")


def warm_up(config: dict, traffic: dict, rec, device, frames: int = 6):
    """Track the recording's first frames on a throwaway tracker: every
    level's graphs are captured before the window."""
    entry = Entry(config, device)
    entry.start_pass()
    for i in range(frames):
        entry.update(entry.ingest(rec.intensity[i], rec.depth[i], float(rec.stamps[i])))


def setup_counts() -> dict:
    stats = program.graph_stats()
    return {"graph_keys": stats["keys"], "capture_ms": float(stats["capture_ms"])}


def release():
    program.release_graphs()


def sample_pairs(frames, n: int, seed: int):
    """(recording index i, the program's relative pose of pair i - 1 -> i)
    for ``n`` distinct indices drawn from ``seed`` among the pairs the
    window completed within one pass (the first pass that has each)."""
    poses = {(f.pass_no, f.index): f.pose for f in frames}
    found = {}
    for (p, i), pose in sorted(poses.items()):
        prev = poses.get((p, i - 1))
        if i >= 1 and i not in found and pose is not None and prev is not None:
            found[i] = np.linalg.inv(prev) @ pose
    keys = sorted(found)
    rng = np.random.default_rng(int(seed) % (1 << 63))
    pick = np.sort(rng.choice(keys, size=min(n, len(keys)), replace=False)) if keys else []
    return [(int(i), found[int(i)]) for i in pick]


def reference_poses(config: dict, rec, indices, device, dtype=torch.float64,
                    mm=torch.matmul, block: int = BLOCK):
    """The reference's relative pose of each pair i - 1 -> i [n, 4, 4] with
    the constant-velocity warm start, and its iterations per level [n,
    levels]; ``dtype`` and ``mm`` set its precision (the control: float32,
    ``ref.tf32_matmul``)."""
    s = ref.Settings.from_config(config["tracker"])
    k = rec.intrinsics
    out, its = [], []
    for start in range(0, len(indices), block):
        idx = np.asarray(indices[start:start + block])
        frames = np.concatenate([np.maximum(idx - 2, 0), idx - 1, idx])
        pyr = ref.pyramid(torch.from_numpy(rec.intensity[frames]).to(device),
                          torch.from_numpy(rec.depth[frames]).to(device),
                          (k.fx, k.fy, k.ox, k.oy), s.first_level + 1, dtype)
        n = len(idx)
        part = lambda a, b: [ref.Level(*(t[a:b] for t in lv[:-1]), K=lv.K) for lv in pyr]  # noqa: E731
        warm = ref.align(s, part(0, n), part(n, 2 * n), mm=mm).transformation
        eye = torch.eye(4, dtype=dtype, device=device).expand(n, 4, 4)
        first = torch.as_tensor(idx == 1, device=device)[:, None, None]
        init = torch.where(first, eye, warm)
        a = ref.align(s, part(n, 2 * n), part(2 * n, 3 * n), init, mm=mm)
        out.append(a.transformation.to(torch.float64).cpu())
        its.append(a.iterations.cpu())
    if not out:
        return np.zeros((0, 4, 4)), np.zeros((0, 0), np.int64)
    return torch.cat(out).numpy(), torch.cat(its).numpy()


def gaps(a: np.ndarray, b: np.ndarray):
    """Translation (m) and rotation (rad) gaps [n] between relative poses."""
    t, r = ref.relative_gap(torch.from_numpy(a), torch.from_numpy(b))
    return t.numpy(), r.numpy()


def judge(config: dict, traffic: dict, limits: dict, rec, frames, outputs, seed: int,
          device) -> list:
    pairs = sample_pairs(frames, int(traffic["check_pairs"]), seed)
    if not pairs:
        return [{"name": "pairs_checked", "value": 0, "limit": -1}]
    idx = [i for i, _ in pairs]
    mine = np.stack([p for _, p in pairs])
    theirs, ref_its = reference_poses(config, rec, idx, device)
    t, r = gaps(mine, theirs)
    levels = {}
    for f in frames:
        levels.setdefault(f.index, f.info.get("levels", ()))
    for j in np.argsort(-t)[:3]:
        print(f"slam_bench: pair {idx[j]}: gap t {t[j]:.3e} m, r {r[j]:.3e} rad; iterations per "
              f"level: program {list(levels.get(idx[j], ()))}, reference {ref_its[j].tolist()}",
              file=sys.stderr)
    truth = np.stack([np.linalg.inv(rec.poses[i - 1]) @ rec.poses[i] for i in idx])
    tt, _ = gaps(mine, truth)
    rt, _ = gaps(theirs, truth)
    print(f"slam_bench: {len(idx)} pairs checked; gap median t {np.median(t):.3e} m, "
          f"r {np.median(r):.3e} rad; against the ground truth: program {np.median(tt):.3e} m, "
          f"reference {np.median(rt):.3e} m (medians)", file=sys.stderr)
    return [{"name": name, "value": float(np.percentile(v, 90)), "limit": float(limits[name])}
            for name, v in (("pose_gap_t_p90_m", t), ("pose_gap_r_p90_rad", r))]
