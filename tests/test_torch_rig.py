"""The per-frame lockstep tracker (``parallel/multistream.LockstepTracker``)
on the CPU, at 60x80 with B = 3 streams of 8 frames rendered from a seed
along three loops of the rig cell's configuration (fr1 desk, xyz and rpy
speeds, each with its own sensor noise).

* It is the lockstep schedule: ``make_multistream_tracker(schedule=
  "lockstep")`` runs it, and both give the bits of the loop the schedule
  ran before (a verbatim copy below), poses, iterations and terminations.
* Each stream's iterations equal its solo run through ``match_pyramids``
  (the sequential schedule), its poses within 1e-6.
* Each stream agrees with the plain float64 reference
  (``slam_bench/reference/tracker.py``) within the rig cell's limits.
* ``reset()`` replays a pass bit for bit.
* Its counts: the idle share of the lockstep loop's stream-steps is 0
  exactly when the streams are one stream three times, and above 0 when
  their speeds differ.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

from dvo_slam_tpu_torch.models.dense_tracker import match_prepared, prepare_frame, ref_artifacts
from dvo_slam_tpu_torch.odometry import build_frame
from dvo_slam_tpu_torch.parallel import multistream as t_ms
from slam_bench import manifest, program, traffic

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, FRAMES, FACTOR = 3, 8, 8  # 480x640 / 8 = 60x80
SEED = 2**31 + 2024


def _config():
    with open(os.path.join(REPO, "slam_bench/configs/tum_fr1_rig8_lockstep.json")) as f:
        config = json.load(f)
    config = copy.deepcopy(config)
    config["sequence"]["shape"] = [s // FACTOR for s in config["sequence"]["shape"]]
    config["sequence"]["frames"] = FRAMES
    for key in ("fx", "fy", "ox", "oy"):
        config["intrinsics"][key] /= FACTOR
    config["tracker"].update(first_level=2, last_level=0, max_iterations_per_level=30)
    config["streams"] = config["streams"][:B]
    return config


CONFIG = _config()
CFG = program.tracker_config(CONFIG)
K = program.intrinsics(CONFIG)
RIG = manifest.entry("rig_tracker")


@pytest.fixture(scope="module")
def recs():
    rec = traffic.make_recording(CONFIG, FRAMES, SEED, torch.device("cpu"))
    return RIG.rig(CONFIG, rec, torch.device("cpu"))


def _frames(recs):
    """u8 intensity and int32 depth [B, T, H, W] tensors."""
    return (torch.from_numpy(np.stack([r.intensity for r in recs])),
            torch.from_numpy(np.stack([r.depth for r in recs]).astype(np.int32)))


def _old_track_streams(cfg, intrinsics, intensity_u8, depth_u16):
    """The lockstep schedule's loop before the per-frame tracker, verbatim."""
    batch, frames = intensity_u8.shape[:2]
    device = intensity_u8.device
    eye = torch.eye(4, dtype=torch.float32, device=device).expand(batch, 4, 4)
    prev = ref_artifacts(
        prepare_frame(cfg, intrinsics, build_frame(cfg, intensity_u8[:, 0], depth_u16[:, 0]))
    )
    pose, rel = eye, eye
    poses, iterations, terminations = [], [], []
    for t in range(1, frames):
        cur = prepare_frame(cfg, intrinsics, build_frame(cfg, intensity_u8[:, t], depth_u16[:, t]))
        result = match_prepared(cfg, intrinsics, prev, cur, rel)
        rel = result.transformation
        pose = pose @ rel
        poses.append(pose)
        its, terms = t_ms._level_counts(result)
        iterations.append(its)
        terminations.append(terms)
        prev = ref_artifacts(cur)
    iterations = torch.stack(iterations, dim=1)
    loop = int(iterations.amax(dim=0).sum())
    return t_ms.StreamTracks(torch.stack(poses, dim=1), iterations,
                             torch.stack(terminations, dim=1), loop)


def _pass(tracker, recs):
    """One pass of the host frames through ``make_frames_raw`` + ``update``:
    the poses [T, B, 4, 4] and each update's per-stream iterations."""
    poses, its = [], []
    for t in range(FRAMES):
        frame = tracker.make_frames_raw([r.intensity[t] for r in recs],
                                        [r.depth[t] for r in recs], t / 30)
        poses.append(tracker.update(frame))
        r = tracker.last_result
        its.append(None if t == 0 else
                   np.stack([s.iterations.numpy() for s in r.level_stats], axis=1))
    return np.stack(poses), its


def test_the_tracker_is_the_lockstep_schedule(recs):
    d_i, d_d = _frames(recs)
    old = _old_track_streams(CFG, K, d_i, d_d)
    new = t_ms.make_multistream_tracker(CFG, K, device="cpu").tracks(d_i, d_d)
    for a, b in zip(old[:3], new[:3]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert old.loop_iterations == new.loop_iterations
    tracker = t_ms.LockstepTracker(CFG, K, B, device="cpu")
    poses, its = _pass(tracker, recs)
    assert np.array_equal(poses[0], np.tile(np.eye(4), (B, 1, 1)))
    assert np.array_equal(poses[1:], new.poses.transpose(0, 1).numpy().astype(np.float64))
    for t in range(1, FRAMES):
        assert np.array_equal(its[t], new.iterations[:, t - 1].numpy())


def test_each_stream_is_its_solo_run(recs):
    d_i, d_d = _frames(recs)
    lock = t_ms.make_multistream_tracker(CFG, K, device="cpu").tracks(d_i, d_d)
    solo = t_ms.make_multistream_tracker(CFG, K, schedule="sequential",
                                         device="cpu").tracks(d_i, d_d)
    assert torch.equal(lock.iterations, solo.iterations)
    assert torch.equal(lock.termination, solo.termination)
    assert float((lock.poses - solo.poses).abs().max()) < 1e-6
    # the streams differ: the lockstep loop ran past some stream on some level
    assert lock.loop_iterations < int(lock.iterations.sum())
    assert int(lock.iterations.amax(dim=0).sum()) * B > int(lock.iterations.sum())


def test_each_stream_agrees_with_the_plain_reference(recs):
    with open(os.path.join(REPO, "slam_bench/limits/rig8_lockstep.recorded.json")) as f:
        limits = json.load(f)
    tracker = t_ms.LockstepTracker(CFG, K, B, device="cpu")
    poses, _ = _pass(tracker, recs)
    idx = list(range(1, FRAMES))
    mine = np.concatenate([[np.linalg.inv(poses[i - 1, b]) @ poses[i, b] for i in idx]
                           for b in range(B)])
    theirs, _ = RIG.reference_pairs(CONFIG, recs, [idx] * B, torch.device("cpu"))
    t, r = RIG._ct.gaps(mine, theirs)
    assert float(np.percentile(t, 90)) < limits["pose_gap_t_p90_m"]
    assert float(np.percentile(r, 90)) < limits["pose_gap_r_p90_rad"]


def test_reset_replays_a_pass(recs):
    tracker = t_ms.LockstepTracker(CFG, K, B, device="cpu")
    first, its_first = _pass(tracker, recs)
    tracker.reset()
    assert tracker.last_result is None
    again, its_again = _pass(tracker, recs)
    assert np.array_equal(first, again)
    for a, b in zip(its_first[1:], its_again[1:]):
        assert np.array_equal(a, b)
    counts = tracker.counts()
    assert counts["frames"] == 2 * FRAMES  # reset keeps the counts
    steps = sum(counts["stream_steps"].values())
    done = sum(counts["iterations"].values())
    assert done == 2 * sum(int(a.sum()) for a in its_first[1:])
    assert steps == 2 * B * sum(int(a.max(axis=0).sum()) for a in its_first[1:])


def _idle_share(tracker) -> float:
    c = tracker.counts()
    return 1.0 - sum(c["iterations"].values()) / sum(c["stream_steps"].values())


def test_the_idle_share_of_the_lockstep_loop(recs):
    same = t_ms.LockstepTracker(CFG, K, B, device="cpu")
    _pass(same, [recs[0]] * B)
    assert _idle_share(same) == 0.0
    mixed = t_ms.LockstepTracker(CFG, K, B, device="cpu")
    _pass(mixed, recs)
    assert _idle_share(mixed) > 0.0
    assert set(same.counts()["stream_steps"]) == {2, 1, 0}
