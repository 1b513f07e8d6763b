"""The lockstep multi-stream tracker on the card: 3 streams x 6 frames at
640x480 (``benchmark_config().tracker``).  Every lockstep iteration is one
call of the batched folded kernel (``dvo_warp_fused_stats`` on [B, ...])
and none of the single-stream one, of the sampled-input kernels or of
``warp_and_sample_cm``; per stream, frame and level the iterations and
terminations are the sequential schedule's (the single-stream folded
kernel), and the poses agree within 1e-3 (tests/test_parallel.py).  The
per-frame lockstep tracker (``LockstepTracker``) keeps the bits of the
plain-chain loop the schedule ran before, takes one match-graph launch and
one launch of each ingest kernel a rig frame, and its host poses are the
schedule's."""

import numpy as np
import pytest
import torch

from dvo_slam_tpu_torch import benchmark_config
from dvo_slam_tpu_torch.models import irls_graph
from dvo_slam_tpu_torch.ops import fused_kernels, residuals
from dvo_slam_tpu_torch.ops.camera import TUM_FR1
from dvo_slam_tpu_torch.parallel.multistream import as_frames, make_multistream_tracker
from dvo_slam_tpu_torch.tools import driver_launches
from dvo_slam_tpu_torch.tools.multistream_bench import render_streams, stream_ates

pytestmark = pytest.mark.cuda

CFG = benchmark_config().tracker


@pytest.fixture(scope="module")
def streams():
    intensity, depth, gt = render_streams(3, 6)
    return (*as_frames(intensity, depth, "cuda"), gt)


def test_lockstep_runs_the_batched_kernel(streams):
    d_i, d_d, gt = streams
    counters = (fused_kernels.warp_fused_stats_cuda, fused_kernels.warp_fused_stats_batched_cuda,
                fused_kernels.fused_stats_cuda, fused_kernels.fused_stats_batched_cuda)
    driver_launches.reset_counts()
    lock = make_multistream_tracker(CFG, TUM_FR1).tracks(d_i, d_d)
    irls_graph.fold_counts()  # the while graphs' launches, counted on the card
    assert fused_kernels.warp_fused_stats_batched_cuda.launches == lock.loop_iterations > 0
    assert [w.launches for w in counters[:1] + counters[2:]] == [0, 0, 0]
    assert residuals.warp_and_sample_cm.calls == 0
    assert max(stream_ates(lock.poses.cpu().numpy(), gt)) < 0.01

    seq = make_multistream_tracker(CFG, TUM_FR1, schedule="sequential").tracks(d_i, d_d)
    irls_graph.fold_counts()
    assert fused_kernels.warp_fused_stats_cuda.launches == seq.loop_iterations
    assert residuals.warp_and_sample_cm.calls == 0
    assert torch.equal(lock.iterations, seq.iterations)
    assert torch.equal(lock.termination, seq.termination)
    rel = np.linalg.inv(seq.poses.cpu().numpy().astype(np.float64)) @ lock.poses.cpu().numpy()
    assert np.abs(rel - np.eye(4)).max() < 1e-3


def _old_track_streams(cfg, intrinsics, intensity_u8, depth_u16):
    """The lockstep schedule as it ran before the per-frame tracker: the
    plain ingest chain on card tensors and ``match_prepared`` (a verbatim
    copy), for the bits the tracker must keep."""
    from dvo_slam_tpu_torch.models.dense_tracker import (match_prepared, prepare_frame,
                                                         ref_artifacts)
    from dvo_slam_tpu_torch.odometry import build_frame

    batch, frames = intensity_u8.shape[:2]
    eye = torch.eye(4, dtype=torch.float32, device=intensity_u8.device).expand(batch, 4, 4)
    prev = ref_artifacts(
        prepare_frame(cfg, intrinsics, build_frame(cfg, intensity_u8[:, 0], depth_u16[:, 0])))
    pose, rel = eye, eye
    poses, iterations, terminations = [], [], []
    for t in range(1, frames):
        cur = prepare_frame(cfg, intrinsics, build_frame(cfg, intensity_u8[:, t], depth_u16[:, t]))
        result = match_prepared(cfg, intrinsics, prev, cur, rel)
        rel = result.transformation
        pose = pose @ rel
        poses.append(pose)
        iterations.append(torch.stack([s.iterations for s in result.level_stats], dim=-1))
        terminations.append(torch.stack([s.termination for s in result.level_stats], dim=-1))
        prev = ref_artifacts(cur)
    return torch.stack(poses, dim=1), torch.stack(iterations, dim=1), torch.stack(terminations, 1)


def test_the_per_frame_tracker_keeps_the_bits_and_takes_the_kernels(streams):
    """The lockstep schedule, now frame by frame through ``LockstepTracker``
    with the batched ingest kernels, gives the bits of the plain-chain loop
    it replaced; a rig frame's update is one match-graph launch (no match
    level by level) and its ingest one launch of each ingest kernel; the
    host poses of ``update`` are the schedule's."""
    from dvo_slam_tpu_torch.ops import ingest
    from dvo_slam_tpu_torch.parallel.multistream import LockstepTracker

    d_i, d_d, _ = streams
    old = _old_track_streams(CFG, TUM_FR1, d_i, d_d)
    lock = make_multistream_tracker(CFG, TUM_FR1).tracks(d_i, d_d)
    for a, b in zip(old, lock[:3]):
        assert a.dtype == b.dtype and torch.equal(a, b)

    tracker = LockstepTracker(CFG, TUM_FR1, d_i.shape[0], device="cuda")
    host_i, host_d = d_i.cpu().numpy(), d_d.cpu().numpy().astype(np.uint16)
    for t in range(d_i.shape[1]):
        stats, a, b = (irls_graph.stats(), ingest.ingest_cuda.pyramid_launches,
                       ingest.ingest_cuda.pack_launches)
        frame = tracker.make_frames_raw(list(host_i[:, t]), list(host_d[:, t]), t / 30)
        assert (ingest.ingest_cuda.pyramid_launches - a, ingest.ingest_cuda.pack_launches - b) \
            == (1, 1)
        pose = tracker.update(frame)
        after = irls_graph.stats()
        assert after["per_level_matches"] == stats["per_level_matches"]
        assert after["match_graph_launches"] - stats["match_graph_launches"] == (t > 0)
        if t:
            assert np.array_equal(pose, lock.poses[:, t - 1].cpu().numpy().astype(np.float64))
            its = np.stack([s.iterations.numpy() for s in tracker.last_result.level_stats], 1)
            assert np.array_equal(its, lock.iterations[:, t - 1].cpu().numpy())
    counts = tracker.counts()
    assert counts["frames"] == d_i.shape[1]
    assert sum(counts["iterations"].values()) == int(lock.iterations.sum())
    irls_graph.fold_counts()  # later tests read the launch counters from here
