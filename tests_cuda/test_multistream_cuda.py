"""The lockstep multi-stream tracker on the card: 3 streams x 6 frames at
640x480 (``benchmark_config().tracker``).  Every lockstep iteration is one
call of the batched kernel and none of the single-stream kernel; per
stream, frame and level the iterations and terminations are the
sequential schedule's (the single-stream kernel), and the poses agree
within 1e-3 (tests/test_parallel.py)."""

import numpy as np
import pytest
import torch

from dvo_slam_tpu_torch import benchmark_config
from dvo_slam_tpu_torch.ops import fused_kernels
from dvo_slam_tpu_torch.ops.camera import TUM_FR1
from dvo_slam_tpu_torch.parallel.multistream import as_frames, make_multistream_tracker
from dvo_slam_tpu_torch.tools.multistream_bench import render_streams, stream_ates

pytestmark = pytest.mark.cuda

CFG = benchmark_config().tracker


@pytest.fixture(scope="module")
def streams():
    intensity, depth, gt = render_streams(3, 6)
    return (*as_frames(intensity, depth, "cuda"), gt)


def test_lockstep_runs_the_batched_kernel(streams):
    d_i, d_d, gt = streams
    fused_kernels.fused_stats_cuda.launches = 0
    fused_kernels.fused_stats_batched_cuda.launches = 0
    lock = make_multistream_tracker(CFG, TUM_FR1).tracks(d_i, d_d)
    assert fused_kernels.fused_stats_batched_cuda.launches == lock.loop_iterations > 0
    assert fused_kernels.fused_stats_cuda.launches == 0
    assert max(stream_ates(lock.poses.cpu().numpy(), gt)) < 0.01

    seq = make_multistream_tracker(CFG, TUM_FR1, schedule="sequential").tracks(d_i, d_d)
    assert fused_kernels.fused_stats_cuda.launches == seq.loop_iterations
    assert torch.equal(lock.iterations, seq.iterations)
    assert torch.equal(lock.termination, seq.termination)
    rel = np.linalg.inv(seq.poses.cpu().numpy().astype(np.float64)) @ lock.poses.cpu().numpy()
    assert np.abs(rel - np.eye(4)).max() < 1e-3
