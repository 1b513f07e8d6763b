"""The lockstep multi-stream tracker on the card: 3 streams x 6 frames at
640x480 (``benchmark_config().tracker``).  Every lockstep iteration is one
call of the batched folded kernel (``dvo_warp_fused_stats`` on [B, ...])
and none of the single-stream one, of the sampled-input kernels or of
``warp_and_sample_cm``; per stream, frame and level the iterations and
terminations are the sequential schedule's (the single-stream folded
kernel), and the poses agree within 1e-3 (tests/test_parallel.py)."""

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
