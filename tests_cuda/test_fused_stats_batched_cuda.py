"""The batched fused-stats entry point (``dvo_fused_stats_batched``) on the
card: each stream's outputs bit-equal to the single-stream kernel
(``dvo_fused_stats``) on that stream's packs, with per-stream precisions
and flags; against the plain twin per stream as ``tools/fused_check.py``
holds the single-stream kernel.

Inputs are the real ``sampled``/``refpack`` of four rendered 640x480
streams' first pairs at levels 3, 2 and 1.
"""

import numpy as np
import pytest
import torch

from dvo_slam_tpu_torch import benchmark_config, odometry
from dvo_slam_tpu_torch.ops import fused_kernels
from dvo_slam_tpu_torch.ops.camera import TUM_FR1
from dvo_slam_tpu_torch.tools import fused_check
from dvo_slam_tpu_torch.tools.multistream_bench import render_streams

pytestmark = pytest.mark.cuda

CFG = benchmark_config().tracker
STREAMS = 4


@pytest.fixture(scope="module")
def batched_inputs():
    intensity, depth, _ = render_streams(STREAMS, 2)
    per_stream = []
    for b in range(STREAMS):
        d_i, d_d = odometry.upload_sequence(intensity[b], depth[b], "cuda")
        pair = [odometry.build_frame(CFG, d_i[k], d_d[k]) for k in (0, 1)]
        per_stream.append(fused_check.level_inputs(CFG, TUM_FR1, pair[0], pair[1]))
    out = {}
    for level in per_stream[0]:
        sampled = torch.stack([s[level][0] for s in per_stream]).contiguous()
        refpack = torch.stack([s[level][1] for s in per_stream]).contiguous()
        out[level] = (sampled, refpack, per_stream[0][level][2])
    return out


def _stream(stats, b):
    return type(stats)(*(f[b] for f in stats))


@pytest.mark.parametrize("first", ["0", "1", "per-stream"])
@pytest.mark.parametrize("level", [3, 2, 1])
def test_batched_kernel_bit_equal_per_stream(batched_inputs, level, first):
    sampled, refpack, k = batched_inputs[level]
    scale = 1.0 + 0.1 * torch.arange(STREAMS, dtype=torch.float32, device="cuda")
    p3 = torch.tensor(fused_check.CHECK_PRECISION, device="cuda") * scale[:, None]
    if first == "per-stream":
        flags = (torch.arange(STREAMS, device="cuda") % 2).to(torch.int32)
    else:
        flags = torch.tensor(int(first), dtype=torch.int32, device="cuda")
    dof = CFG.influence_function_param
    before = fused_kernels.fused_stats_batched_cuda.launches
    kernel = fused_kernels.fused_stats_batched_cuda(sampled, refpack, p3, flags, k, dof)
    again = fused_kernels.fused_stats_batched_cuda(sampled, refpack, p3, flags, k, dof)
    twin = fused_kernels.fused_stats_plain(sampled, refpack, p3, flags, k, dof)
    torch.cuda.synchronize()
    assert fused_kernels.fused_stats_batched_cuda.launches == before + 2
    fused_check.assert_bit_identical(kernel, again)
    for b in range(STREAMS):
        flag = flags[b] if flags.dim() else flags
        single = fused_kernels.fused_stats_cuda(sampled[b], refpack[b], p3[b], flag, k, dof)
        mine = _stream(kernel, b)
        for field, x, y in zip(mine._fields, mine, single):
            assert torch.equal(x.view(torch.int32), y.view(torch.int32)), (b, field)
        fused_check.compare_fused_stats(mine, _stream(twin, b))


def test_dispatch_takes_the_batched_kernel(batched_inputs):
    sampled, refpack, k = batched_inputs[1]
    p3 = torch.tensor(fused_check.CHECK_PRECISION, device="cuda").expand(STREAMS, 3)
    flag = torch.tensor(0, dtype=torch.int32, device="cuda")
    before = fused_kernels.fused_stats_batched_cuda.launches
    single_before = fused_kernels.fused_stats_cuda.launches
    stats = fused_kernels.fused_stats(sampled, refpack, p3, flag, k)
    assert fused_kernels.fused_stats_batched_cuda.launches == before + 1
    assert fused_kernels.fused_stats_cuda.launches == single_before
    assert stats.log_sum.shape == (STREAMS,) and np.isfinite(stats.log_sum.cpu().numpy()).all()


def test_batched_wrapper_rejects_bad_inputs(batched_inputs):
    sampled, refpack, k = batched_inputs[2]
    p3 = torch.tensor(fused_check.CHECK_PRECISION, device="cuda").expand(STREAMS, 3)
    flag = torch.tensor(0, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match=r"\[B, 8, N\]"):
        fused_kernels.fused_stats_batched_cuda(sampled[0], refpack[0], p3, flag, k)
    with pytest.raises(ValueError, match="precision3"):
        fused_kernels.fused_stats_batched_cuda(sampled, refpack, p3[:2], flag, k)
    with pytest.raises(ValueError, match="contiguous"):
        fused_kernels.fused_stats_batched_cuda(sampled[:, :, ::2], refpack[:, :, ::2], p3, flag, k)
