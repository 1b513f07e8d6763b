"""The folded kernel (``dvo_warp_fused_stats``) against its plain version
on the card: the check of ``chip_smoke.py``'s phase 3 for the tracker's
evaluation (``tools/fused_check.py``), rerunnable with pytest.

Inputs are the real refpack and quad table of a rendered 640x480 pair of
the occluded scene at levels 3, 2 and 1, warped by a small twist, with
``first`` 0/1 and depth-buffered sampling on/off.  The stash (r_I, r_Z,
mask) bit-equal to the plain version's residuals and mask (held to atol
1e-6); the Gram element-wise within rtol 1e-6 of the float64 Gram of the
plain version's float32 rows; n, the precision, ll, A and b as
``compare_warp_fused_stats`` holds them; two runs bit-identical; B streams
in one call, depth-buffered or not, bit-equal per stream to one-stream
calls; the tracker runs only the folded kernel.
"""

import pytest
import torch

from dvo_slam_tpu_torch import benchmark_config, odometry
from dvo_slam_tpu_torch.models.dense_tracker import match_pyramids
from dvo_slam_tpu_torch.ops import fused_kernels, residuals
from dvo_slam_tpu_torch.ops.camera import TUM_FR1
from dvo_slam_tpu_torch.tools import fused_check
from dvo_slam_tpu_torch.utils import synthetic

pytestmark = pytest.mark.cuda

CFG = benchmark_config().tracker
STREAMS = 4


@pytest.fixture(scope="module")
def frames():
    poses = synthetic.circular_trajectory(100, radius=0.15, rot_amplitude=0.12, z_amplitude=0.05)
    intensity, depth = odometry.render_sequence(
        poses[:STREAMS + 1], (480, 640), TUM_FR1, scene=synthetic.occluded_scene()
    )
    d_i, d_d = odometry.upload_sequence(intensity, depth, "cuda")
    return [odometry.build_frame(CFG, d_i[k], d_d[k]) for k in range(STREAMS + 1)]


@pytest.fixture(scope="module")
def level_inputs(frames):
    return fused_check.warp_level_inputs(CFG, TUM_FR1, frames[0], frames[1])


def _args(inputs, first, buffered, scale=1.0):
    P = torch.tensor([[4000.0, 10.0], [10.0, 1.5e5]], device="cuda") * scale
    return (*inputs, P, first, CFG.influence_function_param, buffered)


@pytest.mark.parametrize("buffered", [True, False])
@pytest.mark.parametrize("first", [0, 1])
@pytest.mark.parametrize("level", [3, 2, 1])
def test_kernel_matches_plain(level_inputs, level, first, buffered):
    args = _args(level_inputs[level], first, buffered)
    before = fused_kernels.warp_fused_stats_cuda.launches
    kernel, stats, stash = fused_kernels.warp_fused_stats_rows_cuda(*args)
    again = fused_kernels.warp_fused_stats_rows_cuda(*args)
    plain = fused_kernels.warp_fused_stats_plain(*args)
    torch.cuda.synchronize()
    assert fused_kernels.warp_fused_stats_cuda.launches == before + 2
    fused_check.assert_bit_identical(kernel, again[0])
    fused_check.assert_bit_identical((stash,), (again[2],))
    _, not_bit_equal = fused_check.compare_stash(stash, fused_check.twin_stash(*args))
    assert not_bit_equal == 0
    fused_check.compare_exact_gram(stats, fused_check.warp_exact_gram(*args))
    fused_check.compare_warp_fused_stats(kernel, plain)
    assert int(kernel.n) > 0.3 * args[0].shape[1]


@pytest.mark.parametrize("buffered", [True, False])
@pytest.mark.parametrize("first", [0, 1])
@pytest.mark.parametrize("level", [3, 1])
def test_batched_bit_equal_per_stream(frames, level, first, buffered):
    per_stream = [fused_check.warp_level_inputs(CFG, TUM_FR1, frames[b], frames[b + 1])[level]
                  for b in range(STREAMS)]
    stack = lambda field: torch.stack([getattr(s, field) for s in per_stream]).contiguous()  # noqa: E731
    P = torch.stack([_args(per_stream[0], first, True, 1.0 + 0.1 * b)[5] for b in range(STREAMS)])
    batched_args = (stack("refpack"), stack("quad"), per_stream[0].shape, per_stream[0].intrinsics,
                    stack("T"), P, first, CFG.influence_function_param, buffered)
    before = fused_kernels.warp_fused_stats_batched_cuda.launches
    batched, stats, stash = fused_kernels.warp_fused_stats_rows_cuda(*batched_args)
    assert fused_kernels.warp_fused_stats_batched_cuda.launches == before + 1
    plain = fused_kernels.warp_fused_stats_plain(*batched_args)
    fused_check.compare_warp_fused_stats(batched, plain)
    for b in range(STREAMS):
        one, one_stats, one_stash = fused_kernels.warp_fused_stats_rows_cuda(
            *per_stream[b], P[b], first, CFG.influence_function_param, buffered)
        _, not_bit_equal = fused_check.compare_stash(one_stash, fused_check.twin_stash(
            *per_stream[b], P[b], first, CFG.influence_function_param, buffered))
        assert not_bit_equal == 0
        fused_check.compare_exact_gram(one_stats, fused_check.warp_exact_gram(
            *per_stream[b], P[b], first, CFG.influence_function_param, buffered))
        for x, y in zip((*batched, stash), (*one, one_stash)):
            assert torch.equal(x[b].view(torch.int32), y.view(torch.int32))
        assert torch.equal(stats.m00[b], one_stats.m00)


def test_dispatch_takes_the_folded_kernel(level_inputs):
    args = _args(level_inputs[1], 0, True)
    before = (fused_kernels.warp_fused_stats_cuda.launches, residuals.warp_and_sample_cm.calls)
    result = fused_kernels.warp_fused_stats(*args)
    assert (fused_kernels.warp_fused_stats_cuda.launches, residuals.warp_and_sample_cm.calls) == (
        before[0] + 1, before[1])
    assert result.A.shape == (6, 6) and result.n.dtype == torch.int32 and result.A.is_cuda


def test_tracker_runs_only_the_folded_kernel(frames):
    for wrapper in (fused_kernels.warp_fused_stats_cuda, fused_kernels.fused_stats_cuda,
                    fused_kernels.fused_stats_batched_cuda):
        wrapper.launches = 0
    residuals.warp_and_sample_cm.calls = 0
    result = match_pyramids(CFG, TUM_FR1, frames[0], frames[1])
    iterations = sum(s.iterations for s in result.level_stats)
    assert fused_kernels.warp_fused_stats_cuda.launches == iterations > 0
    assert fused_kernels.fused_stats_cuda.launches == fused_kernels.fused_stats_batched_cuda.launches == 0
    assert residuals.warp_and_sample_cm.calls == 0
    assert torch.isfinite(result.transformation).all()


def test_wrapper_rejects_bad_inputs(level_inputs):
    refpack, quad, shape, k, T, P, first, dof, buffered = _args(level_inputs[2], 0, True)
    with pytest.raises(ValueError, match="float32"):
        fused_kernels.warp_fused_stats_cuda(refpack.double(), quad, shape, k, T, P, first)
    with pytest.raises(ValueError, match="contiguous"):
        fused_kernels.warp_fused_stats_cuda(refpack, quad.t().contiguous().t(), shape, k, T, P, first)
    with pytest.raises(ValueError, match=r"T must be \[4, 4\]"):
        fused_kernels.warp_fused_stats_cuda(refpack, quad, shape, k, T[:3], P, first)
    with pytest.raises(ValueError, match="quad"):
        fused_kernels.warp_fused_stats_cuda(refpack, quad[:8], shape, k, T, P, first)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_kernels.warp_fused_stats_cuda(refpack, quad, shape, k, T, P.cpu(), first)
