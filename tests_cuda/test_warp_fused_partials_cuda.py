"""The pixel-sharded evaluation's three launches
(``dvo_warp_fused_partials``, ``dvo_sharded_loglik``, ``dvo_sharded_tail``)
against their plain versions on the card: the check of ``chip_smoke.py``'s
phase 3 (``tools/fused_check.py``), rerunnable with pytest.

Inputs are the real refpack and quad table of a rendered 640x480 pair of
the occluded scene at levels 3, 2 and 1, warped by a small twist, cut into
the blocks of 1, 2, 4 and 7 ranks (7 pads the last block).  Every rank's
evaluation runs on the one card, the blocks' sums added in rank order
where the ranks all-reduce.  Per block the stash (r_I, r_Z, gate) bit-equal
to the plain version's (held to the gate equal and atol 1e-6) and the 136
sums element-wise within rtol 1e-6 of the float64 Gram of the plain
version's float32 rows; n, the precision, ll, A and b as
``compare_warp_fused_stats`` holds them; every rank the same bits; two
runs bit-identical.
"""

import pytest
import torch

from dvo_slam_tpu_torch import benchmark_config, odometry
from dvo_slam_tpu_torch.ops import fused_kernels, residuals
from dvo_slam_tpu_torch.ops.camera import TUM_FR1
from dvo_slam_tpu_torch.tools import fused_check
from dvo_slam_tpu_torch.utils import synthetic

pytestmark = pytest.mark.cuda

CFG = benchmark_config().tracker
DOF = CFG.influence_function_param
CUDA_STEPS = (fused_kernels.warp_fused_partials_cuda, fused_kernels.sharded_loglik_cuda,
              fused_kernels.sharded_tail_cuda)
PLAIN_STEPS = (fused_kernels.warp_fused_partials_plain, fused_kernels.sharded_loglik_plain,
               fused_kernels.sharded_tail_plain)


@pytest.fixture(scope="module")
def level_inputs():
    poses = synthetic.circular_trajectory(100, radius=0.15, rot_amplitude=0.12, z_amplitude=0.05)
    intensity, depth = odometry.render_sequence(
        poses[:2], (480, 640), TUM_FR1, scene=synthetic.occluded_scene()
    )
    d_i, d_d = odometry.upload_sequence(intensity, depth, "cuda")
    frames = [odometry.build_frame(CFG, d_i[k], d_d[k]) for k in (0, 1)]
    return fused_check.warp_level_inputs(CFG, TUM_FR1, frames[0], frames[1])


def _common(inputs):
    P = torch.tensor([[4000.0, 10.0], [10.0, 1.5e5]], device="cuda")
    return (inputs.quad, inputs.shape, inputs.intrinsics, inputs.T, P)


@pytest.mark.parametrize("world", [1, 2, 4, 7])
@pytest.mark.parametrize("first", [0, 1])
@pytest.mark.parametrize("level", [3, 1])
def test_kernels_match_plain(level_inputs, level, first, world):
    inputs = level_inputs[level]
    common = _common(inputs)
    blocks = fused_check.shard_blocks(inputs.refpack, world)
    before = [step.launches for step in CUDA_STEPS]
    calls = residuals.warp_and_sample_cm.calls
    results, evaluations, own, total = fused_check.sharded_on_one_device(
        CUDA_STEPS, blocks, *common, bool(first), DOF)
    assert [step.launches for step in CUDA_STEPS] == [count + world for count in before]
    assert residuals.warp_and_sample_cm.calls == calls
    again = fused_check.sharded_on_one_device(CUDA_STEPS, blocks, *common, bool(first), DOF)
    plain, _, plain_own, plain_total = fused_check.sharded_on_one_device(
        PLAIN_STEPS, blocks, *common, bool(first), DOF)
    torch.cuda.synchronize()
    fused_check.assert_bit_identical((*results[0], own, total), (*again[0][0], again[2], again[3]))
    for rank, block in enumerate(blocks):
        stash = fused_kernels.sharded_stash(evaluations[rank])
        assert torch.equal(stash, fused_kernels.sharded_stash(again[1][rank]))
        _, not_bit_equal = fused_check.compare_stash(
            stash, fused_check.twin_sharded_stash(block, *common, bool(first), DOF), gate="gate")
        assert not_bit_equal == 0
        if float(plain_own[rank][135]) > 0:
            fused_check.compare_packed_sums(
                own[rank], fused_check.warp_exact_gram(block, *common, bool(first), DOF),
                plain_own[rank][135])
        for x, y in zip(results[rank], results[0]):
            assert torch.equal(x.view(torch.int32), y.view(torch.int32))
    assert float(total[135]) == float(plain_total[135])
    fused_check.compare_warp_fused_stats(results[0], plain[0])
    assert int(results[0].n) > 0.3 * inputs.refpack.shape[1]


def test_padded_block_is_masked(level_inputs):
    """The last of 7 blocks ends in zero-padded columns: gate 0, residuals
    0, finite sums."""
    inputs = level_inputs[3]
    blocks = fused_check.shard_blocks(inputs.refpack, 7)
    pad = 7 * blocks[0].shape[1] - inputs.refpack.shape[1]
    assert pad > 0
    evaluation = fused_kernels.warp_fused_partials_cuda(blocks[-1], *_common(inputs), False, DOF)
    stash = fused_kernels.sharded_stash(evaluation)
    assert not stash[:, -pad:].any() and torch.isfinite(evaluation.sums).all()


def test_wrapper_rejects_bad_inputs(level_inputs):
    inputs = level_inputs[2]
    quad, shape, k, T, P = _common(inputs)
    refpack = inputs.refpack
    with pytest.raises(ValueError, match="float32"):
        fused_kernels.warp_fused_partials_cuda(refpack.double(), quad, shape, k, T, P, False)
    with pytest.raises(ValueError, match="contiguous"):
        fused_kernels.warp_fused_partials_cuda(refpack[:, ::2], quad, shape, k, T, P, False)
    with pytest.raises(ValueError, match="quad"):
        fused_kernels.warp_fused_partials_cuda(refpack, quad[:, :-1].contiguous(), shape, k, T, P, False)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_kernels.warp_fused_partials_cuda(refpack, quad, shape, k, T.cpu(), P, False)
    with pytest.raises(ValueError, match="a shard of"):
        fused_kernels.warp_fused_partials_cuda(
            torch.cat([refpack, refpack], dim=1), quad, shape, k, T, P, False)
