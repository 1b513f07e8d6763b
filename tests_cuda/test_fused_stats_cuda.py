"""The CUDA fused-stats kernel against its plain PyTorch twin on the card:
the check of ``chip_smoke.py``'s phase 3 (``tools/fused_check.py``),
rerunnable with pytest.

Inputs are the real ``sampled``/``refpack`` of a rendered 640x480 pair at
levels 3, 2 and 1.  ``num_valid`` equal; each Gram entry element-wise
within rtol 1e-6 of the float64 Gram of the same float32 rows, and within
1e-4 of sqrt(G_aa G_bb) of the float32 twin's; ``log_sum`` rtol 1e-5; and
two kernel runs bit-identical (the kernel has no float atomics:
fixed-order reductions only).
"""

import numpy as np
import pytest
import torch

from dvo_slam_tpu_torch import benchmark_config, odometry
from dvo_slam_tpu_torch.ops import fused_kernels
from dvo_slam_tpu_torch.ops.camera import TUM_FR1
from dvo_slam_tpu_torch.tools import fused_check
from dvo_slam_tpu_torch.utils import synthetic

pytestmark = pytest.mark.cuda

CFG = benchmark_config().tracker


@pytest.fixture(scope="module")
def level_inputs():
    poses = synthetic.circular_trajectory(100, radius=0.15, rot_amplitude=0.12, z_amplitude=0.05)
    intensity, depth = odometry.render_sequence(
        poses[:2], (480, 640), TUM_FR1, scene=synthetic.occluded_scene()
    )
    d_i, d_d = odometry.upload_sequence(intensity, depth, "cuda")
    pair = [odometry.build_frame(CFG, d_i[k], d_d[k]) for k in (0, 1)]
    return fused_check.level_inputs(CFG, TUM_FR1, pair[0], pair[1])


@pytest.mark.parametrize("first_iter", [0, 1])
@pytest.mark.parametrize("level", [3, 2, 1])
def test_kernel_matches_plain_twin(level_inputs, level, first_iter):
    sampled, refpack, k = level_inputs[level]
    p3 = torch.tensor(fused_check.CHECK_PRECISION, dtype=torch.float32, device="cuda")
    flag = torch.tensor(first_iter, dtype=torch.int32, device="cuda")
    args = (sampled, refpack, p3, flag, k, CFG.influence_function_param)
    before = fused_kernels.fused_stats_cuda.launches
    kernel = fused_kernels.fused_stats_cuda(*args)
    again = fused_kernels.fused_stats_cuda(*args)
    torch.cuda.synchronize()
    assert fused_kernels.fused_stats_cuda.launches == before + 2
    fused_check.assert_bit_identical(kernel, again)
    fused_check.compare_fused_stats(kernel, fused_kernels.fused_stats_plain(*args))
    fused_check.compare_exact_gram(kernel, fused_check.exact_gram(*args))
    assert float(kernel.num_valid) > 0.5 * sampled.shape[1]


def test_wrapper_rejects_bad_inputs(level_inputs):
    sampled, refpack, k = level_inputs[2]
    p3 = torch.tensor(fused_check.CHECK_PRECISION, dtype=torch.float32, device="cuda")
    flag = torch.tensor(0, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="float32"):
        fused_kernels.fused_stats_cuda(sampled.double(), refpack, p3, flag, k)
    with pytest.raises(ValueError, match="contiguous"):
        fused_kernels.fused_stats_cuda(sampled.t().contiguous().t(), refpack, p3, flag, k)
    with pytest.raises(ValueError, match=r"\[8, N\]"):
        fused_kernels.fused_stats_cuda(sampled[:, :-1].contiguous(), refpack, p3, flag, k)
    assert np.isfinite(float(fused_kernels.fused_stats_cuda(sampled, refpack, p3, flag, k).log_sum))
