"""The CUDA fused-partials kernel against its plain PyTorch twin on the
card: the check of ``chip_smoke.py``'s phase 3 for the single-pass kernel
(``tools/fused_check.py``), rerunnable with pytest.

Inputs are the real ``sampled``/``refpack`` of a rendered 640x480 pair at
levels 3, 2 and 1.  ``num_valid`` equal; the mask row equal; r_I and r_Z
within atol 1e-6, w within rtol 1e-5 of the twin's rows (the reference's
Pallas-vs-twin tolerances); each Gram entry element-wise within rtol 1e-6
of the float64 Gram of the same float32 rows, and within 1e-4 of
sqrt(G_aa G_bb) of the float32 twin's; two kernel runs bit-identical.
"""

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


def _args(level_inputs, level, first_iter):
    sampled, refpack, k = level_inputs[level]
    p3 = torch.tensor(fused_check.CHECK_PRECISION, dtype=torch.float32, device="cuda")
    flag = torch.tensor(first_iter, dtype=torch.int32, device="cuda")
    return (sampled, refpack, p3, flag, k, CFG.influence_function_param)


@pytest.mark.parametrize("first_iter", [0, 1])
@pytest.mark.parametrize("level", [3, 2, 1])
def test_kernel_matches_plain_twin(level_inputs, level, first_iter):
    args = _args(level_inputs, level, first_iter)
    before = fused_kernels.fused_partials_cuda.launches
    gram, rw = fused_kernels.fused_partials_rows_cuda(*args)
    again = fused_kernels.fused_partials_rows_cuda(*args)
    torch.cuda.synchronize()
    assert fused_kernels.fused_partials_cuda.launches == before + 2
    fused_check.assert_bit_identical((gram, rw), again)
    kernel = fused_kernels.partials_from_rows(gram, rw)
    _, _, not_bit_equal = fused_check.compare_fused_partials(
        kernel, rw, fused_kernels.fused_partials_plain(*args), fused_check.twin_rows(*args)
    )
    assert not_bit_equal == 0
    fused_check.compare_exact_gram(kernel, fused_check.exact_gram(*args))
    assert float(kernel.num_valid) > 0.5 * args[0].shape[1]


def test_dispatch_takes_the_kernel_on_cuda(level_inputs):
    args = _args(level_inputs, 1, 0)
    before = fused_kernels.fused_partials_cuda.launches
    parts = fused_kernels.fused_partials(*args[:5])
    assert fused_kernels.fused_partials_cuda.launches == before + 1
    assert parts.residuals.shape == (2, args[0].shape[1]) and parts.residuals.is_cuda


def test_wrapper_rejects_bad_inputs(level_inputs):
    sampled, refpack, p3, flag, k, dof = _args(level_inputs, 2, 0)
    with pytest.raises(ValueError, match="float32"):
        fused_kernels.fused_partials_cuda(sampled.double(), refpack, p3, flag, k)
    with pytest.raises(ValueError, match="contiguous"):
        fused_kernels.fused_partials_cuda(sampled.t().contiguous().t(), refpack, p3, flag, k)
    with pytest.raises(ValueError, match=r"\[8, N\]"):
        fused_kernels.fused_partials_cuda(sampled[:, :-1].contiguous(), refpack, p3, flag, k)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_kernels.fused_partials_cuda(sampled.cpu(), refpack.cpu(), p3, flag, k)
    parts = fused_kernels.fused_partials_cuda(sampled, refpack, p3, flag, k)
    assert torch.isfinite(parts.weights).all() and torch.isfinite(parts.m00).all()
