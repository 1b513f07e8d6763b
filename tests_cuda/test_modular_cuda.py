"""The modular tracker backend and the warps on the card, at 640x480.

- Modules of the modular path on CUDA tensors against the same calls on
  CPU copies: ``build_acceleration`` and the samplers bit-equal (the same
  elementwise float32 operations); ``compute_residuals``'s masks differ in
  at most 0.1 % of the pixels, its residuals within atol 2e-5 and its
  Jacobian within 1e-5 of its largest magnitude where both are valid; on
  the same inputs, the robust weights within rtol 1e-6, the MAD scale
  equal; the normal equations, the scale sums and the
  log-likelihood within rtol 1e-5 of their largest entry (reductions in
  another order); ``solve_evd`` and ``solve_svd`` within 1e-4 (cuSOLVER
  against LAPACK).
- The folded kernel against the modular evaluation (``chip_smoke.py``
  phase 16(a)): ``tools/fused_check.compare_modular_to_kernel`` at levels
  3, 2, 1 with ``first`` 0 and 1.
- ``match_pyramids`` under (Huber, MAD) on CUDA tensors launches no
  kernel and agrees with the CPU run in iterations and terminations.
- ``intensity_error_image`` on CUDA tensors against CPU copies: the valid
  masks differ in at most 0.1 % of the pixels, the values within 1e-4.
"""

import dataclasses

import numpy as np
import pytest
import torch

from dvo_slam_tpu_torch import benchmark_config, odometry
from dvo_slam_tpu_torch.config import InfluenceFunction, ScaleEstimator
from dvo_slam_tpu_torch.models import dense_tracker
from dvo_slam_tpu_torch.ops import interp, least_squares, pyramid, residuals, robust, se3, warp
from dvo_slam_tpu_torch.ops.camera import TUM_FR1
from dvo_slam_tpu_torch.tools import driver_launches, fused_check
from dvo_slam_tpu_torch.utils import synthetic

pytestmark = pytest.mark.cuda

CFG = benchmark_config().tracker
MODULAR = dataclasses.replace(CFG, influence_function=InfluenceFunction.HUBER,
                              scale_estimator=ScaleEstimator.MAD)
RTOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    """Phase 4's first two frames as pyramids on the card, and their poses."""
    poses = synthetic.circular_trajectory(100, radius=0.05, rot_amplitude=0.02)[:2]
    intensity, depth = odometry.render_sequence(poses, (480, 640), TUM_FR1, workers=4)
    d_i, d_d = odometry.upload_sequence(intensity, depth, torch.device("cuda"))
    return [odometry.build_frame(CFG, d_i[k], d_d[k]) for k in (0, 1)], poses


def _cpu(x):
    return type(x)(*(None if f is None else f.cpu() for f in x)) if isinstance(x, tuple) else x.cpu()


def _close(got, want, rtol=RTOL):
    got, want = got.double().cpu(), want.double().cpu()
    assert float((got - want).abs().max()) <= rtol * float(want.abs().max())


def test_modular_modules_match_cpu(pair):
    (ref_levels, cur_levels), _ = pair
    level = CFG.last_level
    k = TUM_FR1.at_level(level)
    ref, cur = ref_levels[level], cur_levels[level]
    accel = pyramid.build_acceleration(cur)
    assert torch.equal(accel.cpu(), pyramid.build_acceleration(_cpu(cur)))
    T = se3.exp_se3(torch.tensor(fused_check.CHECK_TWIST, device="cuda"))
    sel = pyramid.selection_mask(ref)
    args = (ref.intensity, ref.depth, ref.idx, ref.idy, sel, accel, k, T)
    rd = residuals.compute_residuals(*args)
    rd_cpu = residuals.compute_residuals(*(a.cpu() if isinstance(a, torch.Tensor) else a
                                           for a in args))
    differ = rd.mask.cpu() != rd_cpu.mask
    assert float(differ.float().mean()) <= 1e-3, int(differ.sum())
    both = rd.mask.cpu() & rd_cpu.mask
    assert float((rd.residuals.cpu() - rd_cpu.residuals)[both].abs().max()) <= 2e-5
    _close(rd.jacobian.cpu()[both], rd_cpu.jacobian[both])
    u, v = (x.cpu() for x in torch.rand(2, 5000).mul(torch.tensor([[319.0], [239.0]])))
    got = interp.bilinear_sample_accel(accel, u.cuda(), v.cuda(), torch.full_like(u, 1.5).cuda())
    want = interp.bilinear_sample_accel(accel.cpu(), u, v, torch.full_like(u, 1.5))
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    # the reductions on the same inputs: the CPU residuals, copied to the card
    rd = residuals.ResidualData(*(f.cuda() for f in rd_cpu))
    P = torch.tensor([[3000.0, 50.0], [50.0, 2.0e5]])
    for cfg in (CFG, MODULAR):
        w = dense_tracker._weights_for(cfg, rd.residuals, P.cuda(), rd.mask)
        w_cpu = dense_tracker._weights_for(cfg, rd_cpu.residuals, P, rd_cpu.mask)
        np.testing.assert_allclose(w.cpu().numpy(), w_cpu.numpy(), rtol=1e-6, atol=1e-9)
        A, b = residuals.normal_equations(rd, w, P.cuda())
        A_cpu, b_cpu = residuals.normal_equations(rd_cpu, w_cpu, P)
        _close(A, A_cpu)
        _close(b, b_cpu)
        _close(robust.tdist_scale(rd.residuals, w, rd.num_valid),
               robust.tdist_scale(rd_cpu.residuals, w_cpu, rd_cpu.num_valid))
    for channel in (0, 1):
        x, mask = rd.residuals[:, channel], rd.mask
        assert float(robust.mad_scale(x, mask)) == float(robust.mad_scale(x.cpu(), mask.cpu()))
        np.testing.assert_allclose(float(robust.normal_scale(x, mask)),
                                   float(robust.normal_scale(x.cpu(), mask.cpu())), rtol=RTOL)
    ll = robust.tdist_log_likelihood(rd.residuals, P.cuda(), rd.mask)
    ll_cpu = robust.tdist_log_likelihood(rd_cpu.residuals, P, rd_cpu.mask)
    np.testing.assert_allclose(float(ll), float(ll_cpu), rtol=RTOL)
    J = torch.randn(40, 6)
    J[:, 5] = 0.0
    x_true = torch.randn(6)
    for solve, a in ((least_squares.solve_evd, (J.T @ J, J.T @ J @ x_true)),
                     (least_squares.solve_svd, (J, -J @ x_true))):
        np.testing.assert_allclose(solve(*(t.cuda() for t in a)).cpu().numpy(),
                                   solve(*a).numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("first", [0, 1])
def test_folded_kernel_against_the_modular_evaluation(pair, first):
    (ref_levels, cur_levels), _ = pair
    P_prev = torch.tensor(fused_check.CHECK_P_NEW, device="cuda") * 0.8
    for level in range(CFG.first_level, CFG.last_level - 1, -1):
        errors = fused_check.compare_modular_to_kernel(CFG, TUM_FR1, ref_levels, cur_levels,
                                                       level, bool(first), P_prev)
        assert errors["mask_differ"] == 0


def test_modular_match_launches_no_kernel(pair):
    (ref_levels, cur_levels), _ = pair
    for wrapper in driver_launches.wrappers().values():
        wrapper.launches = 0
    residuals.warp_and_sample_cm.calls = 0
    result = dense_tracker.match_pyramids(MODULAR, TUM_FR1, ref_levels, cur_levels)
    assert result.transformation.device.type == "cuda"
    assert not any(driver_launches.launches().values())
    on_cpu = dense_tracker.match_pyramids(
        MODULAR, TUM_FR1, *([_cpu(lv) if lv is not None else None for lv in levels]
                            for levels in (ref_levels, cur_levels)))
    assert [(s.iterations, int(s.termination)) for s in result.level_stats] == [
        (s.iterations, int(s.termination)) for s in on_cpu.level_stats]


def test_error_image_on_the_card_matches_cpu(pair):
    (ref_levels, cur_levels), poses = pair
    level = CFG.last_level
    T = torch.tensor(np.linalg.inv(poses[1]) @ poses[0], dtype=torch.float32)
    ref, cur = ref_levels[level], cur_levels[level]
    err, ok = warp.intensity_error_image(ref, cur, TUM_FR1.at_level(level), T.cuda())
    err_cpu, ok_cpu = warp.intensity_error_image(_cpu(ref), _cpu(cur), TUM_FR1.at_level(level), T)
    assert float((ok.cpu() != ok_cpu).float().mean()) <= 1e-3
    both = ok.cpu() & ok_cpu
    assert float((err.cpu() - err_cpu)[both].abs().max()) <= 1e-4
    err_id, ok_id = warp.intensity_error_image(ref, cur, TUM_FR1.at_level(level),
                                               torch.eye(4, device="cuda"))
    assert float(err[ok].mean()) < float(err_id[ok_id].mean())
