"""The fused kernels held against their plain twins on real inputs.

Shared by ``chip_smoke.py`` (phase 3), the ``tests_cuda`` tier and
``tools/profile_odometry.py``.  The inputs are what the tracker feeds the
kernels: the reference frame's refpack and the current frame sampled
through a warp, at every solved pyramid level.

Two Gram checks, for both kernels: against the float32 twin, each entry
within 1e-4 of sqrt(G_aa G_bb) (``compare_gram``); and element-wise, rtol
1e-6, against the float64 Gram of the same float32 rows
(``compare_exact_gram``).  ``fused_stats`` adds its log-likelihood sum
(``compare_fused_stats``); ``fused_partials`` its per-pixel rows
(``compare_fused_partials``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.dense_tracker import prepare_frame
from ..ops import fused_kernels, se3
from ..ops.residuals import warp_and_sample_cm

# the reference's own kernel-vs-twin tolerances (tests/test_pallas.py); the
# Gram's is taken relative to sqrt(G_aa G_bb) (see compare_fused_stats)
GRAM_RTOL = 1e-4
LOG_SUM_RTOL = 1e-5
# the kernel sums its Gram in double: element-wise against the float64 Gram
# of the same float32 rows (see compare_exact_gram)
EXACT_GRAM_RTOL = 1e-6
# fused_partials' per-pixel rows against the twin's: the reference's own
# tolerances for its Pallas kernel against the XLA twin (tests/test_pallas.py)
RESIDUAL_ATOL = 1e-6
WEIGHT_RTOL = 1e-5
WEIGHT_ATOL = 1e-8
GRAM_FIELDS = ("m00", "m01", "m11", "v", "scale_sum")
# a small warp with rotation and translation in every axis, so that the
# residuals at each level are those of a real mid-solve iteration
CHECK_TWIST = (0.003, -0.002, 0.004, 0.001, 0.002, -0.001)
CHECK_PRECISION = (4000.0, 10.0, 1.5e5)


def require(condition, message):
    """A check that stays on under ``python -O``."""
    if not condition:
        raise RuntimeError(message)


def level_inputs(cfg, intrinsics, ref_levels, cur_levels, twist=CHECK_TWIST):
    """{level: (sampled [8, N], refpack [8, N], level intrinsics)} for every
    solved level, the current frame sampled through the warp exp(twist)."""
    ref = prepare_frame(cfg, intrinsics, ref_levels)
    cur = prepare_frame(cfg, intrinsics, cur_levels)
    device = ref.refpack[cfg.first_level].device
    T = se3.exp_se3(torch.tensor(twist, dtype=torch.float32, device=device))
    out = {}
    for level in range(cfg.first_level, cfg.last_level - 1, -1):
        k = intrinsics.at_level(level)
        sampled = warp_and_sample_cm(
            ref.refpack[level], cur.quad[level], tuple(ref.sel[level].shape), k, T,
            depth_buffered=cfg.depth_buffered_sampling,
        )
        out[level] = (sampled, ref.refpack[level], k)
    return out


def gram14(stats):
    """The Gram blocks of a ``FusedStats`` as the symmetric [14, 14] float64
    Gram of the rows (sqrt(w) J_I, sqrt(w) J_Z, sqrt(w) r_I, sqrt(w) r_Z)."""
    g = np.zeros((14, 14))
    g[0:6, 0:6] = stats.m00.detach().double().cpu().numpy()
    g[0:6, 6:12] = stats.m01.detach().double().cpu().numpy()
    g[6:12, 6:12] = stats.m11.detach().double().cpu().numpy()
    v = stats.v.detach().double().cpu().numpy()
    g[0:6, 12], g[0:6, 13], g[6:12, 12], g[6:12, 13] = v
    s = stats.scale_sum.detach().double().cpu().numpy()
    g[12, 12], g[12, 13], g[13, 13] = s
    upper = np.triu(g)
    return upper + np.triu(upper, 1).T


def exact_gram(sampled, refpack, precision3, first_iter, intrinsics, dof=5.0):
    """The float64 Gram [14, 14] of the twin's float32 rows U: each product
    and sum in double, which is what the kernel computes before it rounds
    the Gram once to float32."""
    rows = fused_kernels._gram_rows(*fused_kernels._pixel_math(
        refpack, sampled, precision3, first_iter, intrinsics.fx, intrinsics.fy, dof
    ))[:14].double()
    return (rows @ rows.T).cpu().numpy()


def compare_exact_gram(kernel, exact):
    """Kernel ``FusedStats`` vs ``exact_gram`` of the same inputs -> the
    worst relative error; raises unless every Gram entry is within rtol
    ``EXACT_GRAM_RTOL`` of its own exact value, element by element."""
    a = gram14(kernel)
    err = np.abs(a - exact)
    bad = err > EXACT_GRAM_RTOL * np.abs(exact)
    if bad.any():
        worst = tuple(int(i) for i in np.argwhere(bad)[0])
        require(False, f"Gram entry {worst}: kernel {float(a[worst])!r} vs float64 "
                       f"{float(exact[worst])!r} beyond rtol {EXACT_GRAM_RTOL}")
    nonzero = exact != 0
    return float((err[nonzero] / np.abs(exact[nonzero])).max())


def compare_gram(kernel, twin):
    """Kernel vs twin Gram blocks (``FusedStats`` or ``FusedPartials``) ->
    (max abs error, max scaled error); raises unless ``num_valid`` is equal
    and every Gram entry G_ab is within rtol 1e-4 of sqrt(G_aa G_bb).

    That bound is the entry's own magnitude on the diagonal and wherever
    the sum does not cancel.  Off the diagonal a float32 dot product's
    rounding error scales with sum |u_a u_b| <= sqrt(G_aa G_bb), not with
    |G_ab|: an entry that cancels by 1e4 (such entries occur in the v
    block) carries a relative error near 1e-4 in the float32 twin itself,
    whatever the kernel does.  The kernel's own Gram is held element-wise
    by ``compare_exact_gram``."""
    require(float(kernel.num_valid) == float(twin.num_valid),
            f"num_valid {float(kernel.num_valid)} != {float(twin.num_valid)}")
    a, b = gram14(kernel), gram14(twin)
    diag = np.diag(b)
    require((diag > 0).all(), "twin Gram has an empty row")
    scale = np.sqrt(np.outer(diag, diag))
    err = np.abs(a - b)
    scaled = err / scale
    worst = tuple(int(i) for i in np.unravel_index(np.argmax(scaled), scaled.shape))
    require(scaled.max() <= GRAM_RTOL,
            f"Gram entry {worst}: kernel {float(a[worst])!r} vs twin {float(b[worst])!r}, "
            f"error {scaled.max():.3g} of sqrt(G_aa G_bb) > {GRAM_RTOL}")
    return float(err.max()), float(scaled.max())


def compare_fused_stats(kernel, twin):
    """Kernel vs twin ``FusedStats`` -> (max abs error, max scaled error):
    the Gram as ``compare_gram`` holds it, and ``log_sum`` within rtol
    1e-5."""
    abs_err, scaled_err = compare_gram(kernel, twin)
    ls_k, ls_t = float(kernel.log_sum), float(twin.log_sum)
    require(abs(ls_k - ls_t) <= LOG_SUM_RTOL * abs(ls_t),
            f"log_sum kernel {ls_k!r} vs twin {ls_t!r} beyond rtol {LOG_SUM_RTOL}")
    return max(abs_err, abs(ls_k - ls_t)), scaled_err


def twin_rows(sampled, refpack, precision3, first_iter, intrinsics, dof=5.0):
    """The plain twin's per-pixel rows [4, N] = (r_I, r_Z, w, mask): what
    the partials kernel writes as rw."""
    r_i, r_z, w, maskf, _, _ = fused_kernels._pixel_math(
        refpack, sampled, precision3, first_iter, intrinsics.fx, intrinsics.fy, dof
    )
    return torch.stack([r_i, r_z, w, maskf])


def compare_fused_partials(kernel, kernel_rw, twin, twin_rw):
    """Kernel vs twin ``FusedPartials`` with their rows rw [4, N] -> (max
    abs error, max scaled Gram error, number of rw entries that are not
    bit-equal); raises outside the tolerances: the Gram as ``compare_gram``
    holds it, the mask row equal, r_I and r_Z within atol 1e-6, w within
    rtol 1e-5 (atol 1e-8).  The kernel's rows are built with -fmad=false
    from the same float32 operations, so 0 entries differ as a rule."""
    abs_err, scaled_err = compare_gram(kernel, twin)
    k, t = kernel_rw.detach().cpu(), twin_rw.detach().cpu()
    require(k.shape == t.shape, f"rw shape {tuple(k.shape)} != {tuple(t.shape)}")
    require(torch.equal(k[3], t[3]),
            f"mask row: {int((k[3] != t[3]).sum())} pixels differ")
    r_err = float((k[:2] - t[:2]).abs().max())
    require(r_err <= RESIDUAL_ATOL, f"residuals differ by {r_err!r} > atol {RESIDUAL_ATOL}")
    w_err = (k[2] - t[2]).abs()
    w_bound = WEIGHT_ATOL + WEIGHT_RTOL * t[2].abs()
    require(bool((w_err <= w_bound).all()),
            f"weights differ by up to {float(w_err.max())!r} beyond rtol {WEIGHT_RTOL}")
    not_bit_equal = int((k.view(torch.int32) != t.view(torch.int32)).sum())
    return max(abs_err, r_err, float(w_err.max())), scaled_err, not_bit_equal


def assert_bit_identical(a, b):
    """Two kernel runs on the same inputs give the same bits (the kernel
    reduces in a fixed order, with no float atomics).  ``a`` and ``b`` are
    named tuples of tensors or plain tuples of tensors."""
    for field, x, y in zip(getattr(a, "_fields", range(len(a))), a, b):
        require(torch.equal(x, y), f"two kernel runs differ in {field}")
