"""The fused kernels held against their plain twins on real inputs.

Shared by ``chip_smoke.py`` (phase 3), the ``tests_cuda`` tier, the CPU
tests and ``tools/profile_odometry.py``.  The inputs are what the tracker
feeds the kernels: the reference frame's refpack and the current frame's
quad table, or the current frame sampled through a warp, at every solved
pyramid level.

Two Gram checks, for every kernel: against the float32 twin, each entry
within 1e-4 of sqrt(G_aa G_bb) (``compare_gram``); and element-wise, rtol
1e-6, against the float64 Gram of the same float32 rows
(``compare_exact_gram``).  ``fused_stats`` adds its log-likelihood sum
(``compare_fused_stats``); ``fused_partials`` its per-pixel rows
(``compare_fused_partials``).  The folded call (``warp_fused_stats``) adds
its stash of per-pixel residuals and mask (``compare_stash``) and the
iteration's tail (``compare_warp_fused_stats``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

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
# the folded call's tail against the plain version's, each quantity relative
# to the scale its float32 rounding follows (see compare_warp_fused_stats)
EVAL_RTOL = 1e-5


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


class WarpInputs(NamedTuple):
    """One level's inputs of the folded call, besides P_prev and the flag."""

    refpack: torch.Tensor  # [8, N]
    quad: torch.Tensor  # [32, N]
    shape: Tuple[int, int]  # (H, W)
    intrinsics: object  # the level's Intrinsics
    T: torch.Tensor  # [4, 4]


def warp_level_inputs(cfg, intrinsics, ref_levels, cur_levels, twist=CHECK_TWIST):
    """{level: WarpInputs} for every solved level, with the warp exp(twist)."""
    ref = prepare_frame(cfg, intrinsics, ref_levels)
    cur = prepare_frame(cfg, intrinsics, cur_levels)
    device = ref.refpack[cfg.first_level].device
    T = se3.exp_se3(torch.tensor(twist, dtype=torch.float32, device=device))
    return {
        level: WarpInputs(ref.refpack[level], cur.quad[level], tuple(ref.sel[level].shape),
                          intrinsics.at_level(level), T)
        for level in range(cfg.first_level, cfg.last_level - 1, -1)
    }


def _p3(P):
    return torch.stack([P[..., 0, 0], P[..., 0, 1], P[..., 1, 1]], dim=-1)


def twin_stash(refpack, quad, shape, intrinsics, T, P_prev, first, dof=5.0, depth_buffered=True):
    """The plain version's per-pixel (r_I, r_Z, mask) [..., 3, N]: what the
    folded kernel stashes between its launches."""
    sampled = warp_and_sample_cm(refpack, quad, shape, intrinsics, T, depth_buffered=depth_buffered)
    r_i, r_z, _, maskf, _, _ = fused_kernels._pixel_math(
        refpack, sampled, _p3(P_prev), int(bool(first)), intrinsics.fx, intrinsics.fy, dof
    )
    return torch.stack([r_i, r_z, maskf], dim=-2)


def warp_exact_gram(refpack, quad, shape, intrinsics, T, P_prev, first, dof=5.0,
                    depth_buffered=True):
    """``exact_gram`` of the folded call's inputs (one stream): the float64
    Gram of the plain version's float32 rows."""
    sampled = warp_and_sample_cm(refpack, quad, shape, intrinsics, T, depth_buffered=depth_buffered)
    return exact_gram(sampled, refpack, _p3(P_prev), int(bool(first)), intrinsics, dof)


def compare_stash(kernel_rows, twin_rows):
    """The folded kernel's stash against ``twin_stash`` -> (the worst
    residual error, the number of entries that are not bit-equal); raises
    unless the mask rows are equal and r_I, r_Z agree within atol 1e-6.
    Both are the same float32 operations (the kernel built with
    -fmad=false), so 0 entries differ as a rule."""
    k, t = kernel_rows.detach().cpu(), twin_rows.detach().cpu()
    require(k.shape == t.shape, f"stash shape {tuple(k.shape)} != {tuple(t.shape)}")
    require(torch.equal(k[..., 2, :], t[..., 2, :]),
            f"stash mask: {int((k[..., 2, :] != t[..., 2, :]).sum())} pixels differ")
    r_err = float((k[..., :2, :] - t[..., :2, :]).abs().max())
    require(r_err <= RESIDUAL_ATOL, f"stashed residuals differ by {r_err!r} > atol {RESIDUAL_ATOL}")
    return r_err, int((k.view(torch.int32) != t.view(torch.int32)).sum())


def compare_warp_fused_stats(kernel, twin):
    """Two ``WarpFusedStats`` of the same inputs (one stream or a leading
    [B]) -> {field: worst scaled error}; raises unless ``n`` is equal and
    each quantity is within ``EVAL_RTOL`` of the scale its float32 rounding
    follows: the precision's diagonal element-wise and P01 relative to
    sqrt(P00 P11); ll relative to |0.5 n logdet| + |0.5 (dof + 2) log_sum|
    (the two terms it is the difference of); A's diagonal element-wise and
    every entry within 1e-4 of sqrt(A_aa A_bb), as ``compare_gram`` holds
    the Gram; b_a relative to sqrt(2 n A_aa), its Cauchy-Schwarz bound
    (sum w r^T P_new r <= 2 n by the precision's own construction).
    Element-wise relative errors are no measure of the off-diagonal and
    right-hand-side entries, which cancel."""
    def f64(t, *shape):
        t = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t
        return np.asarray(t, np.float64).reshape(-1, *shape)

    n_k, n_t = f64(kernel.n), f64(twin.n)
    require(np.array_equal(n_k, n_t), f"n: kernel {n_k.tolist()} vs plain {n_t.tolist()}")
    P_k, P_t = f64(kernel.precision, 2, 2), f64(twin.precision, 2, 2)
    A_k, A_t = f64(kernel.A, 6, 6), f64(twin.A, 6, 6)
    b_k, b_t = f64(kernel.b, 6), f64(twin.b, 6)
    ll_k, ll_t = f64(kernel.ll), f64(twin.ll)
    worst = {}

    def check(name, err, scale):
        scaled = np.divide(err, scale, out=np.where(err > 0, np.inf, 0.0), where=scale > 0)
        worst[name] = float(scaled.max())
        require(worst[name] <= (GRAM_RTOL if name == "A_entries" else EVAL_RTOL),
                f"{name}: worst error {worst[name]:.3g} of its scale")

    p_diag = np.stack([P_t[:, 0, 0], P_t[:, 1, 1]], axis=-1)
    check("precision_diagonal", np.abs(np.stack([P_k[:, 0, 0], P_k[:, 1, 1]], -1) - p_diag),
          np.abs(p_diag))
    check("precision_offdiagonal", np.abs(P_k[:, 0, 1] - P_t[:, 0, 1]),
          np.sqrt(np.abs(P_t[:, 0, 0] * P_t[:, 1, 1])))
    det = P_t[:, 0, 0] * P_t[:, 1, 1] - P_t[:, 0, 1] * P_t[:, 1, 0]
    term = 0.5 * n_t * np.log(np.maximum(det, 1e-38))
    check("ll", np.abs(ll_k - ll_t), np.abs(term) + np.abs(term - ll_t))
    a_diag = np.diagonal(A_t, axis1=-2, axis2=-1)
    check("A_diagonal", np.abs(np.diagonal(A_k, axis1=-2, axis2=-1) - a_diag), np.abs(a_diag))
    check("A_entries", np.abs(A_k - A_t), np.sqrt(np.abs(a_diag[:, :, None] * a_diag[:, None, :])))
    check("b", np.abs(b_k - b_t), np.sqrt(2.0 * np.abs(n_t[:, None] * a_diag)))
    return worst


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
    """The float64 Gram [..., 14, 14] of the twin's float32 rows U: each product
    and sum in double, which is what the kernel computes before it rounds
    the Gram once to float32."""
    rows = fused_kernels._gram_rows(*fused_kernels._pixel_math(
        refpack, sampled, precision3, first_iter, intrinsics.fx, intrinsics.fy, dof
    ))[..., :14, :].double()
    return (rows @ rows.transpose(-1, -2)).cpu().numpy()


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
