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
iteration's tail (``compare_warp_fused_stats``).  The pixel-sharded
evaluation (``warp_fused_partials``) is run for every rank on one device,
with the blocks' sums added in rank order where the ranks all-reduce
(``sharded_on_one_device``), and held the same way: its stash with the gate
weights > 0 (``twin_sharded_stash``), its 136 packed sums
(``compare_packed_sums``) and its tail.  The folded call is also held
against an oracle other than its own twin, the modular evaluation of the
``xla`` backend (``compare_modular_to_kernel``), at the reference's own
tolerances for that pair.  ``solo_evaluations`` repeats each batched
modular evaluation stream by stream and records where the two part (on
the CPU nowhere since the lockstep tracker's ``b`` is contracted stream by
stream, ROADMAP C (g)).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Tuple

import numpy as np
import torch

import dataclasses

from ..models import dense_tracker
from ..models.dense_tracker import prepare_frame
from ..ops import fused_kernels, robust, se3
from ..ops.residuals import compute_residuals, normal_equations, warp_and_sample_cm
from ..parallel.mesh import BATCH_AXIS, Mesh, local_block

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
# the folded kernel against the modular evaluation: the reference's own
# tolerances for its kernel against its modular path (tests/test_pallas.py)
MODULAR_RESIDUAL_ATOL = 2e-5
MODULAR_NE_RTOL = 2e-3  # A and b
MODULAR_B_ATOL = 1e-2
MODULAR_SCALE_RTOL = 2e-3  # the scale numerator sum w r r^T
MODULAR_SCALE_ATOL = 1e-7
# an arbitrary new precision for the normal equations (tests/test_pallas.py)
CHECK_P_NEW = ((5000.0, -30.0), (-30.0, 1.0e5))


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
    """``exact_gram`` of the folded call's inputs (one stream, or one
    rank's refpack block against the whole quad table): the float64 Gram of
    the plain version's float32 rows."""
    sampled = warp_and_sample_cm(refpack, quad, shape, intrinsics, T, depth_buffered=depth_buffered)
    return exact_gram(sampled, refpack, _p3(P_prev), int(bool(first)), intrinsics, dof)


def compare_stash(kernel_rows, twin_rows, gate="mask"):
    """The folded kernel's stash against ``twin_stash`` (or the sharded
    kernel's against ``twin_sharded_stash``, whose third row is the
    ``gate``) -> (the worst residual error, the number of entries that are
    not bit-equal); raises unless the mask rows are equal and r_I, r_Z
    agree within atol 1e-6.  Both are the same float32 operations (the
    kernel built with -fmad=false), so 0 entries differ as a rule."""
    k, t = kernel_rows.detach().cpu(), twin_rows.detach().cpu()
    require(k.shape == t.shape, f"stash shape {tuple(k.shape)} != {tuple(t.shape)}")
    require(torch.equal(k[..., 2, :], t[..., 2, :]),
            f"stash {gate}: {int((k[..., 2, :] != t[..., 2, :]).sum())} pixels differ")
    r_err = float((k[..., :2, :] - t[..., :2, :]).abs().max())
    require(r_err <= RESIDUAL_ATOL, f"stashed residuals differ by {r_err!r} > atol {RESIDUAL_ATOL}")
    return r_err, int((k.view(torch.int32) != t.view(torch.int32)).sum())


def shard_blocks(refpack, world: int):
    """The ``world`` ranks' blocks of a refpack [8, N] in rank order: the
    pack zero-padded to a multiple of ``world`` columns, cut into contiguous
    column blocks (``mesh.local_block``)."""
    return [local_block(refpack, Mesh(None, BATCH_AXIS, rank, world, refpack.device), dim=1)
            for rank in range(world)]


def sharded_on_one_device(steps, blocks, quad, shape, intrinsics, T, P_prev, first, dof=5.0):
    """Every rank's pixel-sharded evaluation on one device, with no process
    group: ``steps`` = (partials, loglik, tail), the plain functions or the
    CUDA wrappers of ``fused_kernels``; ``blocks`` the ranks' refpack blocks.
    Where the ranks all-reduce, the blocks' values are added in rank order.
    Returns (every rank's ``WarpFusedStats``, the evaluations, each block's
    own 136 sums [world, 136], the reduced sums [136])."""
    partials, loglik, tail = steps
    evaluations = [partials(block, quad, shape, intrinsics, T, P_prev, first, dof)
                   for block in blocks]
    own_sums = torch.stack([e.sums for e in evaluations])

    def reduce(values):
        total = values[0].clone()
        for value in values[1:]:
            total += value
        for value in values:
            value.copy_(total)
        return total

    total = reduce([e.sums for e in evaluations])
    evaluations = [loglik(e) for e in evaluations]
    reduce([e.log_sum for e in evaluations])
    return [tail(e) for e in evaluations], evaluations, own_sums, total


def twin_sharded_stash(block, quad, shape, intrinsics, T, P_prev, first, dof=5.0):
    """The plain version's per-pixel (r_I, r_Z, gate) [3, N_local] of one
    rank's block: what launch 1 of the sharded evaluation stashes.  The
    gate is weights > 0, what the log-likelihood is summed over."""
    sampled = warp_and_sample_cm(block, quad, shape, intrinsics, T)
    r_i, r_z, w, _, _, _ = fused_kernels._pixel_math(
        block, sampled, _p3(P_prev), int(bool(first)), intrinsics.fx, intrinsics.fy, dof
    )
    return torch.stack([r_i, r_z, (w > 0).to(r_i.dtype)])


def packed_entry(k: int):
    """(row, column) of U's Gram that entry ``k`` of the 136 packed sums
    holds: the kernel's own table (``packed_entry`` in
    ``csrc/fused_stats.cu``), which must agree with
    ``fused_kernels.PACKED_SUMS``."""
    if k < 36:
        return k // 6, k % 6
    if k < 72:
        return (k - 36) // 6, 6 + (k - 36) % 6
    if k < 108:
        return 6 + (k - 72) // 6, 6 + (k - 72) % 6
    if k < 132:
        row = (k - 108) // 6
        return 6 * (row // 2) + (k - 108) % 6, 12 + row % 2
    if k < 135:
        return (13 if k == 134 else 12), (12 if k == 132 else 13)
    return 14, 14


def compare_packed_sums(sums, exact, num_valid=None):
    """The 136 packed sums of a kernel (a block's own, or the reduced ones)
    against the float64 Gram ``exact`` [14, 14] of the same pixels -> the
    worst relative error; raises unless every sum is within rtol
    ``EXACT_GRAM_RTOL`` of its exact value, and the count equals
    ``num_valid`` where that is given."""
    stats = fused_kernels.sums_as_stats(sums)
    if num_valid is not None:
        require(float(stats.num_valid) == float(num_valid),
                f"num_valid {float(stats.num_valid)} != {float(num_valid)}")
    return compare_exact_gram(stats, exact)


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
    term = 0.5 * n_t * np.log(np.maximum(det, 1e-38))  # the scale only: either path's floor
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


def compare_gram(kernel, twin, rtol=GRAM_RTOL):
    """Kernel vs twin Gram blocks (``FusedStats`` or ``FusedPartials``) ->
    (max abs error, max scaled error); raises unless ``num_valid`` is equal
    and every Gram entry G_ab is within ``rtol`` (1e-4) of sqrt(G_aa G_bb).

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
    require(scaled.max() <= rtol,
            f"Gram entry {worst}: kernel {float(a[worst])!r} vs twin {float(b[worst])!r}, "
            f"error {scaled.max():.3g} of sqrt(G_aa G_bb) > {rtol}")
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


def compare_modular_to_kernel(cfg, intrinsics, ref_levels, cur_levels, level: int, first: bool,
                              P_prev, twist=CHECK_TWIST):
    """The folded kernel (``warp_fused_stats_rows_cuda``, depth-buffered)
    against the modular evaluation (``compute_residuals``, the configured
    weights, ``tdist_scale``, ``normal_equations``) on the same warp
    exp(twist) and previous precision at one level, on CUDA tensors.  The
    folded kernel emits no per-pixel weights: they are held through the
    normal equations and the scale numerator.  Raises unless n and the
    mask are equal, the stashed residuals within atol 2e-5 of the modular
    ones, A and b (for ``CHECK_P_NEW``) within rtol 2e-3 (b also atol
    1e-2) and the scale numerator within rtol 2e-3; returns the errors."""
    fused_cfg = dataclasses.replace(cfg, kernel_backend="auto", depth_buffered_sampling=True)
    xla = dataclasses.replace(cfg, kernel_backend="xla")
    ref_f, cur_f = (prepare_frame(fused_cfg, intrinsics, lv) for lv in (ref_levels, cur_levels))
    ref_m, cur_m = (prepare_frame(xla, intrinsics, lv) for lv in (ref_levels, cur_levels))
    device = ref_f.refpack[level].device
    T = se3.exp_se3(torch.tensor(twist, dtype=torch.float32, device=device))
    k = intrinsics.at_level(level)
    shape = tuple(ref_f.sel[level].shape)
    dof = cfg.influence_function_param
    kernel, stats, stash = fused_kernels.warp_fused_stats_rows_cuda(
        ref_f.refpack[level], cur_f.quad[level], shape, k, T, P_prev, first, dof, True)
    rows = ref_m.refpack[level].unflatten(-1, shape)
    rd = compute_residuals(rows[0], rows[1], rows[2], rows[3], ref_m.sel[level],
                           cur_m.accel[level], k, T)
    weights = (rd.mask.to(torch.float32) if first
               else dense_tracker._weights_for(xla, rd.residuals, P_prev, rd.mask))
    P_new = torch.tensor(CHECK_P_NEW, dtype=torch.float32, device=device)
    A_k, b_k = fused_kernels.assemble_normal_equations(stats, P_new)
    A_m, b_m = normal_equations(rd, weights, P_new)
    n = int(rd.num_valid)
    S_k = fused_kernels.scale_matrix(stats)
    S_m = robust.tdist_scale(rd.residuals, weights, rd.num_valid) * max(n - 3, 1)
    host = lambda t: t.detach().double().cpu()  # noqa: E731
    mask_differ = int((stash[2].cpu() > 0.5).ne(rd.mask.cpu()).sum())
    r_err = float((host(stash[:2]).T - host(rd.residuals)).abs().max())

    def rel(a, b, rtol, atol=0.0):
        """The worst |a - b| / (atol + rtol |b|): <= 1 passes (equal zeros
        pass, any other difference from a zero fails)."""
        diff, tol = (host(a) - host(b)).abs(), atol + rtol * host(b).abs()
        ratio = torch.where(tol > 0, diff / torch.where(tol > 0, tol, torch.ones_like(tol)),
                            torch.where(diff > 0, float("inf"), 0.0))
        return float(ratio.max())

    errors = {
        "level": level, "first": int(bool(first)), "n": int(kernel.n), "modular_n": n,
        "mask_differ": mask_differ, "residual_max_abs_err": r_err,
        "A_worst_over_tol": rel(A_k, A_m, MODULAR_NE_RTOL),
        "b_worst_over_tol": rel(b_k, b_m, MODULAR_NE_RTOL, MODULAR_B_ATOL),
        "scale_worst_over_tol": rel(S_k, S_m, MODULAR_SCALE_RTOL, MODULAR_SCALE_ATOL),
    }
    require(int(kernel.n) == n > 0 and mask_differ == 0,
            f"kernel vs modular: n {int(kernel.n)} vs {n}, {mask_differ} mask pixels differ "
            f"(level {level}, first {first})")
    require(r_err <= MODULAR_RESIDUAL_ATOL,
            f"kernel vs modular: residuals differ by {r_err} (level {level}, first {first})")
    for key in ("A_worst_over_tol", "b_worst_over_tol", "scale_worst_over_tol"):
        require(errors[key] <= 1.0, f"kernel vs modular: {key} {errors[key]} "
                                    f"(level {level}, first {first})")
    return errors


@contextlib.contextmanager
def solo_evaluations():
    """While open, every batched modular evaluation (``xla`` lockstep, run
    by the eager loop: under a CUDA graph the evaluation runs only at
    capture) is repeated for each stream alone, on that stream's inputs,
    previous precision, warp and ``first``.  Yields a list with one row per
    batched evaluation: ``solve`` (the index of its level solve), ``first``,
    and per stream whether n, the precision, ll and A are bit-equal and b's
    largest difference over b's largest entry."""
    rows = []
    solves = [-1]
    original = dense_tracker._modular_evaluation

    def modular_evaluation(cfg, intrinsics, sel_mask, refpack, accel):
        batched = original(cfg, intrinsics, sel_mask, refpack, accel)
        if sel_mask.dim() == 2:
            return batched
        solves[0] += 1
        solve = solves[0]
        solo = [original(cfg, intrinsics, sel_mask[b], refpack[b], accel[b])
                for b in range(sel_mask.shape[0])]

        def evaluate(T, P_prev, first):
            out = batched(T, P_prev, first)
            n, precision, ll, A, b = out
            row = {"solve": solve, "first": bool(first), "n": [], "precision": [], "ll": [],
                   "A": [], "b_scaled": []}
            for k, fn in enumerate(solo):
                n_k, p_k, ll_k, A_k, b_k = fn(T[k], P_prev[k], first)
                row["n"].append(bool(torch.equal(n[k], n_k)))
                row["precision"].append(bool(torch.equal(precision[k], p_k)))
                row["ll"].append(bool(torch.equal(ll[k], ll_k)))
                row["A"].append(bool(torch.equal(A[k], A_k)))
                scale = float(torch.abs(b_k).max())
                row["b_scaled"].append(float(torch.abs(b[k] - b_k).max()) / max(scale, 1e-30))
            rows.append(row)
            return out

        return evaluate

    dense_tracker._modular_evaluation = modular_evaluation
    try:
        yield rows
    finally:
        dense_tracker._modular_evaluation = original
