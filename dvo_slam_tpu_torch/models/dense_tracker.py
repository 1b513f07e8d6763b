"""Dense RGB-D tracker: coarse-to-fine IRLS Gauss-Newton on SE(3)
(port of ``dvo_slam_tpu.models.dense_tracker``, fused path).

Per pyramid level: iterate { apply the increment; evaluate: warp and
sample, fused statistics with IRLS weights from the previous precision,
the re-estimated 2x2 t-distribution precision, the log-likelihood and the
6x6 normal equations, all in one call (``fused_kernels.warp_fused_stats``:
the folded CUDA kernel on the card, the plain version on the CPU); accept
if the negative log-likelihood decreased, else revert and stop; solve the
normal equations } until the
increment's infinity norm drops below ``cfg.precision`` or the iteration
cap is hit.

The reference's ``lax.while_loop`` is a Python loop here that reads the
``done`` flag back to the host once per iteration; everything else stays
on the tensors' device.  Iteration counts and termination codes are
therefore those of the reference.  The accept/revert logic keeps the
reference's form: a rejected step keeps the previous carry.

Lockstep batching: prepared frames whose artifacts carry a leading stream
axis [B, ...] (``prepare_frame`` on batched pyramids) align B independent
pairs at once.  Each iteration runs every op once on [B, ...] tensors and
reads back one [B] ``done`` mask (``done.all()``); a stream's carry
freezes as soon as that stream is done, which is what the reference's
``lax.while_loop`` does under ``vmap`` with a batched predicate (the
body's output is selected away for finished elements).  So each stream's
iterations, termination and estimate are those of its single-stream solve.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..config import InfluenceFunction, ScaleEstimator, TrackerConfig
from ..ops import fused_kernels, least_squares, se3
from ..ops.camera import Intrinsics
from ..ops.interp import build_quad_table_cm
from ..ops.pyramid import (
    PyramidLevel,
    build_acceleration_cm,
    build_pyramid,
    selection_mask,
)

# Termination criteria (reference: dense_tracking.h TerminationCriteria).
TERM_NONE = 0
TERM_ITERATIONS_EXCEEDED = 1
TERM_INCREMENT_TOO_SMALL = 2
TERM_LOG_LIKELIHOOD_DECREASED = 3
TERM_TOO_FEW_CONSTRAINTS = 4

# Information-matrix scaling applied to the final Hessian.
INFORMATION_SCALE = 0.008 * 0.008


class LevelStats(NamedTuple):
    """Per-level statistics.  One stream: ``iterations`` is a Python int
    (the loop that counts them runs on the host).  B streams in lockstep:
    every field is a [B] int32 tensor."""

    valid_pixels: torch.Tensor  # [] int32, selected reference points
    valid_constraints: torch.Tensor  # [] int32, constraints of the last accepted iteration
    iterations: int
    termination: torch.Tensor  # [] int32


class IterationStats(NamedTuple):
    """Per-iteration solver telemetry, one [max_iterations, ...] row per
    executed iteration; rows past ``LevelStats.iterations`` are zero.  In
    lockstep every field has a leading [B]."""

    valid_constraints: torch.Tensor  # [I]
    log_likelihood: torch.Tensor  # [I]
    precision: torch.Tensor  # [I, 2, 2]
    increment: torch.Tensor  # [I, 6]
    information: torch.Tensor  # [I, 6, 6]


class TrackingResult(NamedTuple):
    """Result of one dense alignment.  ``transformation`` is the pose of the
    current camera in the reference frame; ``neg_log_likelihood`` is the
    negative t-distribution log-likelihood plus the prior term."""

    transformation: torch.Tensor  # [4, 4]
    information: torch.Tensor  # [6, 6]
    neg_log_likelihood: torch.Tensor  # []
    level_stats: Tuple[LevelStats, ...]
    iteration_stats: Tuple[IterationStats, ...] = ()

    @property
    def last_level(self) -> LevelStats:
        return self.level_stats[-1]

    def is_nan(self):
        return ~torch.all(torch.isfinite(self.transformation))


class _Carry(NamedTuple):
    """The IRLS loop state of one level; [B, ...] in lockstep."""

    x: torch.Tensor  # [6] increment to apply next iteration
    T: torch.Tensor  # [4, 4] current warp estimate
    initial: torch.Tensor  # [4, 4] remaining prior offset
    inc_applied: torch.Tensor  # [4, 4] last successfully applied increment
    precision: torch.Tensor  # [2, 2]
    error: torch.Tensor  # [] previous -log-likelihood
    A: torch.Tensor  # [6, 6] information of the last accepted iteration
    ll: torch.Tensor  # [] log-likelihood of the last accepted iteration
    n: torch.Tensor  # [] int32 valid constraints of the last accepted iteration
    termination: torch.Tensor  # [] int32
    done: torch.Tensor  # [] bool


def _resolve_backend(cfg: TrackerConfig, device: torch.device) -> str:
    """The inner-loop implementation for tensors on ``device``.

    ``auto`` takes the CUDA kernel ("pallas", after the reference's name)
    for CUDA tensors and the plain twin ("fused") for CPU tensors.  The
    modular ``xla`` oracle path is not ported yet."""
    backend = cfg.kernel_backend
    tdist = (
        cfg.use_weighting
        and cfg.influence_function is InfluenceFunction.TDISTRIBUTION
        and cfg.scale_estimator is ScaleEstimator.TDISTRIBUTION
    )
    if backend == "xla" or (backend == "auto" and not tdist):
        raise NotImplementedError(
            "the modular 'xla' oracle backend (any influence/scale "
            "configuration other than the t-distribution) is not ported "
            "yet: ROADMAP.md A.13"
        )
    if backend not in ("auto", "fused", "pallas"):
        raise ValueError(f"unknown kernel_backend {backend!r}")
    if not tdist:
        raise ValueError(f"kernel_backend={backend!r} requires t-distribution weighting")
    kind = torch.device(device).type
    if backend == "auto":
        backend = "pallas" if kind == "cuda" else "fused"
    if backend == "pallas" and kind != "cuda":
        raise ValueError("kernel_backend='pallas' runs the CUDA kernel: it needs CUDA tensors")
    if backend == "fused" and kind != "cpu":
        raise ValueError(
            "kernel_backend='fused' is the plain twin, the CPU path: on "
            f"{kind} tensors the tracker runs the kernel ('auto' or 'pallas')"
        )
    return backend


def _build_refpack(ref_level: PyramidLevel, sel_mask, intrinsics: Intrinsics):
    """Reference-side channel pack, channel-major [..., 8, N]:
    (intensity, depth, idx, idy, x, y, selected, 0).  Rows 4/5 cache the
    unprojected x/y so the per-iteration warp never re-unprojects."""
    h, w = ref_level.intensity.shape[-2:]
    n = h * w
    flat = ref_level.intensity.shape[:-2] + (n,)
    dtype = ref_level.intensity.dtype
    device = ref_level.intensity.device
    z = ref_level.depth.reshape(flat)
    iota = torch.arange(n, dtype=dtype, device=device)
    col = iota % w
    row = iota // w
    x = (col - intrinsics.ox) / intrinsics.fx * z
    y = (row - intrinsics.oy) / intrinsics.fy * z
    return torch.stack(
        [
            ref_level.intensity.reshape(flat),
            z,
            ref_level.idx.reshape(flat),
            ref_level.idy.reshape(flat),
            x,
            y,
            sel_mask.reshape(flat).to(dtype),
            torch.zeros(flat, dtype=dtype, device=device),
        ],
        dim=-2,
    )


def _match_level(
    cfg: TrackerConfig,
    intrinsics: Intrinsics,
    sel_mask,
    refpack,
    quad,
    x0,
    T0,
    initial0,
    precision0,
    collect_stats: bool = False,
):
    """Run the IRLS Gauss-Newton iteration on one pyramid level, from the
    level's prepared artifacts (see :func:`prepare_frame`): the reference
    frame's selection mask and refpack, the current frame's quad table.
    With a leading stream axis on every input, B levels solve in lockstep."""
    _resolve_backend(cfg, sel_mask.device)
    dof = cfg.influence_function_param
    level_shape = tuple(sel_mask.shape[-2:])

    def evaluate(T, P_prev, first: bool):
        """One IRLS evaluation in one call (the folded kernel on the card,
        the plain version on the CPU): warp and sample, statistics, new
        precision, log-likelihood and normal equations."""
        return fused_kernels.warp_fused_stats(
            refpack, quad, level_shape, intrinsics, T, P_prev, first, dof,
            cfg.depth_buffered_sampling,
        )

    carry, iterations, trace = _irls_level(
        cfg, evaluate, x0, T0, initial0, precision0, collect_stats
    )
    stats = LevelStats(
        valid_pixels=sel_mask.sum(dim=(-2, -1), dtype=torch.int32),
        valid_constraints=carry.n,
        iterations=iterations,
        termination=carry.termination,
    )
    return carry, stats, trace


def _where(cond, new, old):
    """``torch.where`` with ``cond`` [...] broadcast over the trailing
    dimensions of ``new`` / ``old`` [..., *]."""
    return torch.where(cond.reshape(cond.shape + (1,) * (new.dim() - cond.dim())), new, old)


def _irls_level(
    cfg: TrackerConfig, evaluate, x0, T0, initial0, precision0, collect_stats: bool = False
):
    """The IRLS loop of one level around ``evaluate(T, P_prev, first) ->
    (n, precision_new, ll, A, b)``: apply the increment, evaluate, accept
    or revert, smooth toward the prior, solve, test termination.  Returns
    (final carry, iterations, iteration trace or None).

    One stream: ``x0`` [6], the loop stops when ``done``; ``iterations`` is
    a Python int.  B streams in lockstep: ``x0`` [B, 6], the loop stops
    when every stream is done, a finished stream's carry is frozen (its
    evaluation still runs with the batch, and is discarded); ``iterations``
    is a [B] int32 tensor."""
    dtype, device = x0.dtype, x0.device
    batch = tuple(x0.shape[:-1])
    eye6 = torch.eye(6, dtype=dtype, device=device)

    def step(c: _Carry, iteration: int):
        inc = se3.exp_se3(c.x)
        T_new = inc @ c.T
        initial_new = se3.inverse(inc) @ c.initial

        n, precision_new, ll, A, b = evaluate(T_new, c.precision, iteration == 0)
        too_few = n < 6
        error = -ll

        accept = error < c.error
        reject = too_few | ~accept

        if cfg.use_estimate_smoothing:
            # prior toward the initial guess
            A = A + cfg.mu * eye6
            b = b + cfg.mu * se3.log_se3(initial_new)
        x_new = least_squares.solve_ldlt(A, b)

        converged = torch.amax(torch.abs(x_new), dim=-1) <= cfg.precision
        exceeded = iteration + 1 >= cfg.max_iterations_per_level

        code = lambda k: torch.full((), k, dtype=torch.int32, device=device)  # noqa: E731
        termination = torch.where(
            too_few,
            code(TERM_TOO_FEW_CONSTRAINTS),
            torch.where(
                ~accept,
                code(TERM_LOG_LIKELIHOOD_DECREASED),
                torch.where(
                    converged,
                    code(TERM_INCREMENT_TOO_SMALL),
                    code(TERM_ITERATIONS_EXCEEDED if exceeded else TERM_NONE),
                ),
            ),
        )

        # on reject keep the previous estimate and the previous accepted
        # statistics; the loop then stops
        def keep(new, old):
            return _where(reject, old, new)

        new_c = _Carry(
            x=keep(x_new, c.x),
            T=keep(T_new, c.T),
            initial=keep(initial_new, c.initial),
            inc_applied=keep(inc, c.inc_applied),
            precision=keep(precision_new, c.precision),
            error=keep(error, c.error),
            A=keep(A, c.A),
            ll=keep(ll, c.ll),
            n=keep(n, c.n),
            termination=termination,
            done=reject | converged | exceeded,
        )
        # telemetry of the iteration as executed (before any revert)
        row = IterationStats(
            valid_constraints=n.to(dtype),
            log_likelihood=ll,
            precision=precision_new,
            increment=x_new,
            information=A,
        )
        return new_c, row

    carry = _Carry(
        x=x0,
        T=T0,
        initial=initial0,
        inc_applied=se3.exp_se3(x0),
        precision=precision0,
        error=torch.full(batch, float("inf"), dtype=dtype, device=device),
        A=eye6.expand(batch + (6, 6)),
        ll=torch.full(batch, float("-inf"), dtype=dtype, device=device),
        n=torch.zeros(batch, dtype=torch.int32, device=device),
        termination=torch.full(batch, TERM_NONE, dtype=torch.int32, device=device),
        done=torch.zeros(batch, dtype=torch.bool, device=device),
    )
    trace = None
    if collect_stats:
        max_it = cfg.max_iterations_per_level
        zeros = lambda *s: torch.zeros((max_it,) + batch + s, dtype=dtype, device=device)  # noqa: E731
        trace = IterationStats(
            valid_constraints=zeros(),
            log_likelihood=zeros(),
            precision=zeros(2, 2),
            increment=zeros(6),
            information=zeros(6, 6),
        )
    iterations = torch.zeros(batch, dtype=torch.int32, device=device) if batch else 0
    iteration = 0
    while True:
        stepped, row = step(carry, iteration)
        if batch:
            # freeze the streams that were already done
            active = ~carry.done
            carry = _Carry(*(_where(active, new, old) for new, old in zip(stepped, carry)))
            if trace is not None:
                row = IterationStats(*(_where(active, r, torch.zeros_like(r)) for r in row))
            iterations = iterations + active.to(torch.int32)
        else:
            carry = stepped
            iterations += 1
        if trace is not None:
            for buf, value in zip(trace, row):
                buf[iteration] = value
        iteration += 1
        # the one host read-back per iteration
        if bool(carry.done.all() if batch else carry.done):
            break
    if trace is not None and batch:
        trace = IterationStats(*(buf.movedim(0, len(batch)) for buf in trace))
    return carry, iterations, trace


class PreparedFrame(NamedTuple):
    """Per-frame cached solver artifacts of the fused path, one entry per
    pyramid level (``None`` outside the solve range).  ``sel``/``refpack``
    serve the frame's reference role, ``quad`` its current role.  (The
    reference also carries the levels and the modular path's
    acceleration tensor, which the fused path never reads.)"""

    sel: Tuple[Optional[torch.Tensor], ...]
    refpack: Tuple[Optional[torch.Tensor], ...]
    quad: Tuple[Optional[torch.Tensor], ...]


def prepare_frame(
    cfg: TrackerConfig, intrinsics: Intrinsics, levels: Sequence[PyramidLevel]
) -> PreparedFrame:
    """Precompute both roles' per-level artifacts for the solve range:
    selection mask and refpack [8, N], quad table [32, N] (each with a
    leading [B] for batched pyramids)."""
    _resolve_backend(cfg, levels[cfg.first_level].intensity.device)
    n = len(levels)
    sel = [None] * n
    refpack = [None] * n
    quad = [None] * n
    for level in range(cfg.last_level, cfg.first_level + 1):
        lv = levels[level]
        sel[level] = selection_mask(
            lv, cfg.intensity_derivative_threshold, cfg.depth_derivative_threshold
        )
        refpack[level] = _build_refpack(lv, sel[level], intrinsics.at_level(level))
        quad[level] = build_quad_table_cm(
            build_acceleration_cm(lv), lv.intensity.shape[-1]
        )
    return PreparedFrame(sel=tuple(sel), refpack=tuple(refpack), quad=tuple(quad))


def ref_artifacts(prepared: PreparedFrame) -> PreparedFrame:
    """Strip a PreparedFrame to its reference-role artifacts (selection
    mask and refpack): what a keyframe must keep for later matches."""
    return PreparedFrame(
        sel=prepared.sel, refpack=prepared.refpack, quad=(None,) * len(prepared.quad)
    )


def match_prepared(
    cfg: TrackerConfig,
    intrinsics: Intrinsics,
    ref: PreparedFrame,
    cur: PreparedFrame,
    initial_transformation=None,
    collect_iteration_stats: bool = False,
) -> TrackingResult:
    """Align two prepared frames: the cached-artifact core of
    :func:`match_pyramids`.

    With artifacts of B streams ([B, 8, N] refpacks, [B, 32, N] quad
    tables) and ``initial_transformation`` [B, 4, 4] (or None), the B
    alignments run in lockstep (the reference's ``vmap`` of this function):
    the result's transformation is [B, 4, 4], information [B, 6, 6],
    neg_log_likelihood [B], and each ``LevelStats`` holds [B] int32
    tensors."""
    refpack0 = ref.refpack[cfg.first_level]
    dtype, device = refpack0.dtype, refpack0.device
    batch = tuple(refpack0.shape[:-2])
    if initial_transformation is None:
        guess = torch.eye(4, dtype=dtype, device=device).expand(batch + (4, 4))
    else:
        # result space is estimate^{-1}; the first increment is the estimate
        guess = se3.inverse(
            torch.as_tensor(initial_transformation, device=device).to(dtype)
        )

    x = se3.log_se3(guess)
    T = se3.identity(dtype, device).expand(batch + (4, 4))
    initial = guess
    precision = torch.eye(2, dtype=dtype, device=device).expand(batch + (2, 2))

    level_stats = []
    iteration_stats = []
    final = None
    for level in range(cfg.first_level, cfg.last_level - 1, -1):
        final, stats, trace = _match_level(
            cfg,
            intrinsics.at_level(level),
            ref.sel[level],
            ref.refpack[level],
            cur.quad[level],
            x,
            T,
            initial,
            precision,
            collect_stats=collect_iteration_stats,
        )
        level_stats.append(stats)
        if collect_iteration_stats:
            iteration_stats.append(trace)
        # the next level starts from the last APPLIED increment
        x = se3.log_se3(final.inc_applied)
        T = final.T
        initial = final.initial
        precision = final.precision

    if cfg.use_estimate_smoothing:
        prior = cfg.mu * torch.sum(se3.log_se3(final.initial) ** 2, dim=-1)
    else:
        prior = torch.zeros(batch, dtype=dtype, device=device)
    return TrackingResult(
        transformation=se3.inverse(final.T),
        information=final.A * INFORMATION_SCALE,
        neg_log_likelihood=-final.ll + prior,
        level_stats=tuple(level_stats),
        iteration_stats=tuple(iteration_stats),
    )


def match_pyramids(
    cfg: TrackerConfig,
    intrinsics: Intrinsics,
    ref_levels: Sequence[PyramidLevel],
    cur_levels: Sequence[PyramidLevel],
    initial_transformation=None,
    collect_iteration_stats: bool = False,
) -> TrackingResult:
    """Align a current frame against a reference frame.

    ``initial_transformation`` is the result-space pose guess
    (current-in-reference); internally the warp estimate is its inverse,
    applied as the first increment.  The per-level artifacts are prepared
    inline (see :func:`prepare_frame` / :func:`match_prepared` for the
    cached form)."""
    if len(ref_levels) <= cfg.first_level or len(cur_levels) <= cfg.first_level:
        raise ValueError(
            f"config needs pyramid levels up to {cfg.first_level} but got "
            f"{len(ref_levels)} ref / {len(cur_levels)} cur levels; build "
            f"pyramids with cfg.num_levels = {cfg.num_levels}"
        )
    for level in range(cfg.last_level, cfg.first_level + 1):
        if ref_levels[level] is None or cur_levels[level] is None:
            raise ValueError(
                f"pyramid level {level} is None (built with skip_below > "
                f"cfg.last_level = {cfg.last_level}?); the solve range "
                f"{cfg.first_level}->{cfg.last_level} needs every level in it"
            )
    ref = prepare_frame(cfg, intrinsics, ref_levels)
    cur = prepare_frame(cfg, intrinsics, cur_levels)
    return match_prepared(
        cfg, intrinsics, ref, cur, initial_transformation,
        collect_iteration_stats=collect_iteration_stats,
    )


class DenseTracker:
    """Stateful convenience wrapper: a config and intrinsics, with
    frame-level and pyramid-level match entry points."""

    def __init__(self, intrinsics: Intrinsics, cfg: Optional[TrackerConfig] = None):
        self.cfg = cfg or TrackerConfig()
        self.intrinsics = intrinsics

    def build_pyramid(self, intensity, depth, valid):
        return build_pyramid(intensity, depth, valid, self.cfg.num_levels)

    def match(self, ref_levels, cur_levels, initial_transformation=None) -> TrackingResult:
        return match_pyramids(
            self.cfg, self.intrinsics, ref_levels, cur_levels, initial_transformation
        )
