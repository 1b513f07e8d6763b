"""Dense RGB-D tracker: coarse-to-fine IRLS Gauss-Newton on SE(3)
(port of ``dvo_slam_tpu.models.dense_tracker``).

Per pyramid level: iterate { apply the increment; evaluate: warp and
sample, IRLS weights from the previous precision, the re-estimated 2x2
precision, the log-likelihood and the 6x6 normal equations; accept if the
negative log-likelihood decreased, else revert and stop; solve the normal
equations } until the increment's infinity norm drops below
``cfg.precision`` or the iteration cap is hit.

Two evaluations, picked by ``_resolve_backend`` as the reference picks
them:
  * the fused path (t-distribution weights and scale): one call of
    ``fused_kernels.warp_fused_stats`` (the folded CUDA kernel on the
    card, the plain version on the CPU);
  * the modular path (``kernel_backend="xla"``, or ``auto`` with any other
    influence function, scale estimator or ``use_weighting=False``):
    ``residuals.compute_residuals``, the configured weights and scale
    (``_weights_for``, ``_scale_for``), the t-distribution
    log-likelihood and ``residuals.normal_equations``, plain PyTorch on
    the tensors' device, as it is XLA code in the reference.

The reference's ``lax.while_loop`` carries the iteration counter on the
device, and so does this loop: the iteration cap and the trace row are
device values, ``first`` is the first step of a level (iteration 0), a
step past ``done`` is inert (the carry freezes, as under the reference's
``vmap``), and a level's ``iterations`` is the carry's int32 count, as the
reference's ``final.iteration`` is.  The loop runs in chunks of K steps
(``CHUNK_STEPS``), so a level executes K * ceil(iterations / K) steps
(``executed_steps``).  A level's chunk is a program of ``irls_graph``'s
runner (``run_loop``), whose ``loop_form`` chooses up front how it runs: on
the card one launch of a CUDA graph that holds the whole ``while ~done``
loop (a head chunk that starts the level, then a conditional WHILE node
around a tail chunk), with no host read from the level's copy-in to its
result, or with ``irls_graph.WHILE_GRAPHS`` off a replay per chunk and a
read of ``done`` after each; elsewhere, or with ``irls_graph.CUDA_GRAPHS``
off, the same chunks eagerly with one read each (``read_done``).  On the
card a whole match is one launch of a graph that chains its levels' loops
with the se3 glue between them captured (``match_prepared``;
``irls_graph.MatchGraph``), with one host wait where the result goes to
the host.  The accept/revert logic keeps the reference's form: a rejected
step keeps the previous carry.

On the card a tracker step of a float32 carry is, besides its evaluation,
two hand-written kernels (``ops/irls_step``, ``_fused_step``): the head
(the trial pose, where the evaluation reads it) and the tail (prior,
solve, termination, accept/revert), which writes the carry in place of the
loop's state, so a tail chunk is four kernel launches and no copy; a
level's first step writes the loop's state buffers too, so a head chunk is
four launches and no copy.  The CPU's and float64's steps are ``_step``,
the kernels' plain version.  Where the steps take the kernels, so does the
match's glue around its levels: three kernels
(``ops/match_glue``) for the start values, the links between levels and
the result row, one launch each, where the CPU and float64 run the plain
functions ``match_start``, ``next_start``, ``level_stats``,
``match_result`` and ``flatten_result``.

Lockstep batching: prepared frames whose artifacts carry a leading stream
axis [B, ...] (``prepare_frame`` on batched pyramids) align B independent
pairs at once.  Each iteration runs every op once on [B, ...] tensors and
the loop goes on while any stream is not done; a stream's carry
freezes as soon as that stream is done, which is what the reference's
``lax.while_loop`` does under ``vmap`` with a batched predicate (the
body's output is selected away for finished elements).  So each stream's
iterations, termination and estimate are those of its single-stream solve.
"""

from __future__ import annotations

import contextlib
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..config import InfluenceFunction, ScaleEstimator, TrackerConfig
from ..ops import fused_kernels, irls_step, least_squares, match_glue, robust, se3
from ..ops.camera import Intrinsics
from ..ops.interp import build_quad_table_cm
from ..ops.pyramid import (
    PyramidLevel,
    build_acceleration,
    build_acceleration_cm,
    build_pyramid,
    selection_mask,
)
from ..ops.residuals import compute_residuals, normal_equations, warp_and_sample_cm
from ..utils import timers
from . import irls_graph

# Termination criteria (reference: dense_tracking.h TerminationCriteria).
TERM_NONE = 0
TERM_ITERATIONS_EXCEEDED = 1
TERM_INCREMENT_TOO_SMALL = 2
TERM_LOG_LIKELIHOOD_DECREASED = 3
TERM_TOO_FEW_CONSTRAINTS = 4

# Information-matrix scaling applied to the final Hessian.
INFORMATION_SCALE = 0.008 * 0.008


class LevelStats(NamedTuple):
    """Per-level statistics, device tensors: [] int32 for one stream, [B]
    int32 in lockstep.  ``iterations`` is the loop's carried count (the
    reference's ``final.iteration``)."""

    valid_pixels: torch.Tensor  # [] int32, selected reference points
    valid_constraints: torch.Tensor  # [] int32, constraints of the last accepted iteration
    iterations: torch.Tensor  # [] int32, loop iterations run
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
    iteration: torch.Tensor  # [] int32 iterations run
    termination: torch.Tensor  # [] int32
    done: torch.Tensor  # [] bool


def _weights_for(cfg: TrackerConfig, residuals, precision, mask):
    """The modular path's IRLS weights [..., N] for ``cfg``'s influence
    function: the bivariate t-distribution, or Huber/Tukey (at their
    default constants) of the Mahalanobis distance; the mask itself for
    unit weights or ``use_weighting=False``."""
    if not cfg.use_weighting or cfg.influence_function is InfluenceFunction.UNIT:
        return mask.to(residuals.dtype)
    if cfg.influence_function is InfluenceFunction.TDISTRIBUTION:
        return robust.tdist_weights(residuals, precision, mask, cfg.influence_function_param)
    d = torch.sqrt(torch.clamp(robust.mahalanobis_sq(residuals, precision), min=0.0))
    if cfg.influence_function is InfluenceFunction.HUBER:
        w = robust.huber_weights(d)
    elif cfg.influence_function is InfluenceFunction.TUKEY:
        w = robust.tukey_weights(d)
    else:
        raise ValueError(f"unknown influence function {cfg.influence_function}")
    return torch.where(mask, w, torch.zeros_like(w))


def _scale_for(cfg: TrackerConfig, residuals, weights, n):
    """The modular path's new precision [..., 2, 2] for ``cfg``'s scale
    estimator: the inverse t-distribution scale, the identity, or the
    inverse squared normal / MAD scales of each channel over the pixels
    with a weight above zero."""
    if cfg.scale_estimator is ScaleEstimator.TDISTRIBUTION:
        return robust.precision_from_scale(robust.tdist_scale(residuals, weights, n))
    if cfg.scale_estimator is ScaleEstimator.UNIT:
        eye = torch.eye(2, dtype=residuals.dtype, device=residuals.device)
        return eye.expand(residuals.shape[:-2] + (2, 2))
    if cfg.scale_estimator is ScaleEstimator.NORMAL:
        scale = robust.normal_scale
    elif cfg.scale_estimator is ScaleEstimator.MAD:
        scale = robust.mad_scale
    else:
        raise ValueError(f"unknown scale estimator {cfg.scale_estimator}")
    mask = weights > 0
    s = torch.stack([scale(residuals[..., 0], mask), scale(residuals[..., 1], mask)], dim=-1)
    return torch.diag_embed(1.0 / torch.clamp(s**2, min=1e-12))


def _resolve_backend(cfg: TrackerConfig, device: torch.device) -> str:
    """The inner-loop implementation for tensors on ``device``, as the
    reference resolves it.  The fused evaluation hard-codes the
    t-distribution statistics, so ``auto`` with any other configuration
    (another influence function or scale estimator, or
    ``use_weighting=False``) takes the modular ``xla`` path, and
    ``pallas`` or ``fused`` with one raise.  ``auto`` with the
    t-distribution takes the CUDA kernel ("pallas", after the reference's
    name) for CUDA tensors and the plain twin ("fused") for CPU tensors.
    A caller who names ``fused`` gets the plain twin on either device, as
    the reference runs its XLA twin on the accelerator when asked; ``xla``
    runs on any device."""
    backend = cfg.kernel_backend
    if backend not in ("auto", "fused", "pallas", "xla"):
        raise ValueError(f"unknown kernel_backend {backend!r}")
    tdist = (
        cfg.use_weighting
        and cfg.influence_function is InfluenceFunction.TDISTRIBUTION
        and cfg.scale_estimator is ScaleEstimator.TDISTRIBUTION
    )
    kind = torch.device(device).type
    if backend == "auto":
        if not tdist:
            return "xla"
        backend = "pallas" if kind == "cuda" else "fused"
    elif backend in ("fused", "pallas") and not tdist:
        raise ValueError(f"kernel_backend={backend!r} requires t-distribution weighting")
    if backend == "pallas" and kind != "cuda":
        raise ValueError("kernel_backend='pallas' runs the CUDA kernel: it needs CUDA tensors")
    if backend == "fused" and kind not in ("cpu", "cuda"):
        raise ValueError(f"kernel_backend='fused': no plain twin for {kind} tensors")
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
    accel=None,
):
    """Run the IRLS Gauss-Newton iteration on one pyramid level, from the
    level's prepared artifacts (see :func:`prepare_frame`): the reference
    frame's selection mask and refpack, the current frame's quad table
    (the fused path) or acceleration tensor [..., H, W, 8] (the modular
    path).  With a leading stream axis on every input, B levels solve in
    lockstep."""
    device = sel_mask.device
    backend = _resolve_backend(cfg, device)
    level_shape = tuple(sel_mask.shape[-2:])
    inputs = _level_inputs(backend, sel_mask, refpack, quad, accel)
    chunk = CHUNK_STEPS
    form, _ = irls_graph.loop_form(device)
    if form == "eager":
        evaluate = _evaluation(cfg, backend, intrinsics, level_shape, inputs)
        carry, iterations, trace = _irls_level(
            cfg, evaluate, x0, T0, initial0, precision0, collect_stats, chunk
        )
    else:
        start = (x0, T0, initial0, precision0)
        key, program = _level_loop(cfg, backend, intrinsics, level_shape, inputs, _specs(start),
                                   collect_stats, chunk)
        carry, iterations, trace = _level_out(
            irls_graph.run_loop(form, program, inputs + start, key, _DONE, read_done, _COUNTERS,
                                spans=True),
            collect_stats, x0.dim() - 1)
    with timers.span("dvo.level.out"):
        stats = LevelStats(
            valid_pixels=sel_mask.sum(dim=(-2, -1), dtype=torch.int32),
            valid_constraints=carry.n,
            iterations=iterations,
            termination=carry.termination,
        )
    return carry, stats, trace


def _level_inputs(backend: str, sel_mask, refpack, quad, accel) -> tuple:
    """A level's per-frame inputs on ``backend``'s path: (refpack, quad) on
    the fused path, (sel_mask, refpack, accel) on the modular one."""
    if backend == "xla":
        if refpack is None or accel is None:
            raise ValueError(
                "the modular 'xla' path needs the reference frame's refpack and the "
                "current frame's acceleration tensor: prepare both frames under the "
                "xla config (prepare_frame)"
            )
        return (sel_mask, refpack, accel)
    if quad is None:
        raise ValueError(
            "the fused path needs the current frame's quad table: prepare "
            "the frame under a t-distribution config"
        )
    return (refpack, quad)


def _refpack_index(backend: str) -> int:
    """Where ``_level_inputs`` puts the refpack."""
    return 1 if backend == "xla" else 0


def _evaluation(cfg: TrackerConfig, backend: str, intrinsics: Intrinsics, level_shape, inputs):
    """``evaluate(T, P_prev, first) -> (n, precision_new, ll, A, b)`` of
    one level on ``inputs``: (refpack, quad) on the fused path, (sel_mask,
    refpack, accel) on the modular one."""
    if backend == "xla":
        return _modular_evaluation(cfg, intrinsics, *inputs)
    refpack, quad = inputs
    dof = cfg.influence_function_param
    fused = (
        fused_kernels.warp_fused_stats_plain if backend == "fused"
        else fused_kernels.warp_fused_stats
    )

    def evaluate(T, P_prev, first: bool):
        """One IRLS evaluation in one call (the folded kernel on the
        card, the plain version on the CPU or where ``fused`` is named):
        warp and sample, statistics, new precision, log-likelihood and
        normal equations."""
        return fused(
            refpack, quad, level_shape, intrinsics, T, P_prev, first, dof,
            cfg.depth_buffered_sampling,
        )

    return evaluate


def _modular_evaluation(cfg: TrackerConfig, intrinsics: Intrinsics, sel_mask, refpack, accel):
    """The modular path's ``evaluate(T, P_prev, first) -> (n, precision,
    ll, A, b)``: residuals and Jacobians (always depth-buffered, as the
    reference's), weights from the previous precision (the mask itself on
    the first iteration), the new precision from those weights, the
    t-distribution log-likelihood at it (whatever the influence function:
    the reference's), and the normal equations.  The reference level's
    intensity, depth and gradients are rows 0-3 of its refpack."""
    dof = cfg.influence_function_param
    rows = refpack.unflatten(-1, tuple(sel_mask.shape[-2:]))  # [..., 8, H, W]
    ref_i, ref_z, ref_idx, ref_idy = (rows[..., c, :, :] for c in range(4))

    def evaluate(T, P_prev, first: bool):
        rd = compute_residuals(ref_i, ref_z, ref_idx, ref_idy, sel_mask, accel, intrinsics, T)
        if first:
            weights = rd.mask.to(refpack.dtype)
        else:
            weights = _weights_for(cfg, rd.residuals, P_prev, rd.mask)
        precision_new = _scale_for(cfg, rd.residuals, weights, rd.num_valid)
        ll = robust.tdist_log_likelihood(rd.residuals, precision_new, rd.mask, dof)
        A, b = normal_equations(rd, weights, precision_new)
        return rd.num_valid, precision_new, ll, A, b

    return evaluate


def _where(cond, new, old):
    """``torch.where`` with ``cond`` [...] broadcast over the trailing
    dimensions of ``new`` / ``old`` [..., *]."""
    return torch.where(cond.reshape(cond.shape + (1,) * (new.dim() - cond.dim())), new, old)


# K, the steps of the IRLS loop per chunk (between two reads of its ``done``
# flags where the loop reads them), on every device.  One: under the card's
# host-polled graphs K = 1 tracked the most frames/s, one stream and 8 in
# lockstep alike, since an inert step costs more device time than a read
# costs the host (PERF.md §6; ``tools/chunk_sweep.py`` sets other values),
# and in the while form a larger K only adds inert steps.  Not a
# TrackerConfig field: the reference has none.
CHUNK_STEPS = 1


def executed_steps(iterations, chunk: int) -> int:
    """Steps the chunked loop executes for per-level loop iterations (an
    int, or a sequence or tensor of per-level counts; in lockstep a level's
    count is its slowest stream's): K * ceil(iterations / K) per level,
    since the loop reads ``done`` after every K steps."""
    its = torch.as_tensor(iterations, dtype=torch.int64)
    return int(((its + chunk - 1) // chunk * chunk).sum())


class _Constants(NamedTuple):
    """Tensors every step of a level reads."""

    eye6: torch.Tensor  # [6, 6]
    codes: torch.Tensor  # [5] int32, the termination codes
    rows: torch.Tensor  # [max_iterations, 1...] the trace's row numbers


def _constants(cfg: TrackerConfig, x0) -> _Constants:
    batch = x0.dim() - 1
    return _Constants(
        eye6=torch.eye(6, dtype=x0.dtype, device=x0.device),
        codes=torch.arange(5, dtype=torch.int32, device=x0.device),
        rows=torch.arange(cfg.max_iterations_per_level, device=x0.device).reshape(
            (-1,) + (1,) * batch),
    )


def _initial_carry(x0, T0, initial0, precision0, consts: _Constants) -> _Carry:
    dtype, device = x0.dtype, x0.device
    batch = tuple(x0.shape[:-1])
    return _Carry(
        x=x0,
        T=T0,
        initial=initial0,
        inc_applied=se3.exp_se3(x0),
        precision=precision0,
        error=torch.full(batch, float("inf"), dtype=dtype, device=device),
        A=consts.eye6.expand(batch + (6, 6)),
        ll=torch.full(batch, float("-inf"), dtype=dtype, device=device),
        n=torch.zeros(batch, dtype=torch.int32, device=device),
        iteration=torch.zeros(batch, dtype=torch.int32, device=device),
        termination=torch.full(batch, TERM_NONE, dtype=torch.int32, device=device),
        done=torch.zeros(batch, dtype=torch.bool, device=device),
    )


def _empty_trace(cfg: TrackerConfig, x0) -> IterationStats:
    """Trace buffers [max_iterations, *batch, ...] of zeros."""
    batch = tuple(x0.shape[:-1])
    zeros = lambda *s: torch.zeros(  # noqa: E731
        (cfg.max_iterations_per_level,) + batch + s, dtype=x0.dtype, device=x0.device)
    return IterationStats(
        valid_constraints=zeros(),
        log_likelihood=zeros(),
        precision=zeros(2, 2),
        increment=zeros(6),
        information=zeros(6, 6),
    )


def _step(cfg: TrackerConfig, evaluate, c: _Carry, first: bool, consts: _Constants):
    """One IRLS iteration from ``c``: apply the increment, evaluate, accept
    or revert, smooth toward the prior, solve, test termination.  Returns
    (the new carry, the iteration's trace row as executed)."""
    inc = se3.exp_se3(c.x)
    T_new = inc @ c.T
    initial_new = se3.inverse(inc) @ c.initial

    n, precision_new, ll, A, b = evaluate(T_new, c.precision, first)
    too_few = n < 6
    error = -ll

    accept = error < c.error
    reject = too_few | ~accept

    if cfg.use_estimate_smoothing:
        # prior toward the initial guess
        A = A + cfg.mu * consts.eye6
        b = b + cfg.mu * se3.log_se3(initial_new)
    x_new = least_squares.solve_ldlt(A, b)

    converged = torch.amax(torch.abs(x_new), dim=-1) <= cfg.precision
    exceeded = c.iteration + 1 >= cfg.max_iterations_per_level

    code = consts.codes
    termination = torch.where(
        too_few,
        code[TERM_TOO_FEW_CONSTRAINTS],
        torch.where(
            ~accept,
            code[TERM_LOG_LIKELIHOOD_DECREASED],
            torch.where(
                converged,
                code[TERM_INCREMENT_TOO_SMALL],
                torch.where(exceeded, code[TERM_ITERATIONS_EXCEEDED], code[TERM_NONE]),
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
        iteration=c.iteration + 1,
        termination=termination,
        done=reject | converged | exceeded,
    )
    # telemetry of the iteration as executed (before any revert)
    row = IterationStats(
        valid_constraints=n.to(A.dtype),
        log_likelihood=ll,
        precision=precision_new,
        increment=x_new,
        information=A,
    )
    return new_c, row


def fused_step_applies(x: torch.Tensor) -> bool:
    """Whether a level (the tracker's or the pixel-sharded one) whose
    increments are like ``x`` (a carry's or start's, [*batch, 6]) steps
    through the card's step kernels (``_fused_step``): CUDA float32
    carries, whatever the batch.  The CPU's and float64's take ``_step``."""
    return x.is_cuda and x.dtype == torch.float32


def _fused_step(cfg: TrackerConfig, evaluate, c: Optional[_Carry], trace, first: bool,
                freeze: bool, start=None, into: Optional[_Carry] = None) -> _Carry:
    """``_step`` on the card, with ``_chunk``'s freeze and trace row: the
    head kernel (the trial pose), ``evaluate``, and the tail kernel, which
    writes the new carry in place of ``c`` (the loop's state) and the
    iteration's row into ``trace`` (the loop's buffers) where there is one.
    With ``start`` (a level's four start values) in place of ``c`` the step
    is the level's first, from its initial carry (``_initial_carry``'s, made
    by the tail kernel), into ``into`` (the loop's state buffers) or new
    buffers.  Returns the new carry."""
    x, T, initial, precision = start if c is None else (c.x, c.T, c.initial, c.precision)
    inc, T_new, initial_new = irls_step.step_head_cuda(x, T, initial)
    evaluation = evaluate(T_new, precision, first)
    out = c if c is not None else into
    if out is None:
        batch = tuple(x.shape[:-1])
        out = _Carry(*(torch.empty(batch + shape, dtype=dtype, device=x.device)
                       for shape, dtype in irls_step.CARRY))
    irls_step.step_tail_cuda(
        evaluation, (inc, T_new, initial_new), start if c is None else c, out, trace,
        freeze=freeze, smoothing=cfg.use_estimate_smoothing, mu=cfg.mu, precision=cfg.precision,
        max_iterations=cfg.max_iterations_per_level, start=c is None)
    return out


def _chunk(cfg: TrackerConfig, evaluate, carry: Optional[_Carry], trace, steps: int,
           first: bool, consts: Optional[_Constants], fused: bool = False, start=None,
           into: Optional[_Carry] = None):
    """``steps`` IRLS steps from ``carry`` (the first with ``first``), each
    frozen where the carry is already done: a step past ``done`` leaves the
    carry, its iteration count and the trace as they were.  An active
    step writes its trace row at its stream's iteration.  Returns (carry,
    trace).  With ``fused`` the steps are ``_fused_step``'s, which write in
    place of ``carry`` and ``trace`` (the loop's state), or start a level
    from its four start values ``start`` in place of a ``carry`` (None),
    into ``into`` where it is given (the loop's state buffers).

    A chunk of one step of one stream has nothing to freeze: the loop runs
    it only from a carry that is not done (it reads ``done`` after every
    step, or the WHILE node tests it before every chunk), so it takes the
    step as it is."""
    freeze = steps > 1 or (carry.done.dim() > 0 if carry is not None else start[0].dim() > 1)
    if fused:
        for k in range(steps):
            carry = _fused_step(cfg, evaluate, carry, trace, first and k == 0, freeze,
                                start if k == 0 else None, into if k == 0 else None)
        return carry, trace
    for k in range(steps):
        stepped, row = _step(cfg, evaluate, carry, first and k == 0, consts)
        active = ~carry.done if freeze else None
        if trace is not None:
            hit = consts.rows == carry.iteration  # [max_iterations, *batch]
            if freeze:
                hit = hit & active
            trace = IterationStats(*(_where(hit, r.unsqueeze(0), buf) for r, buf in zip(row, trace)))
        if freeze:
            stepped = _Carry(*(_where(active, new, old) for new, old in zip(stepped, carry)))
        carry = stepped
    return carry, trace


def read_done(state) -> bool:
    """The eager and host-polled loops' one host read per chunk: whether
    every stream of a level's state (a carry, or a chunk's flat state) is
    done.  Each call adds one to ``read_done.calls``."""
    read_done.calls += 1
    done = state[_DONE]
    return bool(done.all() if done.dim() else done)


read_done.calls = 0


def _trace_out(trace, batch: int):
    """The trace with the stream axis first: [*batch, max_iterations, ...]."""
    if trace is None or not batch:
        return trace
    return IterationStats(*(buf.movedim(0, batch) for buf in trace))


def _level_out(state, collect_stats: bool, batch: int):
    """(carry, iterations: the carry's int32 count, trace or None with the
    stream axis first) of a level's final flat state."""
    carry = _Carry(*state[:_CARRY_FIELDS])
    trace = IterationStats(*state[_CARRY_FIELDS:]) if collect_stats else None
    return carry, carry.iteration, _trace_out(trace, batch)


def _irls_level(
    cfg: TrackerConfig, evaluate, x0, T0, initial0, precision0, collect_stats: bool = False,
    chunk: int = 1,
):
    """The IRLS loop of one level around ``evaluate(T, P_prev, first) ->
    (n, precision_new, ll, A, b)``, run eagerly (``irls_graph.run_loop``)
    in chunks of ``chunk`` steps with one host read after each
    (``read_done``).  Returns (final carry, iterations: the carry's int32
    count, iteration trace or None).

    One stream: ``x0`` [6], the loop stops when ``done``.  B streams in
    lockstep: ``x0`` [B, 6], the loop stops when every stream is done, a
    finished stream's carry is frozen (its evaluation still runs with the
    batch, and is discarded).  With ``chunk`` = 1 this is the loop read for
    read; a larger chunk runs up to ``chunk`` - 1 inert steps past the last
    ``done`` and gives the same carry, counts and trace."""
    program = _level_program(cfg, lambda static: evaluate, 0, collect_stats, chunk)
    state = irls_graph.run_loop("eager", program, (x0, T0, initial0, precision0), None, _DONE,
                                read_done)
    return _level_out(state, collect_stats, x0.dim() - 1)


# the kernel wrappers' and plain functions' call counts that a step moves:
# a graph's chunk adds what its capture would have added
_COUNTERS = (
    (fused_kernels.warp_fused_stats_cuda, "launches"),
    (fused_kernels.warp_fused_stats_batched_cuda, "launches"),
    (warp_and_sample_cm, "calls"),
    (compute_residuals, "calls"),
    (irls_step.step_head_cuda, "launches"),
    (irls_step.step_tail_cuda, "launches"),
    (match_glue.setup_cuda, "launches"),
    (match_glue.link_cuda, "launches"),
    (match_glue.result_cuda, "launches"),
)
_TAIL_LAUNCHES = _COUNTERS.index((irls_step.step_tail_cuda, "launches"))
_CARRY_FIELDS = len(_Carry._fields)
_DONE = _Carry._fields.index("done")


def _level_loop(cfg: TrackerConfig, backend: str, intrinsics: Intrinsics, level_shape, inputs,
                start_specs, collect_stats: bool, chunk: int):
    """A level's loop as graphs: (its graph key, its chunk program).  The
    key holds what a step bakes in, with the (shape, dtype) of the level's
    ``inputs`` and of its four start values (``start_specs``)."""
    key = (
        backend, level_shape, chunk, collect_stats, tuple(intrinsics),
        _specs(inputs) + tuple(start_specs), cfg.max_iterations_per_level, cfg.precision, cfg.mu,
        cfg.use_weighting, cfg.influence_function, cfg.influence_function_param,
        cfg.scale_estimator, cfg.depth_buffered_sampling,
    )
    program = _level_program(
        cfg, functools.partial(_evaluation, cfg, backend, intrinsics, level_shape), len(inputs),
        collect_stats, chunk)
    return key, program


def _specs(tensors) -> tuple:
    return tuple((tuple(t.shape), t.dtype) for t in tensors)


def _level_program(cfg: TrackerConfig, make_evaluate, level_inputs: int, collect_stats: bool,
                   chunk: int):
    """A level's chunk over its static buffers (the inputs, then the four
    start values), as ``irls_graph`` captures it: ``program(static, state)``
    starts the level (``state`` None: the head) or continues it (the
    tail), in place of ``state`` where the steps are the card's step
    kernels (``fused_step_applies``); such a head writes the loop's state
    buffers in place too where ``irls_graph`` hands them over (``into``)."""

    def program(static, state, into=None):
        evaluate = make_evaluate(static[:level_inputs])
        x, T, initial, precision = static[level_inputs:]
        # the step kernels make the initial carry themselves and read no constant
        kernels = fused_step_applies(x)
        consts = None if kernels else _constants(cfg, x)
        start = out = None
        if state is None:
            carry = None if kernels else _initial_carry(x, T, initial, precision, consts)
            start = (x, T, initial, precision) if kernels else None
            if kernels and into is not None:
                out = _Carry(*into[:_CARRY_FIELDS])
                trace = (IterationStats(*(t.zero_() for t in into[_CARRY_FIELDS:]))
                         if collect_stats else None)
            else:
                trace = _empty_trace(cfg, x) if collect_stats else None
        else:
            carry = _Carry(*state[:_CARRY_FIELDS])
            trace = IterationStats(*state[_CARRY_FIELDS:]) if collect_stats else None
        carry, trace = _chunk(cfg, evaluate, carry, trace, chunk, state is None, consts,
                              fused=kernels, start=start, into=out)
        return tuple(carry) + (tuple(trace) if collect_stats else ())

    return program


class PreparedFrame(NamedTuple):
    """Per-frame cached solver artifacts, one entry per pyramid level
    (``None`` outside the solve range).  ``sel``/``refpack`` serve the
    frame's reference role on both paths (the modular path reads the
    reference level's intensity, depth and gradients from refpack rows
    0-3), ``quad`` its current role on the fused path and ``accel`` on the
    modular one; the other is None, so a frame holds one of them.  (The
    reference also carries the levels, which ``frames.Frame.levels`` holds
    here.)"""

    sel: Tuple[Optional[torch.Tensor], ...]
    refpack: Tuple[Optional[torch.Tensor], ...]
    quad: Tuple[Optional[torch.Tensor], ...]
    accel: Tuple[Optional[torch.Tensor], ...]


def prepare_frame(
    cfg: TrackerConfig, intrinsics: Intrinsics, levels: Sequence[PyramidLevel]
) -> PreparedFrame:
    """Precompute both roles' per-level artifacts for the solve range:
    selection mask and refpack [8, N], and the quad table [32, N] (fused
    path) or the acceleration tensor [H, W, 8] (modular path), each with a
    leading [B] for batched pyramids.  Each call adds one to
    ``prepare_frame.calls``."""
    prepare_frame.calls += 1
    modular = _resolve_backend(cfg, levels[cfg.first_level].intensity.device) == "xla"
    n = len(levels)
    sel = [None] * n
    refpack = [None] * n
    quad = [None] * n
    accel = [None] * n
    for level in range(cfg.last_level, cfg.first_level + 1):
        lv = levels[level]
        sel[level] = selection_mask(
            lv, cfg.intensity_derivative_threshold, cfg.depth_derivative_threshold
        )
        refpack[level] = _build_refpack(lv, sel[level], intrinsics.at_level(level))
        if modular:
            accel[level] = build_acceleration(lv)
        else:
            quad[level] = build_quad_table_cm(
                build_acceleration_cm(lv), lv.intensity.shape[-1]
            )
    return PreparedFrame(sel=tuple(sel), refpack=tuple(refpack), quad=tuple(quad),
                         accel=tuple(accel))


prepare_frame.calls = 0


def ref_artifacts(prepared: PreparedFrame) -> PreparedFrame:
    """Strip a PreparedFrame to its reference-role artifacts (selection
    mask and refpack): what a keyframe must keep for later matches."""
    none = (None,) * len(prepared.sel)
    return PreparedFrame(sel=prepared.sel, refpack=prepared.refpack, quad=none, accel=none)


# the flat result row: 16 (T) + 36 (information) + 1 (nll), then 4 per solved
# level (valid pixels, valid constraints, iterations, termination), float32
FLAT_BASE = match_glue.ROW_BASE
_SELECTED = 6  # the refpack's row of the selection mask


def _glue_link(final: _Carry, out=None):
    """``next_start`` as the glue kernel, into ``out`` (static buffers) or
    new tensors."""
    return match_glue.link_cuda(final.inc_applied, final.T, final.initial, final.precision, out)


def _glue_result(cfg: TrackerConfig, finals: Sequence[_Carry], refpacks, out=None):
    """The glue kernel's result row of a match's final carries and refpacks
    (``level_stats``, ``match_result`` and ``flatten_result`` in one
    launch), into ``out`` or a new tensor."""
    last = finals[-1]
    return match_glue.result_cuda(
        (last.T, last.initial, last.A, last.ll),
        [((f.n, f.iteration, f.termination), refpack) for f, refpack in zip(finals, refpacks)],
        smoothing=cfg.use_estimate_smoothing, mu=cfg.mu, info_scale=INFORMATION_SCALE, out=out)


def match_start(initial, batch: tuple, dtype, device):
    """The first level's start values (x, T, initial, precision) from the
    warm start ``initial`` (result space, [*batch, 4, 4] in ``dtype`` on
    ``device``) or the identity (None): the estimate's inverse is the first
    increment and the prior's offset."""
    if initial is None:
        guess = torch.eye(4, dtype=dtype, device=device).expand(batch + (4, 4))
    else:
        guess = se3.inverse(initial)
    return (
        se3.log_se3(guess),
        se3.identity(dtype, device).expand(batch + (4, 4)),
        guess,
        torch.eye(2, dtype=dtype, device=device).expand(batch + (2, 2)),
    )


def next_start(final: _Carry):
    """The next level's start values from a level's final carry: the last
    APPLIED increment as x (the reference's ``x = inc.log()`` at level entry,
    dense_tracking.cpp:241), the estimate, the prior's offset and the
    precision."""
    return se3.log_se3(final.inc_applied), final.T, final.initial, final.precision


def level_stats(refpack, final: _Carry) -> LevelStats:
    """A level's statistics from its refpack (the selected pixels of its
    selection row) and its final carry: in a match graph, what
    ``_match_level`` gives from the selection mask and the loop's count."""
    return LevelStats(
        valid_pixels=(refpack[..., _SELECTED, :] != 0).sum(dim=-1, dtype=torch.int32),
        valid_constraints=final.n,
        iterations=final.iteration,
        termination=final.termination,
    )


def match_result(cfg: TrackerConfig, final: _Carry, stats: Sequence[LevelStats],
                 iteration_stats: Sequence[IterationStats] = ()) -> TrackingResult:
    """The match's result from the finest level's final carry: the pose is
    the inverse of the warp estimate, the information the scaled Hessian,
    and the negative log-likelihood adds the prior's term with smoothing."""
    if cfg.use_estimate_smoothing:
        prior = cfg.mu * torch.sum(se3.log_se3(final.initial) ** 2, dim=-1)
    else:
        prior = torch.zeros_like(final.ll)
    return TrackingResult(
        transformation=se3.inverse(final.T),
        information=final.A * INFORMATION_SCALE,
        neg_log_likelihood=-final.ll + prior,
        level_stats=tuple(stats),
        iteration_stats=tuple(iteration_stats),
    )


def flatten_result(r: TrackingResult) -> torch.Tensor:
    """A result as one float32 row [*batch, 53 + 4 * levels] on its device."""
    batch = tuple(r.transformation.shape[:-2])
    f32 = torch.float32
    stats = [torch.stack([f.to(f32).expand(batch) for f in s], dim=-1) for s in r.level_stats]
    return torch.cat(
        [
            r.transformation.reshape(batch + (16,)).to(f32),
            r.information.reshape(batch + (36,)).to(f32),
            r.neg_log_likelihood.reshape(batch + (1,)).to(f32),
            *stats,
        ],
        dim=-1,
    )


def result_from_row(row: torch.Tensor,
                    iteration_stats: Sequence[IterationStats] = ()) -> TrackingResult:
    """The ``TrackingResult`` of a float32 result row (views of it; the
    counts as int32): the inverse of ``flatten_result`` for float32
    results."""
    batch = tuple(row.shape[:-1])
    levels = (row.shape[-1] - FLAT_BASE) // 4
    counts = row[..., FLAT_BASE:].reshape(batch + (levels, 4)).to(torch.int32)
    return TrackingResult(
        transformation=row[..., :16].reshape(batch + (4, 4)),
        information=row[..., 16:52].reshape(batch + (6, 6)),
        neg_log_likelihood=row[..., 52],
        level_stats=tuple(LevelStats(*counts[..., level, :].unbind(-1))
                          for level in range(levels)),
        iteration_stats=tuple(iteration_stats),
    )


def match_graph_form(device, group: tuple = ()) -> bool:
    """Whether a match on ``device`` runs as one launch of a match graph
    (``irls_graph.MatchGraph``): where a level, a loop without collectives,
    would run as one while-graph launch (``irls_graph.loop_form``: the card
    with both switches on) and the call carries no process group
    (``group``: a ``group_key``, or ``()``).  Elsewhere the levels run one
    by one (``_match_level``)."""
    return not group and irls_graph.loop_form(device)[0] == "while"


def _takes_match_graph(ref: PreparedFrame, first_level: int) -> bool:
    """``match_graph_form`` for these frames, whose result a float32 row
    holds exactly."""
    refpack0 = ref.refpack[first_level]
    return match_graph_form(refpack0.device) and refpack0.dtype == torch.float32


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
    tensors.

    On the card (``match_graph_form``) the match is one launch of a match
    graph; the result's tensors are views of one copy of its result row
    (and, with ``collect_iteration_stats``, copies of the levels' traces),
    so no later match overwrites them.  Spans: ``dvo.level.copy_in`` (the
    loads), ``dvo.match.graph`` around ``dvo.level.graph`` (the launch,
    with timing events), ``dvo.match.result``.  Elsewhere the levels run
    one by one: spans ``dvo.match.setup``, per level
    ``dvo.level.copy_in``, ``.graph`` (with timing events) and ``.out``,
    then ``dvo.match.result``."""
    if _takes_match_graph(ref, cfg.first_level):
        return _match_graph(cfg, intrinsics, ref, cur, initial_transformation,
                            collect_iteration_stats, "result")
    return _match_per_level(cfg, intrinsics, ref, cur, initial_transformation,
                            collect_iteration_stats)


def match_prepared_flat(cfg: TrackerConfig, intrinsics: Intrinsics, ref: PreparedFrame,
                        cur: PreparedFrame, initial_transformation=None, host: bool = False):
    """``match_prepared``'s result as its flat float32 row [*batch, 53 + 4 *
    levels] (``flatten_result``): with ``host`` a NumPy array (one copy and
    one wait; from a match graph, its pinned row), else a tensor on the
    device of its own."""
    if _takes_match_graph(ref, cfg.first_level):
        return _match_graph(cfg, intrinsics, ref, cur, initial_transformation, False,
                            "host" if host else "row")
    result = _match_per_level(cfg, intrinsics, ref, cur, initial_transformation)
    with timers.span("dvo.match.result"):
        row = flatten_result(result)
        return row.cpu().numpy() if host else row


def _match_per_level(cfg: TrackerConfig, intrinsics: Intrinsics, ref: PreparedFrame,
                     cur: PreparedFrame, initial_transformation=None,
                     collect_iteration_stats: bool = False) -> TrackingResult:
    """The match level by level (``_match_level``), the glue between the
    levels issued by the host."""
    refpack0 = ref.refpack[cfg.first_level]
    dtype, device = refpack0.dtype, refpack0.device
    batch = tuple(refpack0.shape[:-2])
    kernels = fused_step_applies(refpack0)
    if device.type == "cuda":
        irls_graph.match_counts.per_level += 1
        irls_graph.match_counts.levels += cfg.first_level - cfg.last_level + 1
    with timers.span("dvo.match.setup"):
        initial = (None if initial_transformation is None
                   else torch.as_tensor(initial_transformation, device=device).to(dtype))
        x, T, initial, precision = (match_glue.setup_cuda(initial, batch, device) if kernels
                                    else match_start(initial, batch, dtype, device))

    stats = []
    iteration_stats = []
    finals = []
    for level in range(cfg.first_level, cfg.last_level - 1, -1):
        final, level_out, trace = _match_level(
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
            accel=cur.accel[level],
        )
        stats.append(level_out)
        finals.append(final)
        if collect_iteration_stats:
            iteration_stats.append(trace)
        with timers.span("dvo.level.out"):
            if level > cfg.last_level:
                x, T, initial, precision = _glue_link(final) if kernels else next_start(final)

    with timers.span("dvo.match.result"):
        if kernels:
            refpacks = [ref.refpack[level] for level in range(cfg.first_level,
                                                              cfg.last_level - 1, -1)]
            return result_from_row(_glue_result(cfg, finals, refpacks), iteration_stats)
        return match_result(cfg, final, stats, iteration_stats)


def _match_graph(cfg: TrackerConfig, intrinsics: Intrinsics, ref: PreparedFrame,
                 cur: PreparedFrame, initial, collect_iteration_stats: bool, out: str):
    """The match as one launch of its match graph, keyed by its levels'
    keys, the batch, whether a warm start is given and
    ``use_estimate_smoothing`` (built at the key's first use); its glue is
    the glue kernels (``ops/match_glue``).  The host
    copies each level's per-frame inputs and the warm start into the static
    buffers, launches, and returns (``out``) the result row on the host
    ("host": waits once), a copy of it on the card ("row"), or a
    ``TrackingResult`` of views of such a copy ("result")."""
    refpack0 = ref.refpack[cfg.first_level]
    dtype, device = refpack0.dtype, refpack0.device
    batch = tuple(refpack0.shape[:-2])
    backend = _resolve_backend(cfg, device)
    chunk = CHUNK_STEPS
    start = ((batch + (6,), dtype), (batch + (4, 4), dtype), (batch + (4, 4), dtype),
             (batch + (2, 2), dtype))
    keys, inputs, programs = [], [], []
    for level in range(cfg.first_level, cfg.last_level - 1, -1):
        k_level = intrinsics.at_level(level)
        level_shape = tuple(ref.sel[level].shape[-2:])
        level_inputs = _level_inputs(backend, ref.sel[level], ref.refpack[level], cur.quad[level],
                                     cur.accel[level])
        key, program = _level_loop(cfg, backend, k_level, level_shape, level_inputs, start,
                                   collect_iteration_stats, chunk)
        keys.append(key)
        inputs.append(level_inputs)
        programs.append(program)
    key = ("match", tuple(keys), batch, initial is None, cfg.use_estimate_smoothing)
    at = _refpack_index(backend)

    def setup(init, out=None):
        return match_glue.setup_cuda(init, batch, device, out)

    def link(state, out=None):
        return _glue_link(_Carry(*state[:_CARRY_FIELDS]), out)

    def result(states, statics, out=None):
        finals = [_Carry(*state[:_CARRY_FIELDS]) for state in states]
        return _glue_result(cfg, finals, [static[at] for static in statics], out)

    levels = [irls_graph.graphs_for(k, device) for k in keys]
    with irls_graph.holding(levels):
        match = irls_graph.match_graph_for(key, device, levels)
        if match.exec is None:
            match.build(
                inputs,
                None if initial is None else torch.as_tensor(initial, device=device).to(dtype),
                setup, programs, link, result, _COUNTERS, _DONE)
        with timers.span("dvo.level.copy_in"):
            for graphs, level_inputs in zip(levels, inputs):
                graphs.load(level_inputs)
            if initial is not None:
                match.load_initial(initial)
        # whether the levels' tail captures hold the step kernels, and the
        # glue captures the glue kernels (their launch counts moved there)
        fused_tail = all(g.deltas[1][_TAIL_LAUNCHES] for g in levels)
        glue = any(match.glue_deltas)
        with timers.span("dvo.match.graph"), (
                timers.span("dvo.match.fused_tail") if fused_tail else contextlib.nullcontext()), (
                timers.span("dvo.match.glue_kernels") if glue else contextlib.nullcontext()):
            with timers.span("dvo.level.graph", device=True):
                match.launch()
        with timers.span("dvo.match.result"):
            if out == "host":
                return match.host_row()
            row = match.row.clone()
            if out == "row":
                return row
            traces = [
                _trace_out(IterationStats(*(t.clone() for t in g.state[_CARRY_FIELDS:])),
                           len(batch))
                for g in levels] if collect_iteration_stats else ()
            return result_from_row(row, traces)


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
