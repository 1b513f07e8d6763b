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
(``executed_steps``).  On the card a tracker level is one launch of a CUDA
graph that holds the whole ``while ~done`` loop (``irls_graph``: a head
chunk that starts the level, then a conditional WHILE node around a tail
chunk), with no host read from the level's copy-in to its result; the
multi-rank loops, whose graphs hold collectives, replay a graph per chunk
and read ``done`` after each, and so does the card with ``WHILE_GRAPHS``
off.  Elsewhere, or with ``CUDA_GRAPHS`` off, the same chunks run eagerly
and read ``done`` once per chunk (``read_done``).  The accept/revert logic
keeps the reference's form: a rejected step keeps the previous carry.

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

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..config import InfluenceFunction, ScaleEstimator, TrackerConfig
from ..ops import fused_kernels, least_squares, robust, se3
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
    if backend == "xla":
        if refpack is None or accel is None:
            raise ValueError(
                "the modular 'xla' path needs the reference frame's refpack and the "
                "current frame's acceleration tensor: prepare both frames under the "
                "xla config (prepare_frame)"
            )
        inputs = (sel_mask, refpack, accel)
    else:
        if quad is None:
            raise ValueError(
                "the fused path needs the current frame's quad table: prepare "
                "the frame under a t-distribution config"
            )
        inputs = (refpack, quad)
    chunk = CHUNK_STEPS
    if torch.device(device).type == "cuda" and CUDA_GRAPHS:
        carry, iterations, trace = _graph_level(
            cfg, backend, intrinsics, level_shape, inputs, x0, T0, initial0, precision0,
            collect_stats, chunk,
        )
    else:
        evaluate = _evaluation(cfg, backend, intrinsics, level_shape, inputs)
        carry, iterations, trace = _irls_level(
            cfg, evaluate, x0, T0, initial0, precision0, collect_stats, chunk
        )
    stats = LevelStats(
        valid_pixels=sel_mask.sum(dim=(-2, -1), dtype=torch.int32),
        valid_constraints=carry.n,
        iterations=iterations,
        termination=carry.termination,
    )
    return carry, stats, trace


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
# Whether the card runs the loops as CUDA graphs (``irls_graph``); off, it
# runs the same chunked loop eagerly (the graphs' reference in the checks).
CUDA_GRAPHS = True
# Whether a tracker level on the card (its key carries no process group)
# runs as one while-graph launch; off, as host-polled chunk replays of the
# same graphs (the comparison form of the checks and probes).
WHILE_GRAPHS = True


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


def _chunk(cfg: TrackerConfig, evaluate, carry: _Carry, trace, steps: int, first: bool,
           consts: _Constants):
    """``steps`` IRLS steps from ``carry`` (the first with ``first``), each
    frozen where the carry is already done: a step past ``done`` leaves the
    carry, its iteration count and the trace as they were.  An active
    step writes its trace row at its stream's iteration.  Returns (carry,
    trace).

    A chunk of one step of one stream has nothing to freeze: the loop runs
    it only from a carry that is not done (it reads ``done`` after every
    step, or the WHILE node tests it before every chunk), so it takes the
    step as it is."""
    freeze = steps > 1 or carry.done.dim() > 0
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


def read_done(carry: _Carry) -> bool:
    """The eager and host-polled loops' one host read per chunk: whether
    every stream is done.  Each call adds one to ``read_done.calls``."""
    read_done.calls += 1
    return bool(carry.done.all() if carry.done.dim() else carry.done)


read_done.calls = 0


def _trace_out(trace, batch: int):
    """The trace with the stream axis first: [*batch, max_iterations, ...]."""
    if trace is None or not batch:
        return trace
    return IterationStats(*(buf.movedim(0, batch) for buf in trace))


def _irls_level(
    cfg: TrackerConfig, evaluate, x0, T0, initial0, precision0, collect_stats: bool = False,
    chunk: int = 1,
):
    """The IRLS loop of one level around ``evaluate(T, P_prev, first) ->
    (n, precision_new, ll, A, b)``, run eagerly in chunks of ``chunk``
    steps with one host read after each (``read_done``).  Returns (final
    carry, iterations: the carry's int32 count, iteration trace or None).

    One stream: ``x0`` [6], the loop stops when ``done``.  B streams in
    lockstep: ``x0`` [B, 6], the loop stops when every stream is done, a
    finished stream's carry is frozen (its evaluation still runs with the
    batch, and is discarded).  With ``chunk`` = 1 this is the loop read for
    read; a larger chunk runs up to ``chunk`` - 1 inert steps past the last
    ``done`` and gives the same carry, counts and trace."""
    consts = _constants(cfg, x0)
    carry = _initial_carry(x0, T0, initial0, precision0, consts)
    trace = _empty_trace(cfg, x0) if collect_stats else None
    first = True
    while True:
        carry, trace = _chunk(cfg, evaluate, carry, trace, chunk, first, consts)
        first = False
        if read_done(carry):
            return carry, carry.iteration, _trace_out(trace, x0.dim() - 1)


# the kernel wrappers' and plain functions' call counts that a step moves:
# a graph's chunk adds what its capture would have added
_COUNTERS = (
    (fused_kernels.warp_fused_stats_cuda, "launches"),
    (fused_kernels.warp_fused_stats_batched_cuda, "launches"),
    (warp_and_sample_cm, "calls"),
    (compute_residuals, "calls"),
)
_CARRY_FIELDS = len(_Carry._fields)
_DONE = _Carry._fields.index("done")


def _graph_level(cfg: TrackerConfig, backend: str, intrinsics: Intrinsics, level_shape, inputs,
                 x0, T0, initial0, precision0, collect_stats: bool, chunk: int):
    """The loop of one level on the card as CUDA graphs (``irls_graph``):
    one while-graph launch (host-polled replays with ``WHILE_GRAPHS``
    off); the same returns as ``_irls_level``, bit for bit."""
    key = (
        backend, level_shape, chunk, collect_stats, tuple(intrinsics),
        tuple((tuple(t.shape), t.dtype) for t in inputs + (x0, T0, initial0, precision0)),
        cfg.max_iterations_per_level, cfg.precision, cfg.mu, cfg.use_weighting,
        cfg.influence_function, cfg.influence_function_param, cfg.scale_estimator,
        cfg.depth_buffered_sampling,
    )
    return graph_irls_level(
        cfg, lambda static: _evaluation(cfg, backend, intrinsics, level_shape, static),
        key, _COUNTERS, inputs, x0, T0, initial0, precision0, collect_stats, chunk,
    )


def graph_irls_level(cfg: TrackerConfig, make_evaluate, key: tuple, counters, inputs,
                     x0, T0, initial0, precision0, collect_stats: bool, chunk: int):
    """The runner of a level's loop as CUDA graphs: the head and tail graphs
    of ``key`` (``irls_graph``) over static copies of ``inputs`` and the
    start values, ``make_evaluate(static inputs) -> evaluate`` building the
    step's evaluation on those copies.  A key without a process group runs
    as one while-graph launch, which reads nothing back (with
    ``WHILE_GRAPHS`` on); a key with one (the pixel-sharded level, whose
    chunks hold NCCL all-reduces) replays the head, then the tail, reading
    ``done`` after each.  ``counters`` are the (object, attribute) launch
    counts that a step moves: each chunk adds what its capture would have
    added (the while form when ``irls_graph.fold_counts`` runs).  Returns
    what ``_irls_level`` returns with the same evaluation on ``inputs``,
    bit for bit."""
    start = (x0, T0, initial0, precision0)
    level_inputs = len(inputs)

    def program(static, state):
        """One chunk over the static buffers: the level's start (``state``
        None: the head) or its continuation (the tail)."""
        evaluate = make_evaluate(static[:level_inputs])
        x, T, initial, precision = static[level_inputs:]
        consts = _constants(cfg, x)
        if state is None:
            carry = _initial_carry(x, T, initial, precision, consts)
            trace = _empty_trace(cfg, x) if collect_stats else None
        else:
            carry = _Carry(*state[:_CARRY_FIELDS])
            trace = IterationStats(*state[_CARRY_FIELDS:]) if collect_stats else None
        carry, trace = _chunk(cfg, evaluate, carry, trace, chunk, state is None, consts)
        return tuple(carry) + (tuple(trace) if collect_stats else ())

    polled = not WHILE_GRAPHS or irls_graph.has_group(key)
    graphs = irls_graph.graphs_for(key, torch.device(x0.device))
    with graphs.lock:
        graphs.load(tuple(inputs) + start)
        if polled:
            state = graphs.run_head(program, counters)
            while not read_done(_Carry(*state[:_CARRY_FIELDS])):
                state = graphs.run_tail(counters)
        else:
            state = graphs.run_level(program, counters, _DONE)
        out = tuple(t.clone() for t in state)
    carry = _Carry(*out[:_CARRY_FIELDS])
    trace = IterationStats(*out[_CARRY_FIELDS:]) if collect_stats else None
    return carry, carry.iteration, _trace_out(trace, x0.dim() - 1)


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
            accel=cur.accel[level],
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
