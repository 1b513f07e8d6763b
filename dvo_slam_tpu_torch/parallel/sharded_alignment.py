"""Sharded dense alignment on ``torch.distributed`` (port of
``dvo_slam_tpu.parallel.sharded_alignment``).

  * **Pixel-parallel**: ONE alignment sharded over the reference pixels.
    Every rank holds both pyramids and the current frame's quad table; the
    refpack is zero-padded to a multiple of the world size and each rank
    takes its contiguous column block.  Per iteration each rank's
    evaluation is one call of ``fused_kernels.warp_fused_partials`` on its
    shard and the whole table: on the card three launches of
    ``csrc/fused_stats.cu`` with nothing read from the host, on the CPU
    the plain version:
      1. ``dvo_warp_fused_partials``: warp, depth-buffered sample and the
         residual/weight/Jacobian chain of the shard's pixels in
         registers, the stash (r_I, r_Z, gate) and the shard's 136 float32
         Gram sums (M00, M01, M11, the four J^T r vectors, the scale
         numerator, n) in the all-reduce's layout; then the all-reduce of
         those sums;
      2. ``dvo_sharded_loglik``: the new precision from the reduced sums,
         replicated on every rank, and the shard's sum of
         log1p(r^T P r / dof) over weights > 0; then the all-reduce of
         that scalar;
      3. ``dvo_sharded_tail``: the log-likelihood and the normal equations;
    then, replicated, the rest of the tracker's step: on the card its two
    step kernels (``dense_tracker._fused_step``: the trial pose before the
    evaluation; the smoothing, the 6x6 solve, termination and revert after
    it), on the CPU ``dense_tracker._step``.  So five launches and two
    collectives per iteration on the card.  The
    level runs the reference's device loop (its ``lax.while_loop``,
    ``dvo_slam_tpu/parallel/sharded_alignment.py:200``) as
    ``dense_tracker``'s does: in chunks of K steps (``CHUNK_STEPS``), K *
    ceil(iterations / K) executed steps, each one evaluation.  How it runs
    is chosen up front from the device, the group's backend and the
    group's probe, never by trying (``irls_graph.loop_form``), and the
    tracker's chunk program runs in it (``irls_graph.run_loop``): on the
    card over NCCL the level is one launch of a CUDA graph whose
    conditional WHILE node repeats the chunk, both all-reduces captured in
    its body, with no host read (the keys carry the group, and
    ``distributed.shutdown`` releases them), where the group's probe
    admitted that form (``while_probe``, built by
    ``distributed.initialize``); else, and with
    ``irls_graph.WHILE_GRAPHS`` off, each chunk is one graph replay
    followed by a host read of ``done``.  On the CPU, over gloo (whose
    collectives are host code and cannot be captured, as when two ranks
    share a card) or with ``irls_graph.CUDA_GRAPHS`` off, the same
    chunks run eagerly with a read after each.  Every rank's ``done``
    comes from the all-reduced sums, so every rank runs the same chunks: a
    WHILE loop whose ranks disagreed would wait in a collective for ever.
    The launches take 256 pixels per block in
    clusters of 8 blocks (the tracker's evaluation takes 512), so that a
    rank's share of a level still fills the card; a pixel of the shard
    moves at most 152 bytes (28 of the refpack, 112 of the quad table, 12
    of the stash).  (The reference's docstring says one psum; its code
    psums seven arrays.)
  * **Pair-parallel**: a wave of B frame pairs; each rank prepares its
    contiguous B / world pairs as one batch and aligns them in one lockstep
    ``match_prepared`` call (the reference's ``vmap`` of the matcher; on
    the card the batched folded kernel), and the results are all-gathered
    into one batched ``TrackingResult``.

The pixel-sharded path mirrors the reference's, including where the
reference's sharded path differs from its own single path:
  (a) every level restarts the prior at the identity (``initial =
      identity``): with mu > 0 the smoothing pulls toward the level's start,
      not toward the caller's guess as ``match_prepared`` does;
  (b) ``neg_log_likelihood`` is -ll, with no prior term;
  (c) the sample is always depth-buffered (``depth_buffered_sampling`` is
      not read);
  (d) ``kernel_backend`` is not read (the evaluation goes by the device), and
      the log-determinant floor is 1e-30 where the single path's is 1e-38.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..config import TrackerConfig
from ..models import dense_tracker as dt
from ..models import irls_graph
from ..models.dense_tracker import LevelStats, TrackingResult, match_prepared, prepare_frame
from ..ops import fused_kernels, irls_step, se3
from ..ops.camera import Intrinsics
from ..ops.interp import build_quad_table_cm
from ..ops.pyramid import build_acceleration_cm, selection_mask
from .mesh import BATCH_AXIS, Mesh, local_block, shard_leading_axis

def _check_mesh(mesh: Mesh, axis: str):
    if axis != mesh.axis:
        raise ValueError(f"mesh axis is {mesh.axis!r}, not {axis!r}")


# K, the steps of the pixel-sharded level's loop between two reads of
# ``done``: one, as the tracker's (PERF.md §6: the sweep on the card).
CHUNK_STEPS = 1

# the sharded step's launch counts: a graph replay adds what its capture
# would have added
_COUNTERS = (
    (fused_kernels.warp_fused_partials_cuda, "launches"),
    (fused_kernels.sharded_loglik_cuda, "launches"),
    (fused_kernels.sharded_tail_cuda, "launches"),
    (irls_step.step_head_cuda, "launches"),
    (irls_step.step_tail_cuda, "launches"),
)


def _match_level_sharded(cfg, intrinsics, mesh: Mesh, refpack, quad, shape, x0, T0, precision0):
    """One pyramid level of the pixel-sharded IRLS solve: ``refpack`` is
    this rank's pixel shard [8, N_local], ``quad`` the whole table.
    Returns (final carry, iterations)."""
    device = refpack.device
    dof = cfg.influence_function_param
    chunk = CHUNK_STEPS

    def evaluation(static):
        refpack, quad = static

        def evaluate(T, P_prev, first: bool):
            """One IRLS evaluation with its two collectives: (c) always
            depth-buffered, (d) by the device."""
            return fused_kernels.warp_fused_partials(
                refpack, quad, shape, intrinsics, T, P_prev, first, dof, group=mesh.group
            )

        return evaluate

    identity = se3.identity(x0.dtype, device)  # (a)
    start = (x0, T0, identity, precision0)
    form, part = irls_graph.loop_form(device, mesh.group)
    key = ("sharded", part, tuple(shape), chunk, tuple(intrinsics),
           dt._specs((refpack, quad) + start), cfg.max_iterations_per_level, cfg.precision,
           cfg.mu, dof)
    program = dt._level_program(cfg, evaluation, 2, False, chunk)
    state = irls_graph.run_loop(form, program, (refpack, quad) + start, key, dt._DONE,
                                dt.read_done, _COUNTERS, spans=True)
    return dt._level_out(state, False, 0)[:2]


# the group's probe: a 60x80 level (4,800 pixels: kernel 2's first launch
# on 19 blocks in 3 clusters of 8) and the tail chunks its loop runs
PROBE_SHAPE = (60, 80)
PROBE_INTRINSICS = Intrinsics(64.7, 64.6, 39.8, 31.9)  # TUM_FR1 at 80x60
PROBE_CHUNKS = 3


def while_probe(device, group=None):
    """Choose the form of ``group``'s loops on the card
    (``irls_graph.probe_group``), once, as the group starts: a while graph
    whose body is what the pixel-sharded level's is, one evaluation of
    ``fused_kernels.warp_fused_partials`` (kernel 2's three launches, the
    first in clusters of 8 blocks, and the two all-reduces on ``group``)
    on a seeded 60x80 level, and a step counter whose ``done`` flag ends
    the loop after ``PROBE_CHUNKS`` tail chunks.  Every rank of the group
    calls it.  Returns the ``irls_graph.GroupForm``."""
    h, w = PROBE_SHAPE
    n = h * w
    gen = torch.Generator().manual_seed(0)
    noise = lambda: 0.01 * torch.rand(n, generator=gen)  # noqa: E731
    col = torch.arange(n, dtype=torch.float32) % w
    row = torch.arange(n, dtype=torch.float32) // w
    intensity = 0.5 + 0.3 * torch.sin(col / 5) * torch.cos(row / 7)
    z = 1.0 + 0.05 * torch.sin(col / 9)
    grads = [0.06 * torch.cos(col / 5) + noise(), -0.04 * torch.sin(row / 7) + noise()]
    one, zero = torch.ones(n), torch.zeros(n)
    k = PROBE_INTRINSICS
    refpack = torch.stack([intensity + noise(), z, *grads, (col - k.ox) / k.fx * z,
                           (row - k.oy) / k.fy * z, one, zero])
    accel = torch.stack([intensity, z, *grads, 0.005 * torch.cos(col / 9), zero, one, zero])
    quad = build_quad_table_cm(accel, w)
    twist = se3.exp_se3(torch.tensor([0.002, -0.001, 0.003, 0.001, 0.002, -0.001]))
    limit = torch.full((), PROBE_CHUNKS + 1, dtype=torch.int32)
    inputs = tuple(t.to(device) for t in (refpack, quad, twist, torch.eye(2), limit))
    dof = 5.0

    def program(static, state, into=None):
        refpack, quad, T, P, limit = static
        steps = torch.zeros_like(limit) if state is None else state[0]
        out = fused_kernels.warp_fused_partials(refpack, quad, PROBE_SHAPE, PROBE_INTRINSICS,
                                                T, P, state is None, dof, group=group)
        steps = steps + 1
        return (steps, steps >= limit) + tuple(out)

    return irls_graph.probe_group(device, program, inputs, 1, PROBE_CHUNKS, _COUNTERS, group)


def _solve_pixel_sharded(cfg, intrinsics, mesh: Mesh, ref_levels, cur_levels, initial):
    """The coarse-to-fine pixel-sharded solve -> (``TrackingResult``, the
    last level's final carry)."""
    device = ref_levels[cfg.first_level].intensity.device
    if device != mesh.device:
        raise ValueError(f"pyramids on {device}, the mesh's rank runs on {mesh.device}")
    f32 = torch.float32
    guess = se3.inverse(torch.as_tensor(initial, device=device).to(f32))
    x = se3.log_se3(guess)
    T = se3.identity(f32, device)
    precision = torch.eye(2, dtype=f32, device=device)
    level_stats = []
    final = None
    for level in range(cfg.first_level, cfg.last_level - 1, -1):
        ref_level, cur_level = ref_levels[level], cur_levels[level]
        k_level = intrinsics.at_level(level)
        sel = selection_mask(
            ref_level, cfg.intensity_derivative_threshold, cfg.depth_derivative_threshold
        )
        quad = build_quad_table_cm(build_acceleration_cm(cur_level), cur_level.intensity.shape[1])
        refpack = local_block(dt._build_refpack(ref_level, sel, k_level), mesh, dim=1)
        final, iterations = _match_level_sharded(
            cfg, k_level, mesh, refpack, quad, tuple(ref_level.intensity.shape), x, T, precision
        )
        T = final.T
        x = se3.log_se3(final.inc_applied)
        precision = final.precision
        level_stats.append(
            LevelStats(
                valid_pixels=sel.sum(dtype=torch.int32),
                valid_constraints=final.n,
                iterations=iterations,
                termination=final.termination,
            )
        )
    result = TrackingResult(
        transformation=se3.inverse(final.T),
        information=final.A * dt.INFORMATION_SCALE,
        neg_log_likelihood=-final.ll,  # (b)
        level_stats=tuple(level_stats),
    )
    return result, final


def make_pixel_sharded_matcher(
    cfg: TrackerConfig, intrinsics: Intrinsics, mesh: Mesh, axis: str = BATCH_AXIS
):
    """ONE dense alignment sharded over pixels across the mesh's ranks.
    Returns ``run(ref_levels, cur_levels, initial) -> TrackingResult``; every
    rank calls it with the same pyramids (on ``mesh.device``) and the same
    result-space initial pose [4, 4], and gets the same result."""
    _check_mesh(mesh, axis)

    def run(ref_levels, cur_levels, initial) -> TrackingResult:
        return _solve_pixel_sharded(cfg, intrinsics, mesh, ref_levels, cur_levels, initial)[0]

    return run


def _all_gather(local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    parts = [torch.empty_like(local) for _ in range(mesh.size)]
    dist.all_gather(parts, local, group=mesh.group)
    return torch.cat(parts)


def make_pair_parallel_matcher(
    cfg: TrackerConfig, intrinsics: Intrinsics, mesh: Mesh, axis: str = BATCH_AXIS
):
    """A wave of frame pairs sharded over the mesh's ranks.  Returns
    ``run(ref_stack, cur_stack, inits) -> TrackingResult`` with batched
    fields: transformation [B, 4, 4], information [B, 6, 6],
    neg_log_likelihood [B], and per level ``LevelStats`` of [B] int32
    tensors.  Every rank passes the whole wave (B divisible by the world
    size), aligns its contiguous B / world pairs in one lockstep
    ``match_prepared`` call, and gets the whole wave's results (two
    all-gathers).  Each pair's iterations and terminations are those of its
    ``match_pyramids`` solve; the estimate agrees to the batched 6x6
    solve's rounding."""
    _check_mesh(mesh, axis)

    def run(ref_stack, cur_stack, inits) -> TrackingResult:
        batch = inits.shape[0]
        ref_local, cur_local, inits_local = shard_leading_axis(
            (ref_stack, cur_stack, inits), mesh, axis
        )
        r = match_prepared(
            cfg, intrinsics, prepare_frame(cfg, intrinsics, ref_local),
            prepare_frame(cfg, intrinsics, cur_local), inits_local,
        )
        local = inits_local.shape[0]
        floats = torch.cat([
            r.transformation.reshape(local, 16), r.information.reshape(local, 36),
            r.neg_log_likelihood.reshape(local, 1),
        ], dim=1)
        ints = torch.stack([
            torch.stack([s.valid_pixels, s.valid_constraints, s.iterations, s.termination], dim=1)
            for s in r.level_stats
        ], dim=1)
        f = _all_gather(floats, mesh)  # [B, 53]
        i = _all_gather(ints, mesh)  # [B, levels, 4]
        return TrackingResult(
            transformation=f[:, :16].reshape(batch, 4, 4),
            information=f[:, 16:52].reshape(batch, 6, 6),
            neg_log_likelihood=f[:, 52],
            level_stats=tuple(
                LevelStats(
                    valid_pixels=i[:, lv, 0], valid_constraints=i[:, lv, 1],
                    iterations=i[:, lv, 2], termination=i[:, lv, 3],
                )
                for lv in range(i.shape[1])
            ),
        )

    return run
