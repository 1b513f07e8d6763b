#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dvo_slam_tpu_torch``) on one card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Device: a CUDA card is required (there is no CPU fallback).  Prints
   its name and ``nvidia-smi``'s name and power limit.
2. Build: ``nvcc`` builds ``dvo_slam_tpu_torch/csrc/fused_stats.cu`` (the
   folded, sampled-input, batched and partials entry points) and
   ``csrc/table_copy.cu`` from the checkout, both at once; prints the build
   seconds and the compiler's report.
3. Kernels vs plain versions on the card, on a rendered 640x480 sequence
   at levels 3, 2 and 1.  The folded kernel (``dvo_warp_fused_stats``, the
   tracker's evaluation) against ``warp_fused_stats_plain`` on the first
   pair warped by a small twist, with ``first`` 0/1 and depth-buffered
   sampling on/off: the stash (r_I, r_Z, mask) bit-equal to the plain
   version's (the count of differing entries printed, held to the mask
   equal and atol 1e-6); the Gram element-wise within rtol 1e-6 of the
   float64 Gram of the plain float32 rows; n equal, the precision, ll, A
   and b as ``fused_check.compare_warp_fused_stats`` holds them (rtol 1e-5
   of each quantity's rounding scale, A's entries within 1e-4 of
   sqrt(A_aa A_bb)); two runs bit-identical.  Then B = 8 pairs in one call
   bit-equal per stream to one-stream calls and held to the plain version
   the same way.  Times (CUDA events, median of 30 after 5 warm-ups, in
   turns with the plain version) and device times (the same events with
   the card spinning first, so they bracket the kernels and not the
   host's enqueue) at first = 0, depth-buffered, beside the unfolded pair
   ``warp_and_sample_cm`` + ``fused_stats_cuda``.  The sampled-input
   kernels on the same pair's sampled packs: ``num_valid`` equal; the Gram
   blocks within rtol 1e-6 of the float64 Gram and within 1e-4 of
   sqrt(G_aa G_bb) of the float32 twin's; two runs bit-identical.
   ``fused_stats``: ``log_sum`` within rtol 1e-5.  ``fused_partials``: the
   mask row equal, r_I and r_Z within atol 1e-6, w within rtol 1e-5 of the
   twin's rows, and the count of rw entries that are not bit-equal.
4. Odometry: 100 frames at 640x480 (``TUM_FR1``), frame to frame with a
   constant-velocity warm start at ``benchmark_config().tracker``, from
   u8/u16 frames through ``convert_raw_depth`` -> ``build_pyramid`` ->
   ``match_pyramids``.  The folded kernel's launch count must equal the
   number of solver iterations; the sampled-input kernels and
   ``warp_and_sample_cm`` run 0 times.  Prints ATE-RMSE and tracked
   frames/s.
5. Hard scene: the occluded scene under a 30 cm loop; ATE-RMSE < 10 mm;
   the same counts as phase 4.
6. Sharded paths: a one-rank NCCL process group (``file://`` rendezvous
   in a temporary directory) and its mesh.  The pixel-sharded matcher on
   the first 20 easy pairs from the identity: each pair within 5e-3 of
   the ground truth (max |log(T_gt^-1 T)|), the partials kernel launched
   once per solver iteration and the statistics kernels not at all.  With
   mu = 0, where the sharded and single paths coincide, one pair against
   ``match_pyramids``: per-level iterations and terminations equal,
   estimate within 1e-4, information within rtol 2e-3 / atol 1e-3.  The
   pair-parallel matcher on 8 pairs, bit-equal to ``match_pyramids`` pair
   by pair.  Prints ms per iteration and pairs/s of the sharded path and
   of ``match_pyramids`` on the same 20 pairs.
7. Lockstep multi-stream odometry: 8 streams x 50 frames at 640x480
   (``tools/multistream_bench.render_streams``) through
   ``make_multistream_tracker``.  The batched sampled-input kernel
   (``dvo_fused_stats_batched``) first, against the single-stream one on
   each stream's packs at levels 3, 2, 1 with ``first_iter`` 0, 1 and
   per-stream flags: every output bit-equal per stream; against the plain
   twin per stream as phase 3 holds it; times of kernel and twin at L1.
   Then the run: batched folded launches equal to the lockstep loop
   iterations, no one-stream or sampled-input launch and no
   ``warp_and_sample_cm`` call, every stream's ATE-RMSE < 10 mm.  Prints
   aggregate frames/s, ms per lockstep iteration, the max-over-streams
   iterations per level and the device's busy share (``torch.profiler``
   over 6 frames; null where the profiler records no device event).
8. Schedules: streams 0 and 1, 20 frames, lockstep against sequential:
   per stream, frame and level the iterations and terminations equal (a
   difference is counted as a near-tie flip; more than 5 % fail), every
   pose within 1e-3 (max |log(T_a^-1 T_b)|, tests/test_parallel.py).  On
   a one-rank NCCL mesh the tracker's result bit-equal to the local run.
9. Temporal: the 100-frame sequence of phase 4 in 8 chunks
   (``make_temporal_tracker``): every pose within 1e-3 of phase 4's.
   Prints the ATE-RMSE.
10. Copy kernel and gather probe: ``dvo_table_copy`` bit-equal to
   ``clone()`` on [32, 76800], on ragged shapes (one straddles the bulk
   copy's 8 KB chunks), on a table of more than the 50 MB L2 cache and on
   a table that is not 16-byte aligned; kernel and ``clone()`` times on
   [32, 76800], in turns: on the device cold (a 256 MB buffer written
   before each call) and warm (the table in L2 from the call before), at
   the wrapper, and under ``torch.profiler`` (null where the profiler
   records no device event), beside the HBM bound.  Then the gather probe
   (``tools/gather_probe.py``) at L1, B = 8: every variant bit-equal to
   ``batched``, ms and device ms per iteration each; its ``pcopy`` tables
   are the copy kernel's main path.

The last three lines of standard output are one JSON object describing
the kernels (per kernel: launches on its main path, errors against the
plain version, kernel and plain ms at L1, the bound from this run's
tensor sizes at the card's 3.35 TB/s and 67 TFLOP/s, and the one PyTorch
call that computes the same function where there is one),
``nvidia-smi``'s name and power limit, then ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

SHAPE = (480, 640)
NUM_FRAMES = 100
HARD_ATE_GATE_M = 0.01  # the reference's hard-scene gate (bench.py)
TIMING_REPS = 30
TIMING_WARMUP = 5
KERNEL_SOURCE = "dvo_slam_tpu_torch/csrc/fused_stats.cu"
STATS_REPLACES = "dvo_slam_tpu/ops/pallas_kernels.py:413"
PARTIALS_REPLACES = "dvo_slam_tpu/ops/pallas_kernels.py:252"
SHARDED_PAIRS = 20
WAVE_PAIRS = 8
POSE_GATE = 5e-3  # tests/test_parallel.py: max |log(T_gt^-1 T)| against the ground truth
MU0_POSE_GATE = 1e-4  # tests/test_parallel.py: sharded vs single at mu = 0
STREAMS = 8  # the reference's stream count (tests/test_parallel.py, tools/gather_probe.py)
STREAM_FRAMES = 50
STREAM_ATE_GATE_M = 0.01
SCHEDULE_STREAMS = 2
SCHEDULE_FRAMES = 20
SCHEDULE_POSE_GATE = 1e-3  # tests/test_parallel.py: lockstep vs sequential
SCHEDULE_FLIP_SHARE = 0.05  # near-tie flips tolerated, as a share of stream-frame-levels
TEMPORAL_CHUNKS = 8
TEMPORAL_POSE_GATE = 1e-3  # tests/test_parallel.py: chunked vs sequential
BUSY_FRAMES = 6
BATCHED_REPLACES = "dvo_slam_tpu/ops/pallas_kernels.py:413"  # vmapped (multistream.py:217-227)
COPY_SOURCE = "dvo_slam_tpu_torch/csrc/table_copy.cu"
COPY_REPLACES = "tools/gather_probe.py:382"
COPY_SHAPES = {"l1_table": (32, 76800), "ragged": (7, 1001), "chunk_straddle": (3, 2731),
               "beyond_l2": (32, 460800)}
# about 10 ms of the card's clock ahead of a device-timed call: longer than
# the host takes to enqueue the slowest timed call (the plain version's
# ~120 ops), so the events bracket device work only
SPIN_CYCLES = 20_000_000
COLD_FLUSH_BYTES = 256 * 2**20  # written between cold copy runs: more than the 50 MB L2
CHECK_P_PREV = ((4000.0, 10.0), (10.0, 1.5e5))  # fused_check.CHECK_PRECISION as a matrix
# the H100 SXM's published peaks (NVIDIA's data sheet): HBM bytes/s,
# and float32 (outside the tensor cores) and FP64 tensor-core FLOP/s, both 67 T
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = 67e12
# operations per pixel: about 200 float32 operations of the warp, sample and
# residual chain (about 130 from a sampled pack), and the Gram's three
# distinct 8x8 tiles of 16 rows, 192 float64 multiply-adds
CHAIN_FLOPS, SAMPLED_CHAIN_FLOPS, GRAM_FLOPS = 200, 130, 384


def median_ms(fn, reps=TIMING_REPS, warmup=TIMING_WARMUP):
    """Median device time of ``fn`` in ms (CUDA events around each run)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, reps=TIMING_REPS, warmup=TIMING_WARMUP):
    """Median device time of ``fn`` in ms, without the profiler: the card
    first spins for about 10 ms (``torch.cuda._sleep``), longer than the
    host takes to enqueue the call, so the CUDA events around it bracket
    its kernels and the gaps between them, not the host's work.  (A
    profiler session early in the script would stay attached to every later
    launch.)"""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def cold_ms(fn, flush, reps=TIMING_REPS, warmup=TIMING_WARMUP):
    """Median device time of ``fn`` in ms with a cold L2 cache: ``flush``
    (more bytes than the L2 holds) is written before each run, outside the
    CUDA events around the run."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for i in range(reps):
        flush.fill_(float(i))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _timed(row, kernel_fn, plain_fn, timer=None, prefix=""):
    """Kernel and twin times into ``row`` (keys ``prefix + "ms"``,
    ``prefix + "plain_ms"``): one card, in turns (twin, kernel, kernel,
    twin), the better of each pair; ``timer`` is ``median_ms`` unless
    given."""
    timer = timer or median_ms
    t_plain = [timer(plain_fn)]
    t_kernel = [timer(kernel_fn), timer(kernel_fn)]
    t_plain.append(timer(plain_fn))
    row[prefix + "ms"] = min(t_kernel)
    row[prefix + "plain_ms"] = min(t_plain)


def _bytes(*tensors):
    """Bytes of the tensors, each counted once."""
    return sum(t.numel() * t.element_size() for t in tensors)


def _rows_bytes(pack, rows):
    """Bytes of the first ``rows`` channels of a [..., C, N] pack: what a
    kernel that reads only those channels moves."""
    return pack.numel() // pack.shape[-2] * rows * pack.element_size()


def _quad_bytes(refpack, quad, shape, intrinsics, T):
    """Bytes of the quad table [..., 32, N] that the folded warp reads on
    this run's data: channels 0-6 of the four neighbours (28 of 32 rows) in
    each distinct column, per stream, that a pixel's sample lands on."""
    import torch

    from dvo_slam_tpu_torch.ops.interp import quad_index

    x, y, z = refpack[..., 4, :], refpack[..., 5, :], refpack[..., 1, :]
    R, t = T[..., :3, :3].unsqueeze(-1), T[..., :3, 3].unsqueeze(-1)
    p = [R[..., r, 0, :] * x + R[..., r, 1, :] * y + R[..., r, 2, :] * z + t[..., r, :]
         for r in range(3)]
    z_safe = torch.where(p[2] > 1e-12, p[2], torch.full_like(p[2], 1e-12))
    u = p[0] / z_safe * intrinsics.fx + intrinsics.ox
    v = p[1] / z_safe * intrinsics.fy + intrinsics.oy
    idx = quad_index(shape, u, v).idx.reshape(-1, u.shape[-1])
    idx = idx + quad.shape[-1] * torch.arange(idx.shape[0], device=idx.device)[:, None]
    return int(torch.unique(idx).numel()) * 28 * quad.element_size()


def _bound(moved_bytes, flops=0.0):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over the
    card's memory rate and the operations over its peak rate."""
    by_bytes = 1e3 * moved_bytes / HBM_BYTES_PER_S
    by_ops = 1e3 * flops / PEAK_FLOPS
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def check_kernels(cfg, intrinsics, ref_levels, cur_levels):
    """Phase 3b: the sampled-input kernels vs their plain twins at every
    solved level, first_iter 0 and 1.  Returns {kernel name: (rows, worst errors)}: the
    worst absolute error, the worst error scaled by sqrt(G_aa G_bb)
    (``compare_gram``), the worst relative error against the float64 Gram
    (``compare_exact_gram``) and, for the partials, the most rw entries
    that were not bit-equal to the twin's."""
    import torch

    from dvo_slam_tpu_torch.ops import fused_kernels
    from dvo_slam_tpu_torch.tools import fused_check

    out = {"fused_stats": ([], {}), "fused_partials": ([], {})}

    def worst(name, **errors):
        table = out[name][1]
        for key, value in errors.items():
            table[key] = max(table.get(key, 0), value)

    for level, (sampled, refpack, k) in fused_check.level_inputs(
        cfg, intrinsics, ref_levels, cur_levels
    ).items():
        device = sampled.device
        p3 = torch.tensor(fused_check.CHECK_PRECISION, dtype=torch.float32, device=device)
        for first in (0, 1):
            flag = torch.tensor(first, dtype=torch.int32, device=device)
            args = (sampled, refpack, p3, flag, k, cfg.influence_function_param)
            exact = fused_check.exact_gram(*args)
            base = {"level": level, "pixels": sampled.shape[1], "first_iter": first}

            kernel = fused_kernels.fused_stats_cuda(*args)
            again = fused_kernels.fused_stats_cuda(*args)
            twin = fused_kernels.fused_stats_plain(*args)
            torch.cuda.synchronize(device)
            fused_check.assert_bit_identical(kernel, again)
            abs_err, scaled_err = fused_check.compare_fused_stats(kernel, twin)
            exact_err = fused_check.compare_exact_gram(kernel, exact)
            worst("fused_stats", max_abs_err=abs_err, max_scaled_err=scaled_err,
                  max_rel_err_f64=exact_err)
            row = dict(base, kernel="fused_stats", num_valid=int(float(kernel.num_valid)),
                       max_abs_err=abs_err, max_scaled_err=scaled_err, max_rel_err_f64=exact_err)
            if first == 0:
                _timed(row, lambda: fused_kernels.fused_stats_cuda(*args),
                       lambda: fused_kernels.fused_stats_plain(*args))
                n = sampled.shape[1]
                row["bound_ms"], row["bound_by"] = _bound(
                    _bytes(sampled, p3, flag) + _rows_bytes(refpack, 7) + 4 * (256 + 1),
                    n * (SAMPLED_CHAIN_FLOPS + GRAM_FLOPS))
            out["fused_stats"][0].append(row)
            print("phase 3:", json.dumps(row), flush=True)

            gram, rw = fused_kernels.fused_partials_rows_cuda(*args)
            gram2, rw2 = fused_kernels.fused_partials_rows_cuda(*args)
            kernel = fused_kernels.partials_from_rows(gram, rw)
            twin = fused_kernels.fused_partials_plain(*args)
            twin_rw = fused_check.twin_rows(*args)
            torch.cuda.synchronize(device)
            fused_check.assert_bit_identical((gram, rw), (gram2, rw2))
            abs_err, scaled_err, not_bit_equal = fused_check.compare_fused_partials(
                kernel, rw, twin, twin_rw
            )
            exact_err = fused_check.compare_exact_gram(kernel, exact)
            worst("fused_partials", max_abs_err=abs_err, max_scaled_err=scaled_err,
                  max_rel_err_f64=exact_err, rw_not_bit_equal=not_bit_equal)
            row = dict(base, kernel="fused_partials", num_valid=int(float(kernel.num_valid)),
                       max_abs_err=abs_err, max_scaled_err=scaled_err,
                       max_rel_err_f64=exact_err, rw_not_bit_equal=not_bit_equal)
            if first == 0:
                _timed(row, lambda: fused_kernels.fused_partials_cuda(*args),
                       lambda: fused_kernels.fused_partials_plain(*args))
                n = sampled.shape[1]
                row["bound_ms"], row["bound_by"] = _bound(
                    _bytes(sampled, p3, flag, rw) + _rows_bytes(refpack, 7) + 4 * 256,
                    n * (SAMPLED_CHAIN_FLOPS + GRAM_FLOPS))
            out["fused_partials"][0].append(row)
            print("phase 3:", json.dumps(row), flush=True)
    return out


def _stream(stats, b):
    """Stream b of a batched named tuple of tensors."""
    return type(stats)(*(f[b] for f in stats))


def _bits_differ(a, b):
    """Entries whose bits differ between two tuples of equal-shape tensors."""
    import torch

    return sum(int((x.reshape(-1).view(torch.int32) != y.reshape(-1).view(torch.int32)).sum())
               for x, y in zip(a, b))


def check_folded(cfg, intrinsics, frames):
    """Phase 3a: the folded kernel against its plain version at every solved
    level, first 0 and 1, depth-buffered on and off (pair 0 of ``frames``),
    then B = STREAMS pairs in one call against one-stream calls (pairs b,
    b + 1).  Returns (one-stream rows, their worst errors, batched rows,
    their worst errors)."""
    import torch

    from dvo_slam_tpu_torch.ops import fused_kernels
    from dvo_slam_tpu_torch.ops.residuals import warp_and_sample_cm
    from dvo_slam_tpu_torch.tools import fused_check
    from dvo_slam_tpu_torch.tools.fused_check import require

    dof = cfg.influence_function_param
    per_pair = [fused_check.warp_level_inputs(cfg, intrinsics, frames[b], frames[b + 1])
                for b in range(STREAMS)]
    rows, worst, batched_rows, batched_worst = [], {}, [], {}

    def note(table, **errors):
        for key, value in errors.items():
            table[key] = max(table.get(key, 0), value)

    def held(kernel, stats, stash, plain, args, exact_args):
        """The checks shared by one stream and B streams -> the row's errors."""
        r_err, not_bit_equal = fused_check.compare_stash(stash, fused_check.twin_stash(*args))
        exact_err = max(
            fused_check.compare_exact_gram(
                _stream(stats, b) if stats.m00.dim() == 3 else stats,
                fused_check.warp_exact_gram(*one_args))
            for b, one_args in enumerate(exact_args))
        scaled = fused_check.compare_warp_fused_stats(kernel, plain)
        abs_err = max(float((x.double() - y.double()).abs().max()) for x, y in zip(kernel, plain))
        return {"n": kernel.n.reshape(-1).tolist(), "stash_not_bit_equal": not_bit_equal,
                "stash_max_abs_err": r_err, "max_rel_err_f64": exact_err,
                "max_abs_err": max(abs_err, r_err),
                **{"max_scaled_err_" + k: v for k, v in scaled.items()}}

    for level in range(cfg.first_level, cfg.last_level - 1, -1):
        inputs = per_pair[0][level]
        device = inputs.refpack.device
        P = torch.tensor(CHECK_P_PREV, dtype=torch.float32, device=device)
        for first in (0, 1):
            for buffered in (True, False):
                args = (*inputs, P, bool(first), dof, buffered)
                kernel, stats, stash = fused_kernels.warp_fused_stats_rows_cuda(*args)
                again = fused_kernels.warp_fused_stats_rows_cuda(*args)
                plain = fused_kernels.warp_fused_stats_plain(*args)
                torch.cuda.synchronize(device)
                fused_check.assert_bit_identical((*kernel, *stats, stash),
                                                 (*again[0], *again[1], again[2]))
                errors = held(kernel, stats, stash, plain, args, [args])
                note(worst, **{k: v for k, v in errors.items() if k != "n"})
                row = {"level": level, "pixels": inputs.refpack.shape[1], "first": first,
                       "depth_buffered": buffered, "kernel": "warp_fused_stats", **errors}
                if first == 0 and buffered:
                    p3 = torch.tensor(fused_check.CHECK_PRECISION, dtype=torch.float32, device=device)
                    flag = torch.zeros((), dtype=torch.int32, device=device)

                    def unfolded():
                        sampled = warp_and_sample_cm(inputs.refpack, inputs.quad, inputs.shape,
                                                     inputs.intrinsics, inputs.T)
                        return fused_kernels.fused_stats_cuda(sampled, inputs.refpack, p3, flag,
                                                              inputs.intrinsics, dof)

                    def folded():
                        return fused_kernels.warp_fused_stats_cuda(*args)

                    def folded_plain():
                        return fused_kernels.warp_fused_stats_plain(*args)

                    _timed(row, folded, folded_plain)
                    row["unfolded_pair_ms"] = median_ms(unfolded)
                    row["device_ms"] = device_ms(folded)
                    row["plain_device_ms"] = device_ms(folded_plain)
                    row["unfolded_pair_device_ms"] = device_ms(unfolded)
                    row["bound_ms"], row["bound_by"] = _bound(
                        _rows_bytes(inputs.refpack, 7) + _quad_bytes(*inputs) + _bytes(inputs.T, P, *kernel),
                        inputs.refpack.shape[1] * (CHAIN_FLOPS + GRAM_FLOPS))
                rows.append(row)
                print("phase 3:", json.dumps(row), flush=True)

        # B pairs in one call, depth-buffered (the benchmark's sampling)
        Ps = torch.stack([P * (1.0 + 0.1 * b) for b in range(STREAMS)])
        stack = lambda field: torch.stack(  # noqa: E731
            [getattr(pp[level], field) for pp in per_pair]).contiguous()  # noqa: B023
        for first in (0, 1):
            bargs = (stack("refpack"), stack("quad"), inputs.shape, inputs.intrinsics, stack("T"),
                     Ps, bool(first), dof, True)
            one_args = [(*per_pair[b][level], Ps[b], bool(first), dof, True) for b in range(STREAMS)]
            kernel, stats, stash = fused_kernels.warp_fused_stats_rows_cuda(*bargs)
            again = fused_kernels.warp_fused_stats_rows_cuda(*bargs)
            plain = fused_kernels.warp_fused_stats_plain(*bargs)
            torch.cuda.synchronize(device)
            fused_check.assert_bit_identical((*kernel, *stats, stash),
                                             (*again[0], *again[1], again[2]))
            not_bit_equal = 0
            for b in range(STREAMS):
                one, one_stats, one_stash = fused_kernels.warp_fused_stats_rows_cuda(*one_args[b])
                not_bit_equal += _bits_differ(
                    (*_stream(kernel, b), *_stream(stats, b), stash[b]), (*one, *one_stats, one_stash))
            require(not_bit_equal == 0,
                    f"batched folded kernel: {not_bit_equal} outputs differ from one-stream calls "
                    f"(level {level}, first {first})")
            errors = held(kernel, stats, stash, plain, bargs, one_args)
            note(batched_worst, not_bit_equal_to_single=not_bit_equal,
                 **{k: v for k, v in errors.items() if k != "n"})
            row = {"level": level, "streams": STREAMS, "pixels": inputs.refpack.shape[1],
                   "first": first, "kernel": "warp_fused_stats_batched",
                   "not_bit_equal_to_single": not_bit_equal, **errors}
            if level == cfg.last_level and first == 0:
                def batched():
                    return fused_kernels.warp_fused_stats_batched_cuda(*bargs)  # noqa: B023

                def batched_plain():
                    return fused_kernels.warp_fused_stats_plain(*bargs)  # noqa: B023

                _timed(row, batched, batched_plain)
                row["single_kernel_x_streams_ms"] = median_ms(lambda: [
                    fused_kernels.warp_fused_stats_cuda(*a) for a in one_args])  # noqa: B023
                row["device_ms"] = device_ms(batched)
                row["plain_device_ms"] = device_ms(batched_plain)
                row["bound_ms"], row["bound_by"] = _bound(
                    _rows_bytes(bargs[0], 7) + _quad_bytes(*bargs[:5]) + _bytes(bargs[4], Ps, *kernel),
                    STREAMS * inputs.refpack.shape[1] * (CHAIN_FLOPS + GRAM_FLOPS))
            batched_rows.append(row)
            print("phase 3:", json.dumps(row), flush=True)
    return rows, worst, batched_rows, batched_worst


def _pose_errors(a, b):
    """max |log(a^-1 b)| per pose, for [..., 4, 4] poses (float64 on the host)."""
    import torch

    from dvo_slam_tpu_torch.ops import se3

    a = np.asarray(a, np.float64).reshape(-1, 4, 4)
    b = np.asarray(b, np.float64).reshape(-1, 4, 4)
    rel = torch.from_numpy(np.linalg.inv(a) @ b)
    return se3.log_se3(rel).abs().amax(dim=-1).numpy()


def _pose_error(T_gt, T):
    """max |log(T_gt^-1 T)| of one pose ``T`` (a tensor)."""
    return float(_pose_errors(T_gt, T.detach().cpu().numpy()).max())


def _synchronized_seconds(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def check_sharded(cfg, intrinsics, frames, poses):
    """Phase 6: the pixel-sharded and pair-parallel matchers on a one-rank
    NCCL process group.  Returns the sharded run's partials launches and
    the phase's summary."""
    import dataclasses
    import tempfile

    import torch

    from dvo_slam_tpu_torch.models.dense_tracker import match_pyramids
    from dvo_slam_tpu_torch.ops import fused_kernels
    from dvo_slam_tpu_torch.ops.pyramid import PyramidLevel
    from dvo_slam_tpu_torch.parallel import distributed, mesh as mesh_lib, sharded_alignment
    from dvo_slam_tpu_torch.tools.fused_check import require

    device = frames[0][cfg.first_level].intensity.device
    eye = torch.eye(4, dtype=torch.float32, device=device)
    pairs = [(frames[k], frames[k + 1]) for k in range(SHARDED_PAIRS)]
    with tempfile.TemporaryDirectory() as store:
        distributed.initialize(init_method=f"file://{store}/rendezvous", world_size=1,
                               rank=0, backend="nccl")
        try:
            mesh = mesh_lib.make_mesh(1)
            run = sharded_alignment.make_pixel_sharded_matcher(cfg, intrinsics, mesh)
            run(*pairs[0], eye)  # warm-up (the communicator), not counted

            # the sharded path, with every kernel count at 0
            _reset_counts()
            results, sharded_s = _synchronized_seconds(lambda: [run(r, c, eye) for r, c in pairs])
            partials_launches = fused_kernels.fused_partials_cuda.launches
            stats_launches = _launches()
            for name in ("fused_partials", "table_copy", "warp_and_sample_cm_calls"):
                del stats_launches[name]
            iterations = sum(s.iterations for r in results for s in r.level_stats)
            require(partials_launches == iterations > 0,
                    f"partials launches {partials_launches} != solver iterations {iterations}")
            require(not any(stats_launches.values()),
                    f"statistics kernels launched on the sharded path: {stats_launches}")
            errors = [
                _pose_error(np.linalg.inv(poses[k]) @ poses[k + 1], r.transformation)
                for k, r in enumerate(results)
            ]
            require(max(errors) < POSE_GATE, f"sharded pose errors {errors} (gate {POSE_GATE})")

            # match_pyramids on the same pairs, for the time per iteration
            singles, single_s = _synchronized_seconds(
                lambda: [match_pyramids(cfg, intrinsics, r, c, eye) for r, c in pairs]
            )
            single_iterations = sum(s.iterations for r in singles for s in r.level_stats)

            # mu = 0: the sharded and single paths coincide by construction
            cfg0 = dataclasses.replace(cfg, mu=0.0)
            sharded0 = sharded_alignment.make_pixel_sharded_matcher(cfg0, intrinsics, mesh)(
                *pairs[0], eye)
            single0 = match_pyramids(cfg0, intrinsics, *pairs[0], eye)
            counts = lambda r: [(s.iterations, int(s.termination)) for s in r.level_stats]  # noqa: E731
            require(counts(sharded0) == counts(single0),
                    f"mu=0 levels: sharded {counts(sharded0)} vs single {counts(single0)}")
            mu0_err = _pose_error(single0.transformation.cpu().numpy(), sharded0.transformation)
            require(mu0_err < MU0_POSE_GATE, f"mu=0 sharded vs single: {mu0_err}")
            torch.testing.assert_close(sharded0.information, single0.information,
                                       rtol=2e-3, atol=1e-3)

            # the pair-parallel wave against match_pyramids pair by pair
            def stack(levels_list):
                return tuple(
                    None if levels_list[0][lv] is None else PyramidLevel(*(
                        torch.stack([levels[lv][f] for levels in levels_list]) for f in range(8)
                    ))
                    for lv in range(len(levels_list[0]))
                )

            wave = sharded_alignment.make_pair_parallel_matcher(cfg, intrinsics, mesh)(
                stack(frames[:WAVE_PAIRS]), stack(frames[1:WAVE_PAIRS + 1]),
                eye.expand(WAVE_PAIRS, 4, 4).contiguous(),
            )
            for b in range(WAVE_PAIRS):
                one = singles[b]
                require(torch.equal(wave.transformation[b], one.transformation)
                        and torch.equal(wave.information[b], one.information)
                        and torch.equal(wave.neg_log_likelihood[b], one.neg_log_likelihood),
                        f"pair-parallel pair {b} differs from match_pyramids")
                for s_wave, s_one in zip(wave.level_stats, one.level_stats):
                    require([int(s_wave.valid_pixels[b]), int(s_wave.valid_constraints[b]),
                             int(s_wave.iterations[b]), int(s_wave.termination[b])]
                            == [int(s_one.valid_pixels), int(s_one.valid_constraints),
                                s_one.iterations, int(s_one.termination)],
                            f"pair-parallel pair {b} level stats differ")
        finally:
            distributed.shutdown()
    summary = {
        "pairs": SHARDED_PAIRS, "max_pose_err": max(errors),
        "solver_iterations": iterations, "partials_launches": partials_launches,
        "fused_stats_launches": stats_launches,
        "sharded_ms_per_iteration": 1000.0 * sharded_s / iterations,
        "sharded_pairs_per_s": SHARDED_PAIRS / sharded_s,
        "single_ms_per_iteration": 1000.0 * single_s / single_iterations,
        "single_pairs_per_s": SHARDED_PAIRS / single_s,
        "single_iterations": single_iterations,
        "mu0_levels": counts(sharded0), "mu0_pose_err": mu0_err,
        "wave_pairs_bit_equal": WAVE_PAIRS,
    }
    print("phase 6:", json.dumps(summary), flush=True)
    return partials_launches, summary


def _per(numerator, ms):
    """numerator / ms, or None where the time was not measured."""
    return None if ms is None else numerator / ms


def _device_busy(fn):
    """(device busy share, wall seconds) of one call of ``fn`` under
    ``torch.profiler``, after one untimed call; the share is None (not
    measured) where the profiler recorded no device event."""
    from dvo_slam_tpu_torch.tools.gather_probe import device_time

    busy_ms, wall_ms = device_time(fn, calls=1)
    return _per(busy_ms, wall_ms), wall_ms / 1000.0


def check_batched_kernel(cfg, intrinsics, pairs):
    """Phase 7a: the batched sampled-input kernel on B streams' packs (each
    stream's first pair, at every solved level) against the single-stream
    kernel on each stream's packs (bit-equal) and against the plain twin
    (as phase 3 holds it).  Returns (rows, worst errors)."""
    import torch

    from dvo_slam_tpu_torch.ops import fused_kernels
    from dvo_slam_tpu_torch.tools import fused_check
    from dvo_slam_tpu_torch.tools.fused_check import require

    per_stream = [fused_check.level_inputs(cfg, intrinsics, r, c) for r, c in pairs]
    batch = len(pairs)
    dof = cfg.influence_function_param
    rows, worst = [], {}
    for level in range(cfg.first_level, cfg.last_level - 1, -1):
        k = per_stream[0][level][2]
        sampled = torch.stack([s[level][0] for s in per_stream]).contiguous()
        refpack = torch.stack([s[level][1] for s in per_stream]).contiguous()
        device = sampled.device
        scale = 1.0 + 0.1 * torch.arange(batch, dtype=torch.float32, device=device)
        p3 = torch.tensor(fused_check.CHECK_PRECISION, dtype=torch.float32, device=device) * scale[:, None]
        for first in ("0", "1", "per-stream"):
            if first == "per-stream":
                flags = (torch.arange(batch, device=device) % 2).to(torch.int32)
            else:
                flags = torch.tensor(int(first), dtype=torch.int32, device=device)
            args = (sampled, refpack, p3, flags, k, dof)
            kernel = fused_kernels.fused_stats_batched_cuda(*args)
            again = fused_kernels.fused_stats_batched_cuda(*args)
            twin = fused_kernels.fused_stats_plain(*args)
            torch.cuda.synchronize(device)
            fused_check.assert_bit_identical(kernel, again)
            not_bit_equal, abs_err, scaled_err, exact_err = 0, 0.0, 0.0, 0.0
            for b in range(batch):
                flag = flags[b] if flags.dim() else flags
                single_args = (sampled[b], refpack[b], p3[b], flag, k, dof)
                single = fused_kernels.fused_stats_cuda(*single_args)
                mine = _stream(kernel, b)
                not_bit_equal += _bits_differ(mine, single)
                a, s = fused_check.compare_fused_stats(mine, _stream(twin, b))
                e = fused_check.compare_exact_gram(mine, fused_check.exact_gram(*single_args))
                abs_err, scaled_err, exact_err = max(abs_err, a), max(scaled_err, s), max(exact_err, e)
            require(not_bit_equal == 0,
                    f"batched kernel: {not_bit_equal} outputs differ from the single-stream kernel "
                    f"(level {level}, first_iter {first})")
            for key, value in (("max_abs_err", abs_err), ("max_scaled_err", scaled_err),
                               ("max_rel_err_f64", exact_err), ("not_bit_equal_to_single", 0)):
                worst[key] = max(worst.get(key, 0), value)
            row = {"level": level, "streams": batch, "pixels": sampled.shape[2], "first_iter": first,
                   "kernel": "fused_stats_batched", "not_bit_equal_to_single": not_bit_equal,
                   "max_abs_err": abs_err, "max_scaled_err": scaled_err, "max_rel_err_f64": exact_err}
            if first == "0":
                _timed(row, lambda: fused_kernels.fused_stats_batched_cuda(*args),
                       lambda: fused_kernels.fused_stats_plain(*args))
                row["bound_ms"], row["bound_by"] = _bound(
                    _bytes(sampled, p3, flags) + _rows_bytes(refpack, 7) + batch * 4 * (256 + 1),
                    batch * sampled.shape[2] * (SAMPLED_CHAIN_FLOPS + GRAM_FLOPS))
                row["single_kernel_x_streams_ms"] = median_ms(lambda: [
                    fused_kernels.fused_stats_cuda(sampled[b], refpack[b], p3[b], flags, k, dof)
                    for b in range(batch)
                ])
            rows.append(row)
            print("phase 7:", json.dumps(row), flush=True)
    return rows, worst


def _wrappers():
    """{name: wrapper} of every kernel's launch count."""
    from dvo_slam_tpu_torch.ops import fused_kernels, table_copy

    return {
        "warp_fused_stats": fused_kernels.warp_fused_stats_cuda,
        "warp_fused_stats_batched": fused_kernels.warp_fused_stats_batched_cuda,
        "fused_stats": fused_kernels.fused_stats_cuda,
        "fused_stats_batched": fused_kernels.fused_stats_batched_cuda,
        "fused_partials": fused_kernels.fused_partials_cuda,
        "table_copy": table_copy.table_copy_cuda,
    }


def _reset_counts():
    """Every kernel's launch count, and warp_and_sample_cm's call count, to 0."""
    from dvo_slam_tpu_torch.ops import residuals

    for wrapper in _wrappers().values():
        wrapper.launches = 0
    residuals.warp_and_sample_cm.calls = 0


def _launches():
    """{name: launches} since the last reset, with warp_and_sample_cm's calls."""
    from dvo_slam_tpu_torch.ops import residuals

    counts = {name: wrapper.launches for name, wrapper in _wrappers().items()}
    counts["warp_and_sample_cm_calls"] = residuals.warp_and_sample_cm.calls
    return counts


def _require_only(counts, name, expected, what):
    """The tracker path went through kernel ``name`` ``expected`` times and
    through no other statistics kernel, nor ``warp_and_sample_cm``."""
    from dvo_slam_tpu_torch.tools.fused_check import require

    require(counts[name] == expected > 0,
            f"{what}: {name} launches {counts[name]} != solver iterations {expected}")
    others = {k: v for k, v in counts.items() if k not in (name, "table_copy") and v}
    require(not others, f"{what}: other statistics kernels or warp_and_sample_cm ran: {others}")


def check_lockstep(cfg, intrinsics, d_i, d_d, gt, single_fps):
    """Phase 7b: B streams in lockstep.  Returns the batched folded
    kernel's launches and the phase's summary."""
    from dvo_slam_tpu_torch.parallel.multistream import make_multistream_tracker
    from dvo_slam_tpu_torch.tools.fused_check import require
    from dvo_slam_tpu_torch.tools.multistream_bench import stream_ates

    run = make_multistream_tracker(cfg, intrinsics)
    run.tracks(d_i[:, :3], d_d[:, :3])  # warm-up, not counted

    _reset_counts()
    tracks, seconds = _synchronized_seconds(lambda: run.tracks(d_i, d_d))
    counts = _launches()
    batched = counts["warp_fused_stats_batched"]
    _require_only(counts, "warp_fused_stats_batched", tracks.loop_iterations, "lockstep")
    ates = stream_ates(tracks.poses.cpu().numpy(), gt)
    require(np.isfinite(ates).all() and max(ates) < STREAM_ATE_GATE_M,
            f"stream ATE-RMSE {ates} (gate {STREAM_ATE_GATE_M} m)")
    iterations = tracks.iterations.cpu().numpy()  # [B, T-1, levels]
    busy, busy_wall = _device_busy(lambda: run.tracks(d_i[:, :BUSY_FRAMES], d_d[:, :BUSY_FRAMES]))
    streams, frames = d_i.shape[:2]
    fps = streams * (frames - 1) / seconds
    summary = {
        "streams": streams, "frames": frames, "seconds": seconds,
        "aggregate_frames_per_s": fps, "single_stream_frames_per_s_phase4": single_fps,
        "lockstep_iterations": tracks.loop_iterations, "launches": counts,
        "ms_per_lockstep_iteration": 1000.0 * seconds / tracks.loop_iterations,
        "levels": list(range(cfg.first_level, cfg.last_level - 1, -1)),
        "max_over_streams_iterations_per_level": iterations.max(axis=0).sum(axis=0).tolist(),
        "sum_over_streams_iterations_per_level": iterations.sum(axis=(0, 1)).tolist(),
        "ate_rmse_m": ates, "device_busy_share": busy, "busy_window_frames": BUSY_FRAMES,
        "busy_window_s": busy_wall,
    }
    print("phase 7:", json.dumps(summary), flush=True)
    return batched, summary


def check_schedules(cfg, intrinsics, d_i, d_d):
    """Phase 8: lockstep against sequential, and the tracker on a one-rank
    NCCL mesh against the local run."""
    import tempfile

    import torch

    from dvo_slam_tpu_torch.parallel import distributed, mesh as mesh_lib
    from dvo_slam_tpu_torch.parallel.multistream import make_multistream_tracker
    from dvo_slam_tpu_torch.tools.fused_check import require

    sub_i = d_i[:SCHEDULE_STREAMS, :SCHEDULE_FRAMES]
    sub_d = d_d[:SCHEDULE_STREAMS, :SCHEDULE_FRAMES]
    lock = make_multistream_tracker(cfg, intrinsics).tracks(sub_i, sub_d)
    seq = make_multistream_tracker(cfg, intrinsics, schedule="sequential").tracks(sub_i, sub_d)
    differ = (lock.iterations != seq.iterations) | (lock.termination != seq.termination)
    flips = [tuple(int(i) for i in at) for at in torch.nonzero(differ).tolist()]
    require(len(flips) <= SCHEDULE_FLIP_SHARE * differ.numel(),
            f"lockstep vs sequential: {len(flips)} of {differ.numel()} stream-frame-levels differ")
    errors = _pose_errors(lock.poses.cpu().numpy(), seq.poses.cpu().numpy())
    require(errors.max() < SCHEDULE_POSE_GATE,
            f"lockstep vs sequential pose error {errors.max()} (gate {SCHEDULE_POSE_GATE})")
    with tempfile.TemporaryDirectory() as store:
        distributed.initialize(init_method=f"file://{store}/rendezvous", world_size=1,
                               rank=0, backend="nccl")
        try:
            dp = make_multistream_tracker(cfg, intrinsics, mesh_lib.make_mesh(1)).tracks(sub_i, sub_d)
        finally:
            distributed.shutdown()
    for field in ("poses", "iterations", "termination"):
        require(torch.equal(getattr(dp, field), getattr(lock, field)),
                f"one-rank mesh tracker: {field} differ from the local run")
    summary = {
        "streams": SCHEDULE_STREAMS, "frames": SCHEDULE_FRAMES,
        "stream_frame_levels": differ.numel(), "near_tie_flips": len(flips),
        "flips_at_stream_frame_level": flips, "max_pose_err": float(errors.max()),
        "lockstep_loop_iterations": lock.loop_iterations,
        "sequential_iterations": seq.loop_iterations, "mesh_equal_to_local": True,
    }
    print("phase 8:", json.dumps(summary), flush=True)
    return summary


def check_temporal(cfg, intrinsics, d_i, d_d, est, gt):
    """Phase 9: the phase-4 sequence in chunks against phase 4's trajectory."""
    from dvo_slam_tpu_torch.parallel.temporal import make_temporal_tracker
    from dvo_slam_tpu_torch.tools.fused_check import require
    from dvo_slam_tpu_torch.utils import trajectory

    run = make_temporal_tracker(cfg, intrinsics, num_chunks=TEMPORAL_CHUNKS)
    par, seconds = _synchronized_seconds(lambda: run(d_i, d_d))
    errors = _pose_errors(est[1:], par)
    require(errors.max() < TEMPORAL_POSE_GATE,
            f"temporal vs sequential pose error {errors.max()} (gate {TEMPORAL_POSE_GATE})")
    stamps = np.arange(len(gt)) / 30.0
    ate = trajectory.ate_rmse(stamps, np.concatenate([np.eye(4)[None], par]), stamps, gt)
    summary = {"frames": len(gt), "chunks": TEMPORAL_CHUNKS, "max_pose_err": float(errors.max()),
               "ate_rmse_m": ate, "seconds": seconds}
    print("phase 9:", json.dumps(summary), flush=True)
    return summary


def check_copy_and_probe():
    """Phase 10: the copy kernel against ``clone()``, then the gather probe
    (whose ``pcopy`` variant is the copy kernel's main path).  Returns the
    kernel's row."""
    import torch

    from dvo_slam_tpu_torch.ops import table_copy
    from dvo_slam_tpu_torch.tools import gather_probe
    from dvo_slam_tpu_torch.tools.fused_check import require

    gen = torch.Generator(device="cuda").manual_seed(0)
    tables = {name: torch.randn(shape, device="cuda", generator=gen)
              for name, shape in COPY_SHAPES.items()}
    c, n = COPY_SHAPES["l1_table"]
    # a contiguous table 4 bytes past a 16-byte boundary: the scalar loop
    tables["unaligned"] = torch.randn(c * n + 1, device="cuda", generator=gen)[1:].view(c, n)
    worst = 0.0
    for name, x in tables.items():
        out = table_copy.table_copy_cuda(x)
        want = table_copy.table_copy_plain(x)
        torch.cuda.synchronize()
        require(out.data_ptr() != x.data_ptr() and out.shape == x.shape, f"copy of {name}")
        require(torch.equal(out.view(torch.int32), want.view(torch.int32)),
                f"copy kernel: {name} not bit-equal to clone()")
        worst = max(worst, float((out - want).abs().max()))
    full = tables["l1_table"]
    del tables
    moved = 2 * _bytes(full)
    row = {"name": "table_copy", "route": "cuda", "source": COPY_SOURCE, "replaces": COPY_REPLACES,
           "max_abs_err": worst}

    def kernel():
        return table_copy.table_copy_cuda(full)

    def plain():
        return table_copy.table_copy_plain(full)

    # cold: the main path copies out of a stack larger than the L2 cache
    flush = torch.empty(COLD_FLUSH_BYTES // 4, device="cuda")
    _timed(row, kernel, plain, timer=lambda fn: cold_ms(fn, flush))
    del flush
    _timed(row, kernel, plain, timer=device_ms, prefix="warm_")
    _timed(row, kernel, plain, prefix="wrapper_")
    row["bound_ms"], row["bound_by"] = _bound(moved)
    row["library_ms"] = row["plain_ms"]  # clone(): one PyTorch call, the same function
    profiled_ms, _ = gather_probe.device_time(kernel)
    profiled_plain_ms, _ = gather_probe.device_time(plain)
    print("phase 10:", json.dumps({
        "copy_checked": {k: list(v) for k, v in COPY_SHAPES.items()}, "unaligned": [c, n],
        "bit_equal": True, "cold_ms": row["ms"], "cold_plain_ms": row["plain_ms"],
        "warm_ms": row["warm_ms"], "warm_plain_ms": row["warm_plain_ms"],
        "wrapper_ms": row["wrapper_ms"], "wrapper_plain_ms": row["wrapper_plain_ms"],
        "bound_ms": row["bound_ms"],
        "cold_gb_per_s": moved / row["ms"] / 1e6, "cold_plain_gb_per_s": moved / row["plain_ms"] / 1e6,
        "warm_gb_per_s": moved / row["warm_ms"] / 1e6,
        "warm_plain_gb_per_s": moved / row["warm_plain_ms"] / 1e6,
        "profiler_device_ms": profiled_ms, "profiler_plain_device_ms": profiled_plain_ms,
    }), flush=True)

    _reset_counts()
    rows = gather_probe.probe(STREAMS, SHAPE[0] // 2, SHAPE[1] // 2)
    row["launches"] = table_copy.table_copy_cuda.launches
    require(row["launches"] == 2 * STREAMS,
            f"copy kernel launched {row['launches']} times in the probe, not {2 * STREAMS}")
    for r in rows:
        print("phase 10:", json.dumps(r), flush=True)
    return row


def main() -> int:
    import torch

    # phase 1: device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one card",
              file=sys.stderr)
        return 2
    from dvo_slam_tpu_torch import _build, benchmark_config
    from dvo_slam_tpu_torch.odometry import (
        build_frame,
        render_sequence,
        track_sequence,
        upload_sequence,
    )
    from dvo_slam_tpu_torch.ops.camera import TUM_FR1
    from dvo_slam_tpu_torch.parallel.multistream import as_frames
    from dvo_slam_tpu_torch.tools.fused_check import require
    from dvo_slam_tpu_torch.tools.multistream_bench import render_streams
    from dvo_slam_tpu_torch.utils import synthetic, trajectory

    # the twin is the kernel's oracle: its Gram product in IEEE float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"phase 1: device {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    print(f"phase 1: nvidia-smi name, power.limit: {smi}", flush=True)

    # phase 2: build (both sources at once, one nvcc each)
    t0 = time.perf_counter()
    libraries = _build.load_libraries(["fused_stats", "table_copy"])
    for name, entries in (
        ("fused_stats", ("dvo_warp_fused_stats", "dvo_fused_stats", "dvo_fused_stats_batched",
                         "dvo_fused_partials")),
        ("table_copy", ("dvo_table_copy",)),
    ):
        for entry in entries:
            require(hasattr(libraries[name].lib, entry), f"the {name} library lacks {entry}")
    print(f"phase 2: built both libraries in {time.perf_counter() - t0:.2f} s", flush=True)
    for library in libraries.values():
        print(f"phase 2: {library.path}: nvcc {library.build_seconds:.2f} s", flush=True)
        for line in library.compiler_log.strip().splitlines():
            print("phase 2: nvcc:", line)

    cfg = benchmark_config().tracker

    # phase 3: kernels vs plain versions on a rendered 640x480 sequence
    easy_poses = synthetic.circular_trajectory(NUM_FRAMES, radius=0.05, rot_amplitude=0.02)
    t0 = time.perf_counter()
    easy_i, easy_d = render_sequence(easy_poses, SHAPE, TUM_FR1, seed0=0)
    print(f"phase 3: rendered {NUM_FRAMES} frames in {time.perf_counter() - t0:.1f} s",
          flush=True)
    d_i, d_d = upload_sequence(easy_i, easy_d, device)
    frames = [build_frame(cfg, d_i[k], d_d[k]) for k in range(STREAMS + 1)]
    folded = check_folded(cfg, TUM_FR1, frames)
    checks = check_kernels(cfg, TUM_FR1, frames[0], frames[1])

    # phase 4: 100-frame odometry through the folded kernel
    track_sequence(cfg, TUM_FR1, d_i[:3], d_d[:3])  # warm-up, not counted
    _reset_counts()
    est, iterations, seconds = track_sequence(cfg, TUM_FR1, d_i, d_d)
    counts = _launches()
    launches = counts["warp_fused_stats"]
    _require_only(counts, "warp_fused_stats", iterations, "phase 4")
    stamps = np.arange(NUM_FRAMES) / 30.0
    ate = trajectory.ate_rmse(stamps, est, stamps, easy_poses)
    fps = (NUM_FRAMES - 1) / seconds
    require(np.isfinite(est).all() and np.isfinite(ate), "non-finite odometry")
    print("phase 4:", json.dumps({
        "frames": NUM_FRAMES, "ate_rmse_m": ate, "tracked_frames_per_s": fps,
        "seconds": seconds, "solver_iterations": iterations, "launches": counts,
        "ms_per_iteration": 1000.0 * seconds / iterations,
    }), flush=True)

    # phase 5: the hard (occluded) scene, accuracy gate
    hard_poses = synthetic.circular_trajectory(
        NUM_FRAMES, radius=0.15, rot_amplitude=0.12, z_amplitude=0.05
    )
    hard_i, hard_d = render_sequence(
        hard_poses, SHAPE, TUM_FR1, scene=synthetic.occluded_scene(), seed0=1000
    )
    h_i, h_d = upload_sequence(hard_i, hard_d, device)
    _reset_counts()
    hard_est, hard_iterations, hard_seconds = track_sequence(cfg, TUM_FR1, h_i, h_d)
    hard_counts = _launches()
    hard_launches = hard_counts["warp_fused_stats"]
    _require_only(hard_counts, "warp_fused_stats", hard_iterations, "phase 5")
    hard_ate = trajectory.ate_rmse(stamps, hard_est, stamps, hard_poses)
    print("phase 5:", json.dumps({
        "frames": NUM_FRAMES, "ate_rmse_m": hard_ate,
        "tracked_frames_per_s": (NUM_FRAMES - 1) / hard_seconds,
        "seconds": hard_seconds, "solver_iterations": hard_iterations,
        "launches": hard_counts,
    }), flush=True)
    require(hard_ate < HARD_ATE_GATE_M, f"hard-scene ATE {hard_ate} m >= {HARD_ATE_GATE_M} m")

    # phase 6: the sharded paths on a one-rank process group
    frames += [build_frame(cfg, d_i[k], d_d[k]) for k in range(len(frames), SHARDED_PAIRS + 1)]
    partials_launches, _ = check_sharded(cfg, TUM_FR1, frames, easy_poses)

    # phase 7: B streams in lockstep, the batched kernel first
    intensity, depth, stream_gt = render_streams(STREAMS, STREAM_FRAMES, SHAPE, TUM_FR1)
    s_i, s_d = as_frames(intensity, depth, device)
    first_pairs = [
        (build_frame(cfg, s_i[b, 0], s_d[b, 0]), build_frame(cfg, s_i[b, 1], s_d[b, 1]))
        for b in range(STREAMS)
    ]
    batched_rows, batched_worst = check_batched_kernel(cfg, TUM_FR1, first_pairs)
    batched_launches, _ = check_lockstep(cfg, TUM_FR1, s_i, s_d, stream_gt, fps)

    # phase 8: schedules; phase 9: temporal chunks of phase 4's sequence
    check_schedules(cfg, TUM_FR1, s_i, s_d)
    check_temporal(cfg, TUM_FR1, d_i, d_d, est, easy_poses)

    # phase 10: the copy kernel and the gather probe
    copy_row = check_copy_and_probe()

    kernels = []
    folded_rows, folded_worst, folded_batched_rows, folded_batched_worst = folded
    l1 = next(r for r in folded_rows
              if r["level"] == cfg.last_level and r["first"] == 0 and r["depth_buffered"])
    l1_batched = next(r for r in folded_batched_rows
                      if r["level"] == cfg.last_level and r["first"] == 0)
    sampled_rows, sampled_worst = checks["fused_stats"]
    sampled_l1 = next(r for r in sampled_rows if r["level"] == cfg.last_level and r["first_iter"] == 0)
    batched_l1 = next(r for r in batched_rows
                      if r["level"] == cfg.last_level and r["first_iter"] == "0")
    timing_keys = ("ms", "plain_ms", "bound_ms", "bound_by")
    # kernels #1 and #1b: the two launches of csrc/fused_stats.cu, whose main
    # path enters them through the folded entry point; the sampled-input
    # entry point (the same launches, another prologue) is checked in phases
    # 3 and 7 and runs on no tracker path
    for name, replaces, main_launches, row, worst, sampled_entry, sampled_row, sampled_errors in (
        ("fused_stats", STATS_REPLACES, launches + hard_launches, l1, folded_worst,
         "dvo_fused_stats", sampled_l1, sampled_worst),
        ("fused_stats_batched", BATCHED_REPLACES, batched_launches, l1_batched,
         folded_batched_worst, "dvo_fused_stats_batched", batched_l1, batched_worst),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE, "replaces": replaces,
            "entry": "dvo_warp_fused_stats", "launches": main_launches,
            "max_abs_err": worst["max_abs_err"], **{k: row[k] for k in timing_keys},
            "library_ms": None, **{k: v for k, v in worst.items() if k != "max_abs_err"},
            **{k: row[k] for k in row if k.endswith("device_ms") or k.endswith("x_streams_ms")
               or k == "unfolded_pair_ms"},
            "sampled_entry": {"entry": sampled_entry, "main_path_launches": 0,
                              **{k: sampled_row[k] for k in timing_keys}, **sampled_errors},
        })
    rows, worst = checks["fused_partials"]
    l1 = next(r for r in rows if r["level"] == cfg.last_level and r["first_iter"] == 0)
    kernels.append({
        "name": "fused_partials", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": PARTIALS_REPLACES, "launches": partials_launches, **worst,
        **{k: l1[k] for k in timing_keys}, "library_ms": None,
    })
    kernels.append(copy_row)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
