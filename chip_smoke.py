#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dvo_slam_tpu_torch``) on one card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Device: a CUDA card is required (there is no CPU fallback).  Prints
   its name and ``nvidia-smi``'s name and power limit.
2. Build: ``nvcc`` builds ``dvo_slam_tpu_torch/csrc/fused_stats.cu`` (the
   fused-stats, batched fused-stats and partials entry points) and
   ``csrc/table_copy.cu`` from the checkout, both at once; prints the build
   seconds and the compiler's report.
3. Kernels vs plain twins on the card: the real ``sampled``/``refpack``
   of a rendered 640x480 pair at levels 3, 2 and 1, with ``first_iter`` 0
   and 1.  For both kernels: ``num_valid`` equal; the Gram blocks
   (M00/M01/M11/v/scale_sum) element-wise within rtol 1e-6 of the float64
   Gram of the same float32 rows, and each entry G_ab within 1e-4 of
   sqrt(G_aa G_bb) of the float32 twin's; two kernel runs bit-identical;
   times of kernel and twin at ``first_iter`` 0 (CUDA events, median of 30
   runs after 5 warm-up runs).  ``fused_stats``: ``log_sum`` within rtol
   1e-5.  ``fused_partials``: the mask row equal, r_I and r_Z within atol
   1e-6, w within rtol 1e-5 of the twin's rows, and the count of rw
   entries that are not bit-equal (0 expected).
4. Odometry: 100 frames at 640x480 (``TUM_FR1``), frame to frame with a
   constant-velocity warm start at ``benchmark_config().tracker``, from
   u8/u16 frames through ``convert_raw_depth`` -> ``build_pyramid`` ->
   ``match_pyramids``.  The kernel launch count must equal the number of
   solver iterations.  Prints ATE-RMSE and tracked frames/s.
5. Hard scene: the occluded scene under a 30 cm loop; ATE-RMSE < 10 mm.
6. Sharded paths: a one-rank NCCL process group (``file://`` rendezvous
   in a temporary directory) and its mesh.  The pixel-sharded matcher on
   the first 20 easy pairs from the identity: each pair within 5e-3 of
   the ground truth (max |log(T_gt^-1 T)|), the partials kernel launched
   once per solver iteration and the fused-stats kernel not at all.  With
   mu = 0, where the sharded and single paths coincide, one pair against
   ``match_pyramids``: per-level iterations and terminations equal,
   estimate within 1e-4, information within rtol 2e-3 / atol 1e-3.  The
   pair-parallel matcher on 8 pairs, bit-equal to ``match_pyramids`` pair
   by pair.  Prints ms per iteration and pairs/s of the sharded path and
   of ``match_pyramids`` on the same 20 pairs.
7. Lockstep multi-stream odometry: 8 streams x 50 frames at 640x480
   (``tools/multistream_bench.render_streams``) through
   ``make_multistream_tracker``.  The batched kernel
   (``dvo_fused_stats_batched``) first, against the single-stream kernel
   on each stream's packs at levels 3, 2, 1 with ``first_iter`` 0, 1 and
   per-stream flags: every output bit-equal per stream; against the plain
   twin per stream as phase 3 holds it; times of kernel and twin at L1.
   Then the run: batched launches equal to the lockstep loop iterations,
   no single-stream launch, every stream's ATE-RMSE < 10 mm.  Prints
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
   ``clone()`` on [32, 76800], on a ragged [7, 1001] and on a table that is
   not 16-byte aligned; kernel and ``clone()`` times with GB/s (CUDA events
   around the call, and device time under ``torch.profiler``, null where
   the profiler records no device event).  Then the
   gather probe (``tools/gather_probe.py``) at L1, B = 8: every variant
   bit-equal to ``batched``, ms and device ms per iteration each; its
   ``pcopy`` tables are the copy kernel's main path.

The last three lines of standard output are one JSON object describing
the kernels, ``nvidia-smi``'s name and power limit, then ``{"ok": true,
"device": {...}}``.
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
COPY_SHAPES = {"l1_table": (32, 76800), "ragged": (7, 1001)}


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


def _timed(row, kernel_fn, plain_fn):
    """Kernel and twin times into ``row``: one card, in turns (twin, kernel,
    kernel, twin), the better of each pair."""
    t_plain = [median_ms(plain_fn)]
    t_kernel = [median_ms(kernel_fn), median_ms(kernel_fn)]
    t_plain.append(median_ms(plain_fn))
    row["ms"] = min(t_kernel)
    row["plain_ms"] = min(t_plain)


def check_kernels(cfg, intrinsics, ref_levels, cur_levels):
    """Phase 3: both kernels vs their plain twins at every solved level,
    first_iter 0 and 1.  Returns {kernel name: (rows, worst errors)}: the
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
            out["fused_partials"][0].append(row)
            print("phase 3:", json.dumps(row), flush=True)
    return out


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
            stats_launches = fused_kernels.fused_stats_cuda.launches
            iterations = sum(s.iterations for r in results for s in r.level_stats)
            require(partials_launches == iterations > 0,
                    f"partials launches {partials_launches} != solver iterations {iterations}")
            require(stats_launches == 0, f"fused_stats launched {stats_launches} times")
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

    device_ms, wall_ms = device_time(fn, calls=1)
    return _per(device_ms, wall_ms), wall_ms / 1000.0


def _stream(stats, b):
    """Stream b of a batched ``FusedStats``."""
    return type(stats)(*(f[b] for f in stats))


def check_batched_kernel(cfg, intrinsics, pairs):
    """Phase 7a: the batched fused-stats kernel on B streams' packs (each
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
                not_bit_equal += sum(
                    int((x.reshape(-1).view(torch.int32) != y.reshape(-1).view(torch.int32)).sum())
                    for x, y in zip(mine, single)
                )
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
                row["single_kernel_x_streams_ms"] = median_ms(lambda: [
                    fused_kernels.fused_stats_cuda(sampled[b], refpack[b], p3[b], flags, k, dof)
                    for b in range(batch)
                ])
            rows.append(row)
            print("phase 7:", json.dumps(row), flush=True)
    return rows, worst


def _reset_counts():
    """Every kernel's launch count to 0."""
    from dvo_slam_tpu_torch.ops import fused_kernels, table_copy

    for wrapper in (fused_kernels.fused_stats_cuda, fused_kernels.fused_stats_batched_cuda,
                    fused_kernels.fused_partials_cuda, table_copy.table_copy_cuda):
        wrapper.launches = 0


def check_lockstep(cfg, intrinsics, d_i, d_d, gt, single_fps):
    """Phase 7b: B streams in lockstep.  Returns the batched kernel's
    launches and the phase's summary."""
    from dvo_slam_tpu_torch.ops import fused_kernels
    from dvo_slam_tpu_torch.parallel.multistream import make_multistream_tracker
    from dvo_slam_tpu_torch.tools.fused_check import require
    from dvo_slam_tpu_torch.tools.multistream_bench import stream_ates

    run = make_multistream_tracker(cfg, intrinsics)
    run.tracks(d_i[:, :3], d_d[:, :3])  # warm-up, not counted

    _reset_counts()
    tracks, seconds = _synchronized_seconds(lambda: run.tracks(d_i, d_d))
    batched = fused_kernels.fused_stats_batched_cuda.launches
    single = fused_kernels.fused_stats_cuda.launches
    require(batched == tracks.loop_iterations > 0,
            f"batched kernel launches {batched} != lockstep iterations {tracks.loop_iterations}")
    require(single == 0, f"the single-stream kernel launched {single} times in lockstep")
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
        "lockstep_iterations": tracks.loop_iterations, "batched_launches": batched,
        "single_stream_launches": single,
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
    row = {"name": "table_copy", "route": "cuda", "source": COPY_SOURCE, "replaces": COPY_REPLACES,
           "max_abs_err": worst}
    _timed(row, lambda: table_copy.table_copy_cuda(full), lambda: table_copy.table_copy_plain(full))
    device_ms, _ = gather_probe.device_time(lambda: table_copy.table_copy_cuda(full))
    plain_device_ms, _ = gather_probe.device_time(lambda: table_copy.table_copy_plain(full))
    moved = 2 * full.numel() * full.element_size()
    print("phase 10:", json.dumps({
        "copy_checked": {k: list(v.shape) for k, v in tables.items()}, "bit_equal": True,
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "gb_per_s": moved / row["ms"] / 1e6, "plain_gb_per_s": moved / row["plain_ms"] / 1e6,
        "device_ms": device_ms, "plain_device_ms": plain_device_ms,
        "device_gb_per_s": _per(moved / 1e6, device_ms),
        "plain_device_gb_per_s": _per(moved / 1e6, plain_device_ms),
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
    from dvo_slam_tpu_torch.ops import fused_kernels
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
        ("fused_stats", ("dvo_fused_stats", "dvo_fused_stats_batched", "dvo_fused_partials")),
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

    # phase 3: kernels vs twins on a rendered 640x480 pair
    easy_poses = synthetic.circular_trajectory(NUM_FRAMES, radius=0.05, rot_amplitude=0.02)
    t0 = time.perf_counter()
    easy_i, easy_d = render_sequence(easy_poses, SHAPE, TUM_FR1, seed0=0)
    print(f"phase 3: rendered {NUM_FRAMES} frames in {time.perf_counter() - t0:.1f} s",
          flush=True)
    d_i, d_d = upload_sequence(easy_i, easy_d, device)
    pair = [build_frame(cfg, d_i[k], d_d[k]) for k in (0, 1)]
    checks = check_kernels(cfg, TUM_FR1, pair[0], pair[1])

    # phase 4: 100-frame odometry through the kernel
    track_sequence(cfg, TUM_FR1, d_i[:3], d_d[:3])  # warm-up, not counted
    _reset_counts()
    est, iterations, seconds = track_sequence(cfg, TUM_FR1, d_i, d_d)
    launches = fused_kernels.fused_stats_cuda.launches
    require(launches == iterations > 0,
            f"kernel launches {launches} != solver iterations {iterations}")
    stamps = np.arange(NUM_FRAMES) / 30.0
    ate = trajectory.ate_rmse(stamps, est, stamps, easy_poses)
    fps = (NUM_FRAMES - 1) / seconds
    require(np.isfinite(est).all() and np.isfinite(ate), "non-finite odometry")
    print("phase 4:", json.dumps({
        "frames": NUM_FRAMES, "ate_rmse_m": ate, "tracked_frames_per_s": fps,
        "seconds": seconds, "solver_iterations": iterations, "kernel_launches": launches,
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
    before = fused_kernels.fused_stats_cuda.launches
    hard_est, hard_iterations, hard_seconds = track_sequence(cfg, TUM_FR1, h_i, h_d)
    hard_launches = fused_kernels.fused_stats_cuda.launches - before
    require(hard_launches == hard_iterations > 0,
            f"kernel launches {hard_launches} != solver iterations {hard_iterations}")
    hard_ate = trajectory.ate_rmse(stamps, hard_est, stamps, hard_poses)
    print("phase 5:", json.dumps({
        "frames": NUM_FRAMES, "ate_rmse_m": hard_ate,
        "tracked_frames_per_s": (NUM_FRAMES - 1) / hard_seconds,
        "seconds": hard_seconds, "solver_iterations": hard_iterations,
        "kernel_launches": hard_launches,
    }), flush=True)
    require(hard_ate < HARD_ATE_GATE_M, f"hard-scene ATE {hard_ate} m >= {HARD_ATE_GATE_M} m")

    # phase 6: the sharded paths on a one-rank process group
    frames = [build_frame(cfg, d_i[k], d_d[k]) for k in range(SHARDED_PAIRS + 1)]
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
    for name, replaces, main_launches in (
        ("fused_stats", STATS_REPLACES, launches + hard_launches),
        ("fused_partials", PARTIALS_REPLACES, partials_launches),
    ):
        rows, worst = checks[name]
        l1 = next(r for r in rows if r["level"] == cfg.last_level and r["first_iter"] == 0)
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE, "replaces": replaces,
            "launches": main_launches, **worst, "ms": l1["ms"], "plain_ms": l1["plain_ms"],
        })
    l1 = next(r for r in batched_rows if r["level"] == cfg.last_level and r["first_iter"] == "0")
    kernels.append({
        "name": "fused_stats_batched", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": BATCHED_REPLACES, "launches": batched_launches, **batched_worst,
        "ms": l1["ms"], "plain_ms": l1["plain_ms"],
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
