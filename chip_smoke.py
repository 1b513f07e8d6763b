#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dvo_slam_tpu_torch``) on one card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Device: a CUDA card is required (there is no CPU fallback).  Prints
   its name and ``nvidia-smi``'s name and power limit.
2. Build: ``nvcc`` builds ``dvo_slam_tpu_torch/csrc/fused_stats.cu`` (one
   library, both kernels' entry points) from the checkout; prints the
   build seconds and the compiler's report.
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

The last two lines of standard output are one JSON object describing the
kernels, then ``{"ok": true, "device": {...}}``.
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


def _pose_error(T_gt, T):
    """max |log(T_gt^-1 T)| in float64 on the host."""
    import torch

    from dvo_slam_tpu_torch.ops import se3

    rel = np.linalg.inv(np.asarray(T_gt, np.float64)) @ T.detach().cpu().numpy().astype(np.float64)
    return float(se3.log_se3(torch.from_numpy(rel)).abs().max())


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
            fused_kernels.fused_stats_cuda.launches = 0
            fused_kernels.fused_partials_cuda.launches = 0
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
    from dvo_slam_tpu_torch.tools.fused_check import require
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

    # phase 2: build (one library, both kernels' entry points)
    t0 = time.perf_counter()
    library = _build.load_library("fused_stats")
    for entry in ("dvo_fused_stats", "dvo_fused_partials"):
        require(hasattr(library.lib, entry), f"the library lacks {entry}")
    print(f"phase 2: built {library.path} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {library.build_seconds:.2f} s)", flush=True)
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
    fused_kernels.fused_stats_cuda.launches = 0
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
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
