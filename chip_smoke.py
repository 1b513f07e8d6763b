#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dvo_slam_tpu_torch``) on one card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Device: a CUDA card is required (there is no CPU fallback).  Prints
   its name and ``nvidia-smi``'s name and power limit.
2. Build: ``nvcc`` builds ``dvo_slam_tpu_torch/csrc/fused_stats.cu`` from
   the checkout; prints the build seconds and the compiler's report.
3. Kernel vs plain twin on the card: the real ``sampled``/``refpack`` of
   a rendered 640x480 pair at levels 3, 2 and 1, with ``first_iter`` 0
   and 1.  ``num_valid`` equal; the kernel's Gram blocks
   (M00/M01/M11/v/scale_sum) element-wise within rtol 1e-6 of the float64
   Gram of the same float32 rows, and each entry G_ab within 1e-4 of
   sqrt(G_aa G_bb) of the float32 twin's; ``log_sum`` within rtol 1e-5;
   two kernel runs bit-identical; times of both (CUDA events, median of
   30 runs after 5 warm-up runs).
4. Odometry: 100 frames at 640x480 (``TUM_FR1``), frame to frame with a
   constant-velocity warm start at ``benchmark_config().tracker``, from
   u8/u16 frames through ``convert_raw_depth`` -> ``build_pyramid`` ->
   ``match_pyramids``.  The kernel launch count must equal the number of
   solver iterations.  Prints ATE-RMSE and tracked frames/s.
5. Hard scene: the occluded scene under a 30 cm loop; ATE-RMSE < 10 mm.

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
KERNEL_REPLACES = "dvo_slam_tpu/ops/pallas_kernels.py:413"


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


def check_kernel(cfg, intrinsics, ref_levels, cur_levels):
    """Phase 3: kernel vs plain twin at every solved level, first_iter 0
    and 1; returns per-level rows and the worst errors: against the twin
    absolute and scaled by sqrt(G_aa G_bb) (``compare_fused_stats``), and
    relative to the float64 Gram (``compare_exact_gram``)."""
    import torch

    from dvo_slam_tpu_torch.ops import fused_kernels
    from dvo_slam_tpu_torch.tools import fused_check

    rows = []
    worst_abs, worst_scaled, worst_exact = 0.0, 0.0, 0.0
    for level, (sampled, refpack, k) in fused_check.level_inputs(
        cfg, intrinsics, ref_levels, cur_levels
    ).items():
        device = sampled.device
        p3 = torch.tensor(fused_check.CHECK_PRECISION, dtype=torch.float32, device=device)
        for first in (0, 1):
            flag = torch.tensor(first, dtype=torch.int32, device=device)
            args = (sampled, refpack, p3, flag, k, cfg.influence_function_param)
            kernel = fused_kernels.fused_stats_cuda(*args)
            again = fused_kernels.fused_stats_cuda(*args)
            twin = fused_kernels.fused_stats_plain(*args)
            exact = fused_check.exact_gram(*args)
            torch.cuda.synchronize(device)
            fused_check.assert_bit_identical(kernel, again)
            abs_err, scaled_err = fused_check.compare_fused_stats(kernel, twin)
            exact_err = fused_check.compare_exact_gram(kernel, exact)
            worst_abs, worst_scaled = max(worst_abs, abs_err), max(worst_scaled, scaled_err)
            worst_exact = max(worst_exact, exact_err)
            row = {
                "level": level, "pixels": sampled.shape[1], "first_iter": first,
                "num_valid": int(float(kernel.num_valid)),
                "max_abs_err": abs_err, "max_scaled_err": scaled_err,
                "max_rel_err_f64": exact_err,
            }
            if first == 0:
                # one card, in turns: twin, kernel, kernel, twin
                t_plain = [median_ms(lambda: fused_kernels.fused_stats_plain(*args))]
                t_kernel = [median_ms(lambda: fused_kernels.fused_stats_cuda(*args))]
                t_kernel.append(median_ms(lambda: fused_kernels.fused_stats_cuda(*args)))
                t_plain.append(median_ms(lambda: fused_kernels.fused_stats_plain(*args)))
                row["ms"] = min(t_kernel)
                row["plain_ms"] = min(t_plain)
            rows.append(row)
            print("phase 3:", json.dumps(row), flush=True)
    return rows, worst_abs, worst_scaled, worst_exact


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

    # phase 2: build
    t0 = time.perf_counter()
    library = _build.load_library("fused_stats")
    print(f"phase 2: built {library.path} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {library.build_seconds:.2f} s)", flush=True)
    for line in library.compiler_log.strip().splitlines():
        print("phase 2: nvcc:", line)

    cfg = benchmark_config().tracker

    # phase 3: kernel vs twin on a rendered 640x480 pair
    easy_poses = synthetic.circular_trajectory(NUM_FRAMES, radius=0.05, rot_amplitude=0.02)
    t0 = time.perf_counter()
    easy_i, easy_d = render_sequence(easy_poses, SHAPE, TUM_FR1, seed0=0)
    print(f"phase 3: rendered {NUM_FRAMES} frames in {time.perf_counter() - t0:.1f} s",
          flush=True)
    d_i, d_d = upload_sequence(easy_i, easy_d, device)
    pair = [build_frame(cfg, d_i[k], d_d[k]) for k in (0, 1)]
    rows, worst_abs, worst_scaled, worst_exact = check_kernel(cfg, TUM_FR1, pair[0], pair[1])

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

    l1 = next(r for r in rows if r["level"] == cfg.last_level and r["first_iter"] == 0)
    print(json.dumps({"kernels": [{
        "name": "fused_stats",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": launches + hard_launches,
        "max_abs_err": worst_abs,
        "max_scaled_err": worst_scaled,
        "max_rel_err_f64": worst_exact,
        "ms": l1["ms"],
        "plain_ms": l1["plain_ms"],
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
