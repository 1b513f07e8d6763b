"""Per-stage times of the dense-tracking hot path on the card (port
of the reference's ``tools/profile_components.py``).

Run on a machine with a CUDA card, from the repository root:

    python -m dvo_slam_tpu_torch.tools.profile_components [--reps 30]

At 640x480 and ``benchmark_config().tracker``, each stage is timed with
CUDA events around one call (median of ``--reps`` after 5 warm-up calls,
distinct rendered frames cycled), and printed as one JSON object per line:

  pyramid      raw u8/u16 -> the pyramid (``build_frame``)
  accel+quad   acceleration pack + quad table, per level
  gather       ``warp_and_sample_cm``, per level
  evaluate     one IRLS evaluation, per level: the folded kernel
               (``warp_fused_stats_cuda``, the tracker's call), its plain
               version, and the unfolded pair the tracker ran before it
               (``warp_and_sample_cm`` + ``fused_stats_cuda``); with the
               device time per call of the folded kernel and of the pair
  partials     the fused-partials CUDA kernel and its plain twin, per level;
               also their device time per call under ``torch.profiler``
               (every kernel and copy the call puts on the card)
  sharded      kernel 2's three folded launches as the pixel-sharded
               evaluation makes them (``warp_fused_partials_cuda``,
               ``sharded_loglik_cuda``, ``sharded_tail_cuda``; the whole
               level as one rank's shard, so no all-reduce between them)
               and their plain steps, per level, with the three launches'
               device time per call
  level        one full IRLS level solve (``_match_level``, every iteration)
  match        the full coarse-to-fine ``match_pyramids``

The level solve and the match read ``done`` back to the host once per
iteration, so their times include the host's share.  The last line is a
Markdown table of the same numbers.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from .. import benchmark_config
from ..models.dense_tracker import _match_level, match_pyramids, prepare_frame
from ..odometry import build_frame, render_sequence, upload_sequence
from ..ops import fused_kernels, se3
from ..ops.camera import TUM_FR1
from ..ops.interp import build_quad_table_cm
from ..ops.pyramid import build_acceleration_cm
from ..ops.residuals import warp_and_sample_cm
from ..utils import synthetic

SHAPE = (480, 640)
FRAMES = 5  # distinct rendered frames, cycled
WARMUP = 5
TWIST = (0.01, 0.0, 0.005, 0.0, 0.0, 0.004)  # the reference profiler's warp
PRECISION = (3000.0, 50.0, 2.0e5)  # and its previous precision


def median_ms(fn, reps):
    """Median time of one call ``fn(i)`` between CUDA events, in ms (the
    launch cost where the call's device work is shorter)."""
    for i in range(WARMUP):
        fn(i)
    times = []
    for i in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(i)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, reps):
    """Device time per call of ``fn(i)`` in ms: the summed duration of the
    kernels and copies it runs on the card, from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    for i in range(WARMUP):
        fn(i)
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            fn(i)
        torch.cuda.synchronize()
    busy_us = sum(
        e.time_range.elapsed_us() for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    return busy_us / 1000.0 / reps


def profile(reps: int):
    cfg = benchmark_config().tracker
    poses = synthetic.circular_trajectory(100, radius=0.05, rot_amplitude=0.02)[:FRAMES]
    d_i, d_d = upload_sequence(*render_sequence(poses, SHAPE, TUM_FR1), "cuda")
    rows = [{"stage": "pyramid", "ms": median_ms(
        lambda i: build_frame(cfg, d_i[i % FRAMES], d_d[i % FRAMES]), reps)}]

    frames = [build_frame(cfg, d_i[k], d_d[k]) for k in range(FRAMES)]
    prepared = [prepare_frame(cfg, TUM_FR1, f) for f in frames]
    T = se3.exp_se3(torch.tensor(TWIST, device="cuda"))
    p3 = torch.tensor(PRECISION, device="cuda")
    first = torch.zeros((), dtype=torch.int32, device="cuda")
    dof = cfg.influence_function_param
    eye = torch.eye(4, device="cuda")
    x0 = se3.log_se3(eye)
    for level in range(cfg.first_level, cfg.last_level - 1, -1):
        k = TUM_FR1.at_level(level)
        shape = tuple(frames[0][level].intensity.shape)
        width = shape[1]
        row = {"stage": "level", "level": level, "pixels": shape[0] * shape[1]}
        row["accel_quad_ms"] = median_ms(lambda i: build_quad_table_cm(
            build_acceleration_cm(frames[i % FRAMES][level]), width), reps)

        def gather(i):
            ref, cur = prepared[i % FRAMES], prepared[(i + 1) % FRAMES]
            return warp_and_sample_cm(ref.refpack[level], cur.quad[level], shape, k, T,
                                      depth_buffered=cfg.depth_buffered_sampling)

        row["gather_ms"] = median_ms(gather, reps)
        P = torch.tensor([[PRECISION[0], PRECISION[1]], [PRECISION[1], PRECISION[2]]], device="cuda")

        def evaluate_args(i):
            ref, cur = prepared[i % FRAMES], prepared[(i + 1) % FRAMES]
            return (ref.refpack[level], cur.quad[level], shape, k, T, P, False, dof,
                    cfg.depth_buffered_sampling)

        def unfolded(i):
            ref = prepared[i % FRAMES]
            return fused_kernels.fused_stats_cuda(gather(i), ref.refpack[level], p3, first, k, dof)

        # one card, in turns: plain, folded, folded, plain
        folded_plain = [median_ms(lambda i: fused_kernels.warp_fused_stats_plain(*evaluate_args(i)),
                                  reps)]
        folded = [median_ms(lambda i: fused_kernels.warp_fused_stats_cuda(*evaluate_args(i)), reps)
                  for _ in range(2)]
        folded_plain.append(median_ms(
            lambda i: fused_kernels.warp_fused_stats_plain(*evaluate_args(i)), reps))
        row["evaluate_folded_ms"], row["evaluate_plain_ms"] = min(folded), min(folded_plain)
        row["evaluate_unfolded_pair_ms"] = median_ms(unfolded, reps)
        row["evaluate_folded_device_ms"] = device_ms(
            lambda i: fused_kernels.warp_fused_stats_cuda(*evaluate_args(i)), reps)
        row["evaluate_unfolded_pair_device_ms"] = device_ms(unfolded, reps)
        sampled = [gather(i) for i in range(FRAMES)]
        refpacks = [prepared[i].refpack[level] for i in range(FRAMES)]
        args = lambda i: (sampled[i % FRAMES], refpacks[i % FRAMES], p3, first, k, dof)  # noqa: E731
        # one card, in turns: twin, kernel, kernel, twin
        plain = [median_ms(lambda i: fused_kernels.fused_partials_plain(*args(i)), reps)]
        kernel = [median_ms(lambda i: fused_kernels.fused_partials_cuda(*args(i)), reps)
                  for _ in range(2)]
        plain.append(median_ms(lambda i: fused_kernels.fused_partials_plain(*args(i)), reps))
        row["partials_kernel_ms"], row["partials_plain_ms"] = min(kernel), min(plain)
        row["partials_kernel_device_ms"] = device_ms(
            lambda i: fused_kernels.fused_partials_cuda(*args(i)), reps)
        row["partials_plain_device_ms"] = device_ms(
            lambda i: fused_kernels.fused_partials_plain(*args(i)), reps)

        def sharded_args(i):
            ref, cur = prepared[i % FRAMES], prepared[(i + 1) % FRAMES]
            return (ref.refpack[level], cur.quad[level], shape, k, T, P, False, dof)

        def sharded(partials, loglik, tail):
            return lambda i: tail(loglik(partials(*sharded_args(i))))

        three = sharded(fused_kernels.warp_fused_partials_cuda, fused_kernels.sharded_loglik_cuda,
                        fused_kernels.sharded_tail_cuda)
        three_plain = sharded(fused_kernels.warp_fused_partials_plain,
                              fused_kernels.sharded_loglik_plain, fused_kernels.sharded_tail_plain)
        # one card, in turns: plain, kernels, kernels, plain
        plain = [median_ms(three_plain, reps)]
        kernel = [median_ms(three, reps) for _ in range(2)]
        plain.append(median_ms(three_plain, reps))
        row["sharded_kernels_ms"], row["sharded_plain_ms"] = min(kernel), min(plain)
        row["sharded_kernels_device_ms"] = device_ms(three, reps)

        def level_solve(i):
            ref, cur = prepared[i % FRAMES], prepared[(i + 1) % FRAMES]
            _match_level(cfg, k, ref.sel[level], ref.refpack[level], cur.quad[level],
                         x0, se3.identity(device="cuda"), eye, torch.eye(2, device="cuda"))

        row["level_solve_ms"] = median_ms(level_solve, reps)
        rows.append(row)
    rows.append({"stage": "match", "ms": median_ms(lambda i: match_pyramids(
        cfg, TUM_FR1, frames[i % FRAMES], frames[(i + 1) % FRAMES], eye), reps)})
    return rows


def table(rows) -> str:
    lines = [
        "| Stage | L3 | L2 | L1 |",
        "|---|---|---|---|",
    ]
    levels = [r for r in rows if r["stage"] == "level"]
    for key, label in (("accel_quad_ms", "accel + quad"), ("gather_ms", "gather"),
                       ("evaluate_folded_ms", "evaluate, folded kernel"),
                       ("evaluate_plain_ms", "evaluate, plain version"),
                       ("evaluate_unfolded_pair_ms", "evaluate, gather + fused_stats kernel"),
                       ("evaluate_folded_device_ms", "evaluate, folded kernel, device"),
                       ("evaluate_unfolded_pair_device_ms",
                        "evaluate, gather + fused_stats kernel, device"),
                       ("partials_kernel_ms", "partials, CUDA kernel"),
                       ("partials_plain_ms", "partials, plain twin"),
                       ("partials_kernel_device_ms", "partials, CUDA kernel, device"),
                       ("partials_plain_device_ms", "partials, plain twin, device"),
                       ("sharded_kernels_ms", "sharded evaluation, three kernels"),
                       ("sharded_plain_ms", "sharded evaluation, plain steps"),
                       ("sharded_kernels_device_ms", "sharded evaluation, three kernels, device"),
                       ("level_solve_ms", "one level solve")):
        lines.append(f"| {label} | " + " | ".join(f"{r[key]:.3f}" for r in levels) + " |")
    pyramid = next(r for r in rows if r["stage"] == "pyramid")["ms"]
    match = next(r for r in rows if r["stage"] == "match")["ms"]
    lines.append(f"| pyramid (4 levels) | {pyramid:.3f} | | |")
    lines.append(f"| full match (3 levels) | {match:.3f} | | |")
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=30, help="timed calls per stage (>= 20)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_components: no CUDA device")
    if args.reps < 20:
        raise SystemExit("profile_components: --reps must be at least 20")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}), flush=True)
    rows = profile(args.reps)
    for row in rows:
        print(json.dumps(row), flush=True)
    print(table(rows))


if __name__ == "__main__":
    main()
