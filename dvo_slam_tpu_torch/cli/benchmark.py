"""Batch SLAM/odometry driver — the dvo_benchmark replacement (port of
``dvo_slam_tpu.cli.benchmark``).

Replaces the reference benchmark executable
(dvo_benchmark/src/benchmark_slam.cpp): loads a TUM RGB-D sequence (or
renders a synthetic one when no dataset is on disk), runs keyframe SLAM or
plain frame-to-frame odometry, writes TUM-format trajectories (estimated +
optimized), dumps edge errors, and — unlike the reference, which defers to
the external TUM tools — evaluates ATE/RPE in-process when ground truth is
available.  Runs on the card unless ``--device`` names another.

Usage:
  python -m dvo_slam_tpu_torch.cli.benchmark --dataset /path/to/rgbd_dataset_fr1_desk
  python -m dvo_slam_tpu_torch.cli.benchmark --synthetic 60 --mode slam --engine streaming
  python -m dvo_slam_tpu_torch.cli.benchmark --synthetic 30 --mode odometry --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", help="TUM RGB-D sequence directory (with assoc.txt)")
    p.add_argument(
        "--synthetic",
        type=int,
        default=0,
        metavar="N",
        help="render an N-frame synthetic sequence instead of a dataset",
    )
    p.add_argument("--mode", choices=("slam", "odometry"), default="slam")
    p.add_argument(
        "--engine",
        choices=("loop", "streaming"),
        default="loop",
        help="slam-mode front end: per-frame host loop (the reference's "
        "online shape) or the whole-sequence device front end "
        "(models/streaming.py; the batch shape)",
    )
    p.add_argument("--output-dir", default=".", help="where trajectories are written")
    p.add_argument("--trajectory-file", default="trajectory.txt")
    p.add_argument("--optimized-file", default="trajectory_optimized.txt")
    p.add_argument("--edge-error-file", default="edge_errors.txt")
    p.add_argument("--groundtruth", help="TUM groundtruth.txt for ATE evaluation")
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--keyframe-distance", type=float, default=None,
                   help="override max translational keyframe distance")
    p.add_argument("--shape", default="480x640",
                   help="synthetic frame size HxW (default 480x640)")
    p.add_argument("--timing", action="store_true", help="print phase timing summary")
    p.add_argument(
        "--device", default=None,
        help="device to run on (default: the current CUDA card; 'cpu' runs on the CPU)",
    )
    p.add_argument(
        "--profile-dir", default=None, metavar="DIR",
        help="capture a torch.profiler trace of the run into DIR/trace.json "
        "(the device-side complement of --timing's host phase taxonomy)",
    )
    p.add_argument(
        "--interactive-html", default=None, metavar="FILE",
        help="SLAM mode: export the interactive pose-graph viewer (one "
        "self-contained HTML file) into --output-dir",
    )
    return p


def _write_slam_outputs(args, graph, opt_stamps, opt_poses, trajectory):
    """The optimized trajectory and the edge-error dump of a SLAM run."""
    w, chi2 = graph.edge_errors()
    os.makedirs(args.output_dir, exist_ok=True)
    trajectory.write_tum_trajectory(
        os.path.join(args.output_dir, args.optimized_file), opt_stamps, opt_poses
    )
    with open(os.path.join(args.output_dir, args.edge_error_file), "w") as f:
        for wi, ci in zip(w, chi2):
            f.write(f"{wi:.6f} {ci:.6f}\n")


def main(argv=None):
    args = build_arg_parser().parse_args(argv)

    import dataclasses

    import torch

    from .. import default_device
    from ..config import benchmark_config
    from ..models.dense_tracker import DenseTracker
    from ..models.keyframe_tracker import KeyframeTracker
    from ..ops.camera import TUM_DEFAULT
    from ..utils import trajectory
    from ..utils.dataset import SyntheticDataset, TumDataset
    from ..utils.timers import PhaseTimers

    cfg = benchmark_config()
    if args.keyframe_distance is not None:
        cfg = dataclasses.replace(
            cfg,
            keyframe=dataclasses.replace(
                cfg.keyframe, max_translational_distance=args.keyframe_distance
            ),
        )

    gt_stamps = gt_poses = None
    if args.dataset:
        ds = TumDataset(args.dataset)
        intrinsics = ds.intrinsics
        gt_path = args.groundtruth or os.path.join(args.dataset, "groundtruth.txt")
        if os.path.exists(gt_path):
            gt_stamps, gt_poses = trajectory.read_tum_trajectory(gt_path)
    elif args.synthetic:
        h, w = (int(x) for x in args.shape.split("x"))
        scale = w / 640.0
        intrinsics = TUM_DEFAULT.scale(scale) if scale != 1.0 else TUM_DEFAULT
        ds = SyntheticDataset(
            num_frames=args.synthetic,
            shape=(h, w),
            intrinsics=intrinsics,
            depth_noise=0.002,
            intensity_noise=1.0,
        )
        gt_stamps, gt_poses = ds.timestamps(), ds.groundtruth()
    else:
        print("error: provide --dataset or --synthetic N", file=sys.stderr)
        return 2
    device = default_device(args.device)

    timers = PhaseTimers()
    stamps, est_poses = [], []
    n_frames = len(ds) if not args.max_frames else min(len(ds), args.max_frames)

    profiler = None
    if args.profile_dir:
        os.makedirs(args.profile_dir, exist_ok=True)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()

    if args.mode == "slam" and args.engine == "streaming":
        from ..models.streaming import StreamingSLAM

        iu8 = np.zeros((n_frames,) + ds[0].intensity.shape, np.uint8)
        du16 = np.zeros_like(iu8, dtype=np.uint16)
        for i in range(n_frames):
            f = ds[i]
            iu8[i] = np.clip(f.intensity, 0, 255).astype(np.uint8)
            du16[i] = np.where(f.valid, f.depth * 5000.0, 0).astype(np.uint16)
            stamps.append(f.timestamp)
        kt = StreamingSLAM(intrinsics, cfg, device=device)
        with timers.timing("match"):
            est = kt.track_sequence(iu8, du16, np.asarray(stamps))
        est_poses = [est[i] for i in range(n_frames)]
        opt_stamps, opt_poses = kt.trajectory()
        _write_slam_outputs(args, kt.graph, opt_stamps, opt_poses, trajectory)
        kt.graph.shutdown()
    elif args.mode == "slam":
        kt = KeyframeTracker(intrinsics, cfg, device=device)
        kt.init()
        for i in range(n_frames):
            frame_np = ds[i]
            with timers.timing("prepare"):
                frame = kt.make_frame(
                    frame_np.intensity, frame_np.depth, frame_np.valid, frame_np.timestamp
                )
            if i == n_frames - 1:
                kt.force_keyframe()  # benchmark_slam.cpp:477-481
            with timers.timing("match"):
                pose = kt.update(frame)
            stamps.append(frame_np.timestamp)
            est_poses.append(np.asarray(pose, np.float64))
        with timers.timing("final_optimization"):
            kt.finish()
        opt_stamps, opt_poses = kt.trajectory()
        _write_slam_outputs(args, kt.graph, opt_stamps, opt_poses, trajectory)
        kt.graph.shutdown()
    else:
        tracker = DenseTracker(intrinsics, cfg.tracker)
        pose = np.eye(4)
        prev = None
        for i in range(n_frames):
            frame_np = ds[i]
            with timers.timing("prepare"):
                pyr = tracker.build_pyramid(
                    torch.from_numpy(frame_np.intensity).to(device),
                    torch.from_numpy(np.asarray(frame_np.depth, np.float32)).to(device),
                    torch.from_numpy(frame_np.valid).to(device),
                )
            if prev is not None:
                with timers.timing("match"):
                    r = tracker.match(prev, pyr)
                pose = pose @ r.transformation.cpu().numpy().astype(np.float64)
            prev = pyr
            stamps.append(frame_np.timestamp)
            est_poses.append(pose.copy())
        opt_stamps, opt_poses = np.asarray(stamps), np.asarray(est_poses)

    if profiler is not None:
        profiler.stop()
        profiler.export_chrome_trace(os.path.join(args.profile_dir, "trace.json"))

    os.makedirs(args.output_dir, exist_ok=True)
    trajectory.write_tum_trajectory(
        os.path.join(args.output_dir, args.trajectory_file), stamps, est_poses
    )

    if args.interactive_html and args.mode == "slam":
        from ..utils.interactive_viz import export_interactive_graph

        export_interactive_graph(
            os.path.join(args.output_dir, args.interactive_html),
            kt.graph, intrinsics=intrinsics,
        )

    report = {"frames": n_frames, "mode": args.mode}
    if gt_poses is not None and len(gt_poses):
        report["ate_rmse_m"] = trajectory.ate_rmse(
            np.asarray(stamps), np.asarray(est_poses), np.asarray(gt_stamps), gt_poses
        )
        report["ate_rmse_optimized_m"] = trajectory.ate_rmse(
            np.asarray(opt_stamps), np.asarray(opt_poses), np.asarray(gt_stamps), gt_poses
        )
        rpe_t, rpe_r = trajectory.rpe_rmse(
            np.asarray(stamps), np.asarray(est_poses), np.asarray(gt_stamps), gt_poses
        )
        report["rpe_translational_m"] = rpe_t
        report["rpe_rotational_rad"] = rpe_r
    if args.timing:
        report["timing"] = timers.summary()
    print(json.dumps(report, indent=2, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
