"""The control of a cell's check: the plain reference put in the program's
place and computed one precision below what the configuration states
(float32 with TF32 matrix products, for float32 with TF32 off), read by
the cell's own comparison at the cell's own size.  It has to come out as
not correct; its smallest reading over the seeds is the upper reading of
each limit (PERF.md).

    python3 -m slam_bench.control --workload <cell> --seeds 1,2,3 [--device cpu]

Prints one JSON line per seed: the numbers the check compares, with the
limits.  The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from slam_bench import manifest, traffic as traffic_mod
from slam_bench.reference import tracker as ref


def odometry_control(cell: manifest.Cell, seed: int, device, pairs: int = 0) -> dict:
    """The camera-tracker cell's comparison with the control in the program's
    place: the pairs the check would draw from a whole pass of the
    recording, aligned by the control and by the float64 reference."""
    entry = manifest.entry(cell.config["entry"])
    n = traffic_mod.recording_frames(cell.config, cell.traffic, 0.0)
    rec = traffic_mod.make_recording(cell.config, n, seed, device)
    count = pairs or int(cell.traffic["check_pairs"])
    rng = np.random.default_rng(int(seed) % (1 << 63))
    idx = [int(i) for i in np.sort(rng.choice(np.arange(1, n), size=count, replace=False))]
    control, _ = entry.reference_poses(cell.config, rec, idx, device, dtype=torch.float32,
                                       mm=ref.tf32_matmul)
    reference, _ = entry.reference_poses(cell.config, rec, idx, device)
    t, r = entry.gaps(control, reference)
    return {"seed": seed, "pose_gap_t_p90_m": float(np.percentile(t, 90)),
            "pose_gap_r_p90_rad": float(np.percentile(r, 90)),
            "pose_gap_t_max_m": float(t.max()), "pose_gap_r_max_rad": float(r.max()),
            "limits": cell.limits}


def slam_control(cell: manifest.Cell, seed: int, device, pairs: int = 0,
                 seconds: float = 20.0) -> dict:
    """The keyframe-tracker cell's comparison with the control in the
    program's place, on pairs shaped as the program's answers are: frame
    k against a keyframe j = k - d, d up to the frames a keyframe spans
    (0.2 m at the loop's speed), through the front end's chain; and loop
    constraints between frames a lap apart, from the ground truth."""
    entry = manifest.entry(cell.config["entry"])
    n = traffic_mod.recording_frames(cell.config, cell.traffic, seconds)
    rec = traffic_mod.make_recording(cell.config, n, seed, device)
    count = pairs or int(cell.traffic["check_pairs"])
    rng = np.random.default_rng(int(seed) % (1 << 63))
    lap = int(cell.config["loop"]["lap_frames"])
    span = int(cell.config["keyframe"]["max_translational_distance"]
               / cell.config["sequence"]["mean_translational_speed_m_s"]
               * cell.config["sequence"]["rate_hz"])
    d = rng.integers(1, span + 1, size=count)
    k = rng.integers(span, n, size=count)
    front = [(int(a - b), int(a)) for a, b in zip(k, d)]
    a = rng.integers(0, n - lap - 8, size=count)
    loops = [(int(x), int(x + lap + rng.integers(-8, 9))) for x in a]
    front_s, fine_s = entry.settings(cell.config)
    out = {"seed": seed}
    for kind, got, want in (
            ("frontend",
             entry.align_chains(front_s, rec, front, device, dtype=torch.float32,
                                mm=ref.tf32_matmul),
             entry.align_chains(front_s, rec, front, device)),
            ("loop",
             entry.align_pairs(fine_s, rec, loops, device, dtype=torch.float32,
                               mm=ref.tf32_matmul),
             entry.align_pairs(fine_s, rec, loops, device))):
        t, r = entry._gaps(got, want)
        out[f"{kind}_gap_t_p90_m"] = float(np.percentile(t, 90))
        out[f"{kind}_gap_r_p90_rad"] = float(np.percentile(r, 90))
    out["limits"] = cell.limits
    return out


CONTROLS = {"camera_tracker": odometry_control, "keyframe_tracker": slam_control}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = manifest.cell(args.workload)
    device = torch.device(args.device)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = CONTROLS[cell.config["entry"]](cell, seed, device)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
