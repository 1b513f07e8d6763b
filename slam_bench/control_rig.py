"""The two readings that set the rig cell's limits (``limits/<cell>.json``,
PERF.md), for the cell's own comparison at the cell's own size:

* ``control``: the plain reference put in the program's place and computed
  one precision below what the configuration states (float32 with TF32
  matrix products, for float32 with TF32 off), on the pairs the check would
  draw from a whole pass of the rig (``check_pairs / B`` a stream), against
  the float64 reference.  It has to come out as not correct; its smallest
  reading over the seeds is the upper reading of each limit.
* ``sound``: the program itself, through the harness's own run of the cell
  (``harness.run_cell``, no trace) with a window of ``--seconds``, long
  enough for a whole pass; its largest reading over the seeds is the lower
  reading.

    python3 -m slam_bench.control_rig --workload rig8_lockstep.recorded --seeds 1,2,3 \
        [--parts control,sound] [--seconds 5] [--device cpu]

Prints one JSON line per seed and part: the numbers the check compares and
their widest gaps, with the limits.  The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from slam_bench import harness, manifest, traffic as traffic_mod
from slam_bench.reference import tracker as ref


def control(cell: manifest.Cell, seed: int, device) -> dict:
    entry = manifest.entry(cell.config["entry"])
    n = traffic_mod.recording_frames(cell.config, cell.traffic, 0.0)
    rec = traffic_mod.make_recording(cell.config, n, seed, device)
    recs = entry.rig(cell.config, rec, device)
    streams = entry.streams_of(cell.config)
    per = max(1, int(cell.traffic["check_pairs"]) // streams)
    picks = []
    for b in range(streams):
        rng = np.random.default_rng([int(seed) % (1 << 63), b])
        picks.append([int(i) for i in np.sort(rng.choice(np.arange(1, n), size=per,
                                                          replace=False))])
    got, _ = entry.reference_pairs(cell.config, recs, picks, device, dtype=torch.float32,
                                   mm=ref.tf32_matmul)
    want, _ = entry.reference_pairs(cell.config, recs, picks, device)
    t, r = entry._ct.gaps(got, want)
    return {"seed": seed, "part": "control", "pose_gap_t_p90_m": float(np.percentile(t, 90)),
            "pose_gap_r_p90_rad": float(np.percentile(r, 90)),
            "pose_gap_t_max_m": float(t.max()), "pose_gap_r_max_rad": float(r.max()),
            "limits": {k: v for k, v in cell.limits.items() if k != "readings"}}


def sound(cell: manifest.Cell, seed: int, device, seconds: float) -> dict:
    result, _ = harness.run_cell(cell, seed, seconds, False, device, time.time())
    out = {"seed": seed, "part": "sound", "correct": result["correct"],
           "attempted": result["attempted"], "failed": result["failed"]}
    out.update({c["name"]: c["value"] for c in result["checks"]})
    out["frames_per_s"] = result["metrics"].get("frames_per_s", {}).get("value")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--parts", default="control")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = manifest.cell(args.workload)
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", device.index or 0)
        torch.cuda.set_device(device)
        torch.set_num_threads(1)  # as the harness's own process
    for seed in (int(s) for s in args.seeds.split(",")):
        for part in args.parts.split(","):
            out = (control(cell, seed, device) if part == "control"
                   else sound(cell, seed, device, args.seconds))
            print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
