"""The controls of the keyframe-session cell's check, read by the cell's own
comparisons at the cell's own size.  Each has to come out as not correct;
their readings beside the sound runs' set the limits (PERF.md).

* the front end and the loop constraints: the plain tracker reference one
  precision down (float32 with TF32 matrix products) in the program's
  place, as ``control.slam_control`` reads it for the live SLAM cell;
* the map, from one whole session of the program per seed: its map
  (``sound``), the final graph solved by the plain pose-graph reference in
  float32 from the poses the session held before its final pass
  (``float32``), those poses themselves (``skipped``: no final pass), and
  the maps of sessions whose final pass runs a tenth of its iterations
  (``tenth``) or prunes at ten times its outlier threshold
  (``overpruned``: every robust edge whose weight is below 1 at 0.1), each
  read against the cell's own configuration.

    python3 -m slam_bench.control_sessions --workload fr3_office_slam.recorded --seeds 1,2,3

Prints one JSON line per seed with the limits.  The benchmark's own runs
never run it.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys

import numpy as np
import torch

from slam_bench import control, manifest, program, traffic as traffic_mod
from slam_bench.reference import pose_graph as ref_pg


def _session(entry_mod, config, rec, device):
    """The map of one whole session."""
    entry = entry_mod.Entry(config, device)
    entry.start_pass()
    for i in range(len(rec.intensity)):
        entry.update(entry.ingest(rec.intensity[i], rec.depth[i], float(rec.stamps[i])))
    return entry.end_session()[0]


def _numbers(entry_mod, m, config, device, poses=None) -> dict:
    """The map's numbers for ``m`` with its poses replaced by ``poses`` [N,
    4, 4] (rows of ``m``) where given, read against ``config``."""
    if poses is not None:
        m = m._replace(poses=poses)
    t, r, _ = entry_mod.map_gaps(m, device)
    kept, _ = entry_mod.final_pass(m, config, device)
    return {"map_gap_t_p90_m": float(np.percentile(t, 90)),
            "map_gap_r_p90_rad": float(np.percentile(r, 90)),
            "map_gap_t_max_m": float(t.max()), "map_gap_r_max_rad": float(r.max()),
            "map_prune_mismatches": int((kept != m.kept).sum()),
            "pruned": int((~m.kept).sum())}


def _float32_solve(entry_mod, m, device) -> np.ndarray:
    """The final graph (``m``'s kept edges) solved by the reference in
    float32 from the poses its final pass started from: the poses [N, 4,
    4] by ``m``'s rows."""
    g, rows = entry_mod.map_graph(m._replace(poses=m.start_poses))
    solution = ref_pg.optimize(g.to(device=device, dtype=torch.float32))
    poses = m.poses.copy()
    poses[rows] = solution.poses.to(torch.float64).cpu().numpy()
    return poses


def map_control(cell: manifest.Cell, seed: int, device) -> dict:
    entry_mod = manifest.entry(cell.config["entry"])
    n = traffic_mod.recording_frames(cell.config, cell.traffic, 0.0)
    rec = traffic_mod.make_recording(cell.config, n, seed, device)
    config = cell.config
    entry_mod.warm_up(config, cell.traffic, rec, device)
    sound = _session(entry_mod, config, rec, device)
    tenth = copy.deepcopy(config)
    tenth["graph"]["final_optimization_iterations"] //= 10
    overpruned = copy.deepcopy(config)
    overpruned["graph"]["final_optimization_outlier_weight_threshold"] *= 10
    out = {
        "sound": _numbers(entry_mod, sound, config, device),
        "float32": _numbers(entry_mod, sound, config, device,
                            _float32_solve(entry_mod, sound, device)),
        "skipped": _numbers(entry_mod, sound, config, device, sound.start_poses),
        "tenth": _numbers(entry_mod, _session(entry_mod, tenth, rec, device), config, device),
        "overpruned": _numbers(entry_mod, _session(entry_mod, overpruned, rec, device), config,
                               device),
        "vertices": len(sound.stamps), "edges": len(sound.edge_i),
        "keyframes": int(sound.keyframe.sum()),
    }
    program.release_graphs()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--parts", default="tracker,map")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = manifest.cell(args.workload)
    device = torch.device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    parts = args.parts.split(",")
    tracker_cell = cell._replace(config={**cell.config, "entry": "keyframe_tracker"})
    for seed in (int(s) for s in args.seeds.split(",")):
        out = {"seed": seed}
        if "map" in parts:
            out["map"] = map_control(cell, seed, device)
        if "tracker" in parts:
            out.update(control.slam_control(tracker_cell, seed, device))
        out["limits"] = cell.limits
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
