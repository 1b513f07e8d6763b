"""A cell cut to a size the CPU tests can run: the configuration's frames
at 1/``factor`` of their size (intrinsics scaled alike), few recorded
frames."""

from __future__ import annotations

import copy

from slam_bench import manifest


def tiny_cell(name: str, frames: int = 10, factor: int = 4, **traffic) -> manifest.Cell:
    cell = manifest.cell(name)
    config = copy.deepcopy(cell.config)
    config["sequence"]["shape"] = [s // factor for s in config["sequence"]["shape"]]
    config["sequence"]["frames"] = frames
    for key in ("fx", "fy", "ox", "oy"):
        config["intrinsics"][key] /= factor
    return cell._replace(config=config, traffic={**cell.traffic, **traffic})


# the live SLAM cell's harness (``entries/keyframe_tracker.py``, ``traffic/
# live30.json``, its configuration): ready, not in BENCHMARK.json (PERF.md)
LIVE = {"name": "fr3_office_slam.live30", "config": "tum_fr3_office_slam", "traffic": "live30",
        "chips": 1}
LIVE_FILE = "slam_bench/configs/tum_fr3_office_slam.json"


def live_cell(factor: int = 2, limits=None) -> manifest.Cell:
    cell = manifest.assemble(LIVE, LIVE_FILE, manifest.load(), limits or {})
    config = copy.deepcopy(cell.config)
    config["sequence"]["shape"] = [s // factor for s in config["sequence"]["shape"]]
    for key in ("fx", "fy", "ox", "oy"):
        config["intrinsics"][key] /= factor
    return cell._replace(config=config)
