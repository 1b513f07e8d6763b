"""The live SLAM cell's check on the CPU at half size: the front end's
chains and the loop constraints against the plain reference, and the
control far outside the limits."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from slam_bench import control, manifest, traffic
from slam_bench.harness import FrameRecord
from slam_bench.tests.tiny import live_cell

CPU = torch.device("cpu")
LIMITS = {"frontend_gap_t_p90_m": 2e-5, "frontend_gap_r_p90_rad": 2e-5,
          "loop_gap_t_p90_m": 2e-4, "loop_gap_r_p90_rad": 2e-4}


@pytest.fixture(scope="module")
def run():
    torch.set_num_threads(2)
    cell = live_cell(limits=LIMITS)
    rec = traffic.make_recording(cell.config, 30, 2**31 + 5, CPU)
    entry = manifest.entry("keyframe_tracker")
    e = entry.Entry(cell.config, CPU)
    frames = []
    for i in range(30):
        pose = e.update(e.ingest(rec.intensity[i], rec.depth[i], float(rec.stamps[i])))
        frames.append(FrameRecord(i, i, 0, i / 30, 0, 0, 0, pose, e.info()))
    outputs = e.finish()
    return cell, rec, entry, frames, outputs


def test_frontend_answers_match_the_reference(run):
    cell, rec, entry, frames, outputs = run
    # a loop constraint the program never made: the truth between two
    # frames, which the reference's alignment reaches within its tolerance
    truth = np.linalg.inv(rec.poses[3]) @ rec.poses[12]
    outputs = {**outputs, "loops": [(3 / 30, 12 / 30, truth)]}
    checks = entry.judge(cell.config, cell.traffic, LIMITS, rec, frames, outputs, 7, CPU)
    by = {c["name"]: c for c in checks}
    assert set(by) == set(LIMITS)
    assert by["frontend_gap_t_p90_m"]["value"] < 2e-6
    assert by["loop_gap_t_p90_m"]["value"] < 2e-3  # the truth is not the alignment's answer


def test_keyframes_reported(run):
    _, _, entry, frames, outputs = run
    pairs, mine = entry.frontend_pairs(frames, 30.0, 8, 3)
    assert pairs and all(j < k for j, k in pairs)
    assert mine.shape == (len(pairs), 4, 4)
    assert outputs["keyframes"] >= 1


def test_control_fails(run):
    cell = live_cell(limits=LIMITS)
    out = control.slam_control(cell, 5, CPU, pairs=4, seconds=7.0)
    assert out["frontend_gap_t_p90_m"] > LIMITS["frontend_gap_t_p90_m"]
    assert out["loop_gap_t_p90_m"] > LIMITS["loop_gap_t_p90_m"]
