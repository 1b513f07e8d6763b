"""The keyframe-session cell (``fr3_office_slam.recorded``) driven without the
chip at a quarter of its size: a sound traced run is correct and its
program-span and counter readers read it; the map check fails a map with
one vertex moved by 1 mm, a session whose final pass is skipped and a
pass that prunes an edge the reference's pass keeps; the readers give None where their spans or counts are missing, and the
batched roofline reader weighs a hand-made trace by its batches."""

from __future__ import annotations

import copy
import time

import numpy as np
import pytest
import torch

from dvo_slam_tpu_torch.models.keyframe_graph import KeyframeGraph
from dvo_slam_tpu_torch.utils import timers
from slam_bench import harness, manifest, roofline, roofline_batched, trace
from slam_bench.tests.tiny import tiny_cell

CPU = torch.device("cpu")
CELL = "fr3_office_slam.recorded"
READERS = ("slam_update_ms_per_frame.recorded", "backend_ms_per_keyframe.recorded",
           "candidates_per_keyframe.recorded", "final_map_ms_per_session.recorded")
ROOFLINE = "fused_stats_batched_roofline_pct.recorded"
MAP_CHECKS = ("map_gap_t_max_m", "map_prune_mismatches")


def _cell():
    """24 frames at 120x160 on a 32-frame lap: a few keyframes a session and
    a loop constraint."""
    cell = tiny_cell(CELL, frames=24, factor=4, trace_frames=10)
    config = copy.deepcopy(cell.config)
    config["loop"]["lap_frames"] = 32
    return cell._replace(config=config)


def _drive(monkeypatch, tracing=False, seconds=15.0, seed=2**31 + 21):
    """A run of the tiny cell; returns (result, checks, the check's inputs)."""
    seen = {}
    load = manifest.entry

    def entry(name):
        module = load(name)
        judge = module.judge

        def keep(*args):
            seen["args"] = args
            return judge(*args)

        module.judge = keep
        return module

    monkeypatch.setattr(manifest, "entry", entry)
    torch.set_num_threads(2)
    result, checks = harness.run_cell(_cell(), seed, seconds, tracing, CPU, time.time())
    return result, checks, seen["args"]


@pytest.fixture(scope="module")
def sound():
    with pytest.MonkeyPatch.context() as mp:
        yield _drive(mp, tracing=True)
    timers.disable()


def test_a_sound_traced_run_is_correct_and_read(sound):
    result, checks, _ = sound
    assert result["correct"], checks
    assert result["failed"] == 0
    names = [c["name"] for c in checks]
    assert names == ["frontend_gap_t_p90_m", "frontend_gap_r_p90_rad", "loop_gap_t_p90_m",
                     "loop_gap_r_p90_rad", *MAP_CHECKS]
    for name in READERS:
        assert result["metrics"][name]["value"] > 0, (name, result["metrics"])
    assert ROOFLINE not in result["metrics"]  # the CPU launches no kernel
    assert not timers.enabled()


def _judge(args, outputs):
    config, traffic, limits, rec, frames, _, seed, device = args
    return {c["name"]: c for c in
            manifest.entry("keyframe_sessions").judge(config, traffic, limits, rec, frames,
                                                      outputs, seed, device)}


def test_a_vertex_moved_by_a_millimetre_fails_the_map(sound):
    args = sound[2]
    outputs = args[5]
    m = outputs["map"]
    assert all(c["value"] <= c["limit"] for c in _judge(args, outputs).values())
    poses = m.poses.copy()
    k = len(poses) // 2
    poses[k, 0, 3] += 1e-3
    checks = _judge(args, {**outputs, "map": m._replace(poses=poses)})
    failed = [name for name in MAP_CHECKS if checks[name]["value"] > checks[name]["limit"]]
    assert "map_gap_t_max_m" in failed, checks


def test_a_skipped_final_pass_is_not_correct(monkeypatch):
    def skipped(self, frame=None):
        self.wait_for_queue()

    monkeypatch.setattr(KeyframeGraph, "final_optimization", skipped)
    result, checks, _ = _drive(monkeypatch, seed=2**31 + 23)
    assert not result["correct"]
    by = {c["name"]: c for c in checks}
    assert by["map_gap_t_max_m"]["value"] > by["map_gap_t_max_m"]["limit"], checks


def test_an_edge_pruned_against_the_reference_fails_the_map(sound):
    """The sound pass prunes as the reference's pass does; pruning one more
    robust edge (and leaving the map where it was) is a mismatch."""
    args = sound[2]
    outputs = args[5]
    m = outputs["map"]
    checks = _judge(args, outputs)
    assert checks["map_prune_mismatches"]["value"] == 0, checks
    kept = m.kept.copy()
    kept[np.nonzero(m.robust & m.kept)[0][0]] = False
    checks = _judge(args, {**outputs, "map": m._replace(kept=kept)})
    assert checks["map_prune_mismatches"]["value"] > checks["map_prune_mismatches"]["limit"]


def _run(frames=()):
    cell = manifest.cell(CELL)
    run = harness.Run(CELL, cell.config, cell.traffic, 1.0, 0.0)
    run.frames = list(frames)
    return run


def test_readers_return_none_without_spans_or_counts():
    timers.disable()
    readers = {name: manifest.metric(name) for name in READERS + (ROOFLINE,)}  # arms
    record = harness.FrameRecord(0, 0, 0, 0.0, 0.0, 0.001, 0.01, np.eye(4), {}, False)
    run = _run([record])
    assert {name: r.read(run) for name, r in readers.items()} == dict.fromkeys(readers)
    timers.disable()


def test_batched_roofline_weighs_the_counted_batches():
    reader = manifest.metric(ROOFLINE)
    run = _run()
    shape = run.config["sequence"]["shape"]
    # two gram and two loglik launches of 10 us each in the slice: 20 us an evaluation
    names = ["void gram_kernel<Tile, 1, 1>(Args)", "void loglik_kernel<Tile, false>(Args)"]
    run.trace = trace.Trace(device=[trace.Event(n, 100.0 * k + 10.0 * j, 100.0 * k + 10.0 * j + 10)
                                    for k in range(2) for j, n in enumerate(names)],
                            host=[], window=(0.0, 1000.0))
    run.counters = {"before": {"evaluations": {(3, 2, 2, 1): 5}},
                    "after": {"evaluations": {(3, 2, 2, 1): 8, (1, 16, 9, 0): 1}}}
    bound = (3 * roofline_batched.evaluation_bound_s(*roofline.level_shape(shape, 3), 2, 2, 1)
             + roofline_batched.evaluation_bound_s(*roofline.level_shape(shape, 1), 16, 9, 0)) / 4
    assert reader.read(run) == pytest.approx(100.0 * bound / 20e-6)
    # one stream reads roofline.py's evaluation; a dual match 14 images, a pair 12
    assert roofline_batched.evaluation_bytes(60, 80, 1, 1, 1) == roofline.evaluation_bytes(60, 80)
    assert roofline_batched.evaluation_bytes(60, 80, 2, 2, 1) == 4 * (14 * 4800 + 2 * 42)
    assert roofline_batched.evaluation_bytes(60, 80, 2, 2, 0) == 4 * (12 * 4800 + 2 * 42)
    run.counters = {"before": {}, "after": {}}
    assert reader.read(run) is None
