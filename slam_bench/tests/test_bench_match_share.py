"""The reader of ``match_graph_share.recorded``: None without spans or
without a match graph in the program, the share of matched frames outside
the slice whose update ran as a match graph on hand-made spans, and 0 on a
traced run without the chip (the CPU matches level by level)."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from dvo_slam_tpu_torch.models import irls_graph
from dvo_slam_tpu_torch.utils import timers
from slam_bench import harness, manifest
from slam_bench.tests.tiny import tiny_cell

CPU = torch.device("cpu")
NAME = "match_graph_share.recorded"


@pytest.fixture(autouse=True)
def _recorder_off():
    timers.disable()
    yield
    timers.disable()


def _frame_record(k, levels, traced=False):
    return harness.FrameRecord(k, k, 0, 0.01 * k, 0.01 * k, 0.01 * k + 0.001, 0.01 * k + 0.005,
                               np.eye(4), {"levels": levels} if levels else {}, traced)


def _run(records):
    cell = manifest.cell("fr1_desk_odometry.recorded")
    run = harness.Run(cell.workload["name"], cell.config, cell.traffic, 1.0, 0.0)
    run.frames = records
    return run


_ids = iter(range(10 ** 6))


def _record_frame(graph: bool):
    """One frame's ingest, then an update that ran as a match graph or
    level by level."""
    frame = next(_ids)
    with timers.span("dvo.ingest", frame=frame):
        pass
    with timers.span("dvo.update", frame=frame):
        with timers.span("dvo.level.copy_in"):
            pass
        if graph:
            with timers.span("dvo.match.graph"):
                pass
        else:
            with timers.span("dvo.level.graph"):
                pass


def test_none_without_spans_or_match_graphs(monkeypatch):
    reader = manifest.metric(NAME)  # arms the recorder
    assert reader.read(_run([_frame_record(0, (3, 2, 1))])) is None
    _record_frame(True)
    stats = irls_graph.stats
    monkeypatch.setattr(irls_graph, "stats", lambda: {
        k: v for k, v in stats().items() if k != "match_graph_launches"})
    assert reader.read(_run([_frame_record(0, (3, 2, 1))])) is None


def test_share_on_hand_made_spans():
    reader = manifest.metric(NAME)
    timers.disable()
    timers.enable("cpu")
    _record_frame(True)  # warm-up: not a window frame
    for graph in (False, True, True, True, False):
        _record_frame(graph)
    run = _run([_frame_record(0, None),  # the first frame of a pass: no match
                _frame_record(1, (2, 2)), _frame_record(2, (3, 3), traced=True),
                _frame_record(3, (2, 2)), _frame_record(4, (2, 1))])
    # outside the slice and matched: frames 1 (a match graph), 3 (one), 4 (level by level)
    assert reader.read(run) == pytest.approx(2 / 3)


def test_a_traced_run_on_the_cpu_reads_zero():
    cell = tiny_cell("fr1_desk_odometry.recorded", frames=20, factor=4)
    torch.set_num_threads(2)
    result, _ = harness.run_cell(cell, 2**31 + 107, 2.0, True, CPU, time.time())
    assert result["correct"]
    assert result["metrics"][NAME]["value"] == 0.0
