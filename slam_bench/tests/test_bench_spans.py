"""The readers of the program's spans (``slam_bench/spans.py`` and the two
``program_span`` metrics): None without spans, the right value on a
hand-made run whose graph spans carry known event times, and a traced run
without the chip that reports the host span and, with no events on the
CPU, not the event metric."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from dvo_slam_tpu_torch.utils import timers
from slam_bench import harness, manifest, spans
from slam_bench.tests.tiny import tiny_cell

CPU = torch.device("cpu")
READERS = ("ingest_host_ms_per_frame.recorded", "irls_graph_ms_per_iteration.recorded")
EVENT_READER = READERS[1]


@pytest.fixture(autouse=True)
def _recorder_off():
    timers.disable()
    yield
    timers.disable()


class _ClockEvent:
    """A completed timing event stamped with the test's device clock (ms)."""

    now = 0.0

    def record(self, stream):
        self.t = _ClockEvent.now

    def since(self, start):
        return self.t - start.t


def _device(ms: float):
    _ClockEvent.now += ms


def _frame_record(k, start, end, levels, traced=False):
    return harness.FrameRecord(k, k, 0, start, start, start + 0.001, end, np.eye(4),
                               {"levels": levels} if levels else {}, traced)


def _run(records):
    cell = manifest.cell("fr1_desk_odometry.recorded")
    run = harness.Run(cell.workload["name"], cell.config, cell.traffic, 1.0, 0.0)
    run.frames = records
    return run


def _record_frame(graph_ms):
    """One frame's spans through the program's recorder, as the program
    records them: the ingest's three parts on the host and, with
    ``graph_ms``, one level's copy-in and out on the host around its graph,
    which has events."""
    frame = next(spans_ids)
    with timers.span("dvo.ingest", frame=frame):
        for part in ("upload", "pyramid", "prepare"):
            with timers.span("dvo.ingest." + part):
                _device(1.0)
    with timers.span("dvo.update", frame=frame):
        if graph_ms:
            with timers.span("dvo.level.copy_in"):
                _device(0.1)
            with timers.span("dvo.level.graph", device=True):
                _device(graph_ms)
            with timers.span("dvo.level.out"):
                _device(0.2)


spans_ids = iter(range(10 ** 6))


def _readers():
    return {name: manifest.metric(name) for name in READERS}


def test_readers_return_none_without_spans():
    readers = _readers()  # arms the recorder; nothing recorded
    run = _run([_frame_record(0, 0.0, 0.01, (3, 2, 1))])
    assert {name: r.read(run) for name, r in readers.items()} == dict.fromkeys(READERS)


def test_readers_of_a_program_without_a_recorder(monkeypatch):
    monkeypatch.delattr(timers, "enable")
    readers = _readers()
    assert not timers.enabled()
    run = _run([_frame_record(0, 0.0, 0.01, (3, 2, 1))])
    assert all(r.read(run) is None for r in readers.values())


def test_readers_on_hand_made_spans(monkeypatch):
    readers = _readers()
    monkeypatch.setattr(timers, "_new_event", _ClockEvent)
    monkeypatch.setattr(timers, "_capturing", lambda: False)
    monkeypatch.setattr(timers, "_stream", lambda device: 0)
    timers.disable()
    timers.enable("cuda")
    _record_frame(5.0)  # warm-up: not a window frame
    _record_frame(0.0)  # the first frame of a pass: no match
    _record_frame(4.0)
    _record_frame(6.0)  # profiled: left out
    _record_frame(8.0)
    run = _run([_frame_record(0, 0.00, 0.01, None), _frame_record(1, 0.01, 0.02, (2, 2)),
                _frame_record(2, 0.02, 0.03, (3, 3), traced=True),
                _frame_record(3, 0.03, 0.05, (4, 4))])
    got = {name: r.read(run) for name, r in readers.items()}
    assert got["irls_graph_ms_per_iteration.recorded"] == pytest.approx((4.0 + 8.0) / (4 + 8))
    assert {name for f in spans.frames(run) for name in f.device_ms} == {"dvo.level.graph"}
    host = [f.host_ms["dvo.ingest"] for f in spans.untraced(run)]
    assert got["ingest_host_ms_per_frame.recorded"] == pytest.approx(np.mean(host))
    assert [f.record.k for f in spans.frames(run)] == [0, 1, 2, 3]
    assert not timers.enabled()  # drained once, then off


def test_a_traced_run_reports_the_program_spans():
    cell = tiny_cell("fr1_desk_odometry.recorded", frames=20, factor=2)
    torch.set_num_threads(2)
    result, _ = harness.run_cell(cell, 2**31 + 101, 3.0, True, CPU, time.time())
    assert result["correct"]
    assert result["metrics"]["ingest_host_ms_per_frame.recorded"]["value"] > 0
    # the CPU records no device events: the event reader finds nothing
    assert EVENT_READER not in result["metrics"], result["metrics"]
    assert not timers.enabled()


def test_an_untraced_run_leaves_the_recorder_off():
    cell = tiny_cell("fr1_desk_odometry.recorded", frames=10, factor=4)
    torch.set_num_threads(2)
    result, _ = harness.run_cell(cell, 2**31 + 103, 1.0, False, CPU, time.time())
    assert result["correct"] and not timers.enabled()
