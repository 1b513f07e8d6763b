"""The reader of ``ingest_kernel_share.recorded``: None without the
program's ingest kernels or without spans, the share of the frames outside
the slice whose ingest holds a ``dvo.ingest.kernel`` span on hand-made
spans, and the same share where ``slam_spans`` drained the recorder first
(the SLAM cell's readers come before it)."""

from __future__ import annotations

import numpy as np
import pytest

from dvo_slam_tpu_torch.utils import timers
from slam_bench import harness, manifest, slam_spans

NAME = "ingest_kernel_share.recorded"


@pytest.fixture(autouse=True)
def _recorder_off():
    timers.disable()
    yield
    timers.disable()


def _frame_record(k, traced=False, failed=False):
    return harness.FrameRecord(k, k, 0, 0.01 * k, 0.01 * k, 0.01 * k + 0.001, 0.01 * k + 0.005,
                               None if failed else np.eye(4), {}, traced)


def _run(name, records):
    cell = manifest.cell(name)
    run = harness.Run(cell.workload["name"], cell.config, cell.traffic, 1.0, 0.0)
    run.frames = records
    return run


_ids = iter(range(10 ** 6))


def _record_frame(kernel: bool):
    """One frame's ingest through the kernels or the plain chain, then its
    update."""
    frame = next(_ids)
    with timers.span("dvo.ingest", frame=frame):
        for child in (("dvo.ingest.stage", "dvo.ingest.kernel") if kernel else
                      ("dvo.ingest.upload", "dvo.ingest.pyramid", "dvo.ingest.prepare")):
            with timers.span(child):
                pass
    with timers.span("dvo.update", frame=frame):
        pass


def _window(kernels):
    timers.disable()
    timers.enable("cpu")
    _record_frame(True)  # warm-up: not a window frame
    for kernel in kernels:
        _record_frame(kernel)


def test_none_without_kernels_or_spans(monkeypatch):
    reader = manifest.metric(NAME)  # arms the recorder
    assert reader.read(_run("fr1_desk_odometry.recorded", [_frame_record(0)])) is None
    _window([True, True])
    monkeypatch.setattr(reader, "_has_ingest_kernels", lambda: False)
    assert reader.read(_run("fr1_desk_odometry.recorded",
                            [_frame_record(0), _frame_record(1)])) is None


def _records():
    # frame 2 in the slice and frame 4 failed: frames 0, 1 and 3 count
    return [_frame_record(0), _frame_record(1), _frame_record(2, traced=True), _frame_record(3),
            _frame_record(4, failed=True)]


def test_share_on_hand_made_spans():
    reader = manifest.metric(NAME)
    _window([True, False, False, True, False])
    assert reader.read(_run("fr1_desk_odometry.recorded", _records())) == pytest.approx(2 / 3)


def test_share_where_the_slam_spans_drained_the_recorder():
    reader = manifest.metric(NAME)
    _window([True, True, False, True, True])
    run = _run("fr3_office_slam.recorded", _records())
    assert len(slam_spans.frames(run)) == 5 and not timers.enabled()
    assert reader.read(run) == 1.0
