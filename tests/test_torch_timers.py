"""The port's phase timers and span recorder (``utils/timers``), on the CPU.

Off, a span is one shared null context: no event, nothing recorded.  On,
the odometry path's spans nest under their layer's span, one frame's ingest
and update share its ``frame_id``, and no span opens a profiler
annotation.  Device events are stood in for by a fake event whose
completion the test sets: ``drain`` returns what has completed, keeps the
rest, pools the events and never synchronises.  ``PhaseTimers.timing``
fills its summary and records no span.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from dvo_slam_tpu_torch.config import TrackerConfig
from dvo_slam_tpu_torch.models.camera_tracker import CameraTracker
from dvo_slam_tpu_torch.models.frames import Frame
from dvo_slam_tpu_torch.ops.camera import Intrinsics
from dvo_slam_tpu_torch.utils import synthetic, timers
from dvo_slam_tpu_torch.utils.timers import PhaseTimers, Stopwatch

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

K = Intrinsics(80.0, 80.0, 39.5, 29.5)
SHAPE = (60, 80)
CFG = TrackerConfig(first_level=1, last_level=0, max_iterations_per_level=20, precision=1e-4,
                    use_initial_estimate=True)


@pytest.fixture(autouse=True)
def _recorder_off():
    timers.disable()
    yield
    timers.disable()


def _raw_frames(n):
    poses = synthetic.circular_trajectory(n, radius=0.03)
    out = []
    for i, pose in enumerate(poses):
        i_, d_, v_ = synthetic.render_frame(pose, K, SHAPE, seed=i, depth_noise=0.002,
                                            intensity_noise=1.0)
        out.append((np.clip(i_, 0, 255).astype(np.uint8),
                    np.where(v_, d_ * 5000, 0).astype(np.uint16)))
    return out


def _track(n=3):
    tracker = CameraTracker(K, CFG, device="cpu")
    frames = []
    for i, (iu8, du16) in enumerate(_raw_frames(n)):
        frame = tracker.make_frame_raw(iu8, du16, i / 30.0)
        tracker.update(frame)
        frames.append(frame)
    return tracker, frames


class _FakeEvent:
    """A timing event whose completion the test decides."""

    made = 0

    def __init__(self):
        _FakeEvent.made += 1
        self.done = False

    def record(self, stream):
        assert stream == "stream"

    def since(self, start):
        return 0.25 if self.done and start.done else None


@pytest.fixture
def fake_card(monkeypatch):
    """The recorder on a CUDA device with fake events; synchronising raises."""
    _FakeEvent.made = 0
    monkeypatch.setattr(timers, "_new_event", _FakeEvent)
    monkeypatch.setattr(timers, "_capturing", lambda: False)
    monkeypatch.setattr(timers, "_stream", lambda device: "stream")

    def no_sync(*args, **kwargs):
        raise AssertionError("the recorder synchronised")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    monkeypatch.setattr(torch.cuda.Event, "synchronize", no_sync, raising=False)
    timers.enable("cuda")


def test_off_records_nothing(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("recorded while off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(timers, "_new_event", refuse)
    assert not timers.enabled()
    assert timers.span("dvo.x", device=True) is timers.span("dvo.y") is timers._NULL
    _track(3)
    assert timers.drain() == []
    assert not timers._recorder._pending and not timers._recorder._pool


def test_spans_nest_and_share_the_frame():
    timers.enable("cpu")
    _, frames = _track(3)
    spans = timers.drain()
    assert all(s.name.startswith("dvo.") for s in spans)
    assert all(s.device_ms is None for s in spans)  # no events on the CPU
    parents = {}
    for s in spans:
        parents.setdefault(s.name, set()).add(s.parent)
    assert parents == {
        "dvo.ingest": {None}, "dvo.update": {None},
        **{child: {"dvo.ingest"} for child in ("dvo.ingest.upload", "dvo.ingest.pyramid",
                                                "dvo.ingest.prepare")},
        **{child: {"dvo.update"} for child in ("dvo.match.setup", "dvo.level.out",
                                                "dvo.match.result")},
    }
    ids = [f.frame_id for f in frames]
    assert ids == sorted(set(ids))
    for f in frames:
        mine = [s for s in spans if s.frame == f.frame_id]
        names = {s.name for s in mine}
        assert {"dvo.ingest", "dvo.ingest.upload", "dvo.ingest.pyramid", "dvo.ingest.prepare",
                "dvo.update"} <= names
        if f is not frames[0]:  # the first frame becomes the reference: no match
            assert {"dvo.match.setup", "dvo.level.out", "dvo.match.result"} <= names
            # one level.out after each level in _match_level and in match_prepared
            levels = CFG.first_level - CFG.last_level + 1
            assert sum(s.name == "dvo.level.out" for s in mine) == 2 * levels
        ingest = next(s for s in mine if s.name == "dvo.ingest")
        update = next(s for s in mine if s.name == "dvo.update")
        assert ingest.end_ns <= update.start_ns
        for s in mine:
            if s is ingest or s is update:
                continue
            outer = ingest if s.name.startswith("dvo.ingest.") else update
            assert outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns
    assert timers.drain() == []


def test_frames_carry_increasing_identifiers():
    (iu8, du16), = _raw_frames(1)
    a = Frame.from_raw(iu8, du16, 0.0, 2, device="cpu")
    b = Frame.from_raw(iu8, du16, 0.0, 2, device="cpu")
    c = Frame(levels=a.levels, timestamp=0.0)
    assert a.frame_id < b.frame_id < c.frame_id


def test_drain_never_synchronises_and_keeps_unfinished(fake_card):
    with timers.span("dvo.update", frame=7):
        with timers.span("dvo.level.graph", device=True):
            pass
        with timers.span("dvo.level.out", device=True):
            pass
    rec = timers._recorder
    (_, (_, graph_end)), (_, (_, out_end)) = rec._pending
    got = timers.drain()
    assert [s.name for s in got] == ["dvo.update"]  # host-only: finished
    assert len(rec._pending) == 2
    graph_end.done = True
    rec._pending[0][1][0].done = True
    got = timers.drain()
    assert [(s.name, s.frame, s.device_ms) for s in got] == [("dvo.level.graph", 7, 0.25)]
    assert len(rec._pending) == 1 and len(rec._pool) == 2
    for ev in rec._pending[0][1]:
        ev.done = True
    assert [s.name for s in timers.drain()] == ["dvo.level.out"]
    made = _FakeEvent.made
    with timers.span("dvo.ingest.upload", device=True):
        pass
    assert _FakeEvent.made == made  # the pair came from the pool


def test_no_events_while_capturing(fake_card, monkeypatch):
    monkeypatch.setattr(timers, "_capturing", lambda: True)
    with timers.span("dvo.level.graph", device=True):
        pass
    (s,) = timers.drain()
    assert s.device_ms is None and _FakeEvent.made == 0


def test_a_root_span_pools_completed_events(fake_card):
    for _ in range(50):
        with timers.span("dvo.update"):
            with timers.span("dvo.level.graph", device=True):
                pass
        for _, events in timers._recorder._pending:
            for ev in events:
                ev.done = True
    assert _FakeEvent.made == 2  # one pair, pooled at each root span
    assert sum(s.name == "dvo.level.graph" for s in timers.drain()) == 50


def test_spans_open_no_profiler_annotation(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span opened a profiler annotation")

    timers.enable("cpu")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with timers.span("dvo.update"):
            with timers.span("dvo.level.out"):
                torch.ones(4).sum()
    assert not {"dvo.update", "dvo.level.out"} & {e.key for e in prof.key_averages()}
    assert [s.name for s in timers.drain()] == ["dvo.level.out", "dvo.update"]


def test_phase_timers_fill_the_summary_and_record_no_span():
    pt = PhaseTimers()
    timers.enable("cpu")
    with pt.timing("match") as watch:
        with pt.timing("constraint_search"):
            pass
    assert isinstance(watch, Stopwatch)
    s = pt.summary()
    assert s["match"]["count"] == 1 and s["constraint_search"]["count"] == 1
    assert timers.drain() == []


def test_threads_keep_their_own_parents():
    """Eight threads record nested spans at a short switch interval: every
    span is kept, each under its own thread's parent."""
    timers.enable("cpu")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for _ in range(200):
                with timers.span(f"dvo.t{k}", frame=k):
                    with timers.span(f"dvo.t{k}.child"):
                        pass

        threads = [threading.Thread(target=work, args=(k,)) for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    spans = timers.drain()
    assert len(spans) == 8 * 200 * 2
    for s in spans:
        k = int(s.name.split(".")[1][1:])
        assert s.frame == k
        assert s.parent == (f"dvo.t{k}" if s.name.endswith(".child") else None)

