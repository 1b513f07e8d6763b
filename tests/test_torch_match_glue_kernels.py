"""The glue kernels' CPU side (``ops/match_glue``; the kernels run only on
the card, where ``tests_cuda/test_match_glue_cuda.py`` holds them to the
plain glue).

* The wrappers raise on CPU tensors, on float64 and on wrong shapes, before
  they load any library.
* The choice: a match takes the glue kernels only for CUDA float32 frames
  (``dense_tracker.fused_step_applies``, the step kernels' choice, which
  every match graph's frames meet); CPU
  matches, in float32 and float64, keep the plain glue: ``match_prepared``
  and ``match_prepared_flat`` are bit-equal to a verbatim copy of
  ``_match_per_level`` as it was before the kernels, with no glue kernel
  launched.
* ``match_glue_share.recorded``'s reader on hand-made spans: None without
  the glue kernels, without spans or without a match graph in the window,
  the share of the matched frames whose match graph held the glue kernels
  on the odometry cell's span reader, and the same where ``slam_spans``
  drained the recorder first (the SLAM cell).
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import pytest
import torch

from dvo_slam_tpu_torch import odometry
from dvo_slam_tpu_torch.config import TrackerConfig
from dvo_slam_tpu_torch.models import dense_tracker as dt
from dvo_slam_tpu_torch.models import irls_graph
from dvo_slam_tpu_torch.ops import match_glue, se3
from dvo_slam_tpu_torch.ops.camera import Intrinsics
from dvo_slam_tpu_torch.utils import synthetic, timers
from slam_bench import harness, manifest, slam_spans

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

K = Intrinsics(80.0, 80.0, 39.5, 29.5)
CFG = TrackerConfig(first_level=1, last_level=0, max_iterations_per_level=15, mu=0.05)
METRIC = "match_glue_share.recorded"


@pytest.fixture
def _no_library(monkeypatch):
    monkeypatch.setattr(match_glue, "_library", lambda: pytest.fail("loaded the library"))


@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA device"),
    ("cpu_initial", "CUDA tensor"),
    ("float64", "float32"),
    ("shape", r"\[4, 4\]"),
    ("batch", r"\[2, 4, 4\]"),
    ("empty", "no stream"),
])
def test_the_setup_raises_on_what_it_does_not_take(case, match, _no_library):
    initial, batch, device = torch.eye(4), (), "cuda"
    if case == "cpu":
        device = "cpu"
    elif case == "float64":
        initial = torch.eye(4, dtype=torch.float64)
    elif case == "shape":
        initial = torch.eye(4)[:3]
    elif case == "batch":
        batch = (2,)
    elif case == "empty":
        batch = (0,)
    with pytest.raises(ValueError, match=match):
        match_glue.setup_cuda(initial, batch, device)


def _link_args(batch=(), dtype=torch.float32):
    eye = torch.eye(4, dtype=dtype).expand(batch + (4, 4))
    return [eye, eye, eye, torch.eye(2, dtype=dtype).expand(batch + (2, 2))]


@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA tensor"),
    ("float64", "float32"),
    ("inc_shape", r"\[\.\.\., 4, 4\]"),
    ("precision_shape", r"\[2, 2\]"),
    ("batch", r"\[3, 4, 4\]"),
    ("out_fields", "4 start values"),
])
def test_the_link_raises_on_what_it_does_not_take(case, match, _no_library):
    args, out = _link_args(), None
    if case == "float64":
        args = _link_args(dtype=torch.float64)
    elif case == "inc_shape":
        args[0] = torch.zeros(4)
    elif case == "precision_shape":
        args[3] = torch.eye(3)
    elif case == "batch":
        args = _link_args((3,))
        args[1] = torch.eye(4)
    elif case == "out_fields":
        out = [torch.zeros(6)] * 3
    with pytest.raises(ValueError, match=match):
        match_glue.link_cuda(*args, out=out)


def _result_args(batch=(), dtype=torch.float32, levels=2, pixels=12):
    eye = torch.eye(4, dtype=dtype).expand(batch + (4, 4))
    final = [eye, eye, torch.eye(6, dtype=dtype).expand(batch + (6, 6)),
             torch.zeros(batch, dtype=dtype)]
    counts = tuple(torch.zeros(batch, dtype=torch.int32) for _ in range(3))
    return final, [(counts, torch.ones(batch + (8, pixels), dtype=dtype))
                   for _ in range(levels)]


@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA tensor"),
    ("float64", "float32"),
    ("refpack_rows", r"\[\.\.\., 8, N\]"),
    ("counts_dtype", "int32"),
    ("A_shape", r"\[6, 6\]"),
    ("levels", "1 to 8"),
    ("no_level", "1 to 8"),
    ("out_width", r"\[61\]"),
])
def test_the_result_raises_on_what_it_does_not_take(case, match, _no_library):
    final, levels = _result_args()
    out = None
    if case == "float64":
        final, levels = _result_args(dtype=torch.float64)
    elif case == "refpack_rows":
        levels[1] = (levels[1][0], torch.ones(7, 12))
    elif case == "counts_dtype":
        levels[0] = ((torch.zeros(()),) * 3, levels[0][1])
    elif case == "A_shape":
        final[2] = torch.eye(5)
    elif case == "levels":
        final, levels = _result_args(levels=match_glue.MAX_LEVELS + 1)
    elif case == "no_level":
        levels = []
    elif case == "out_width":
        out = torch.zeros(60)
    with pytest.raises(ValueError, match=match):
        match_glue.result_cuda(final, levels, smoothing=True, mu=0.05, info_scale=1.0, out=out)


def test_the_choice_goes_by_device_and_dtype(monkeypatch):
    """The glue kernels run where the step kernels do (``fused_step_applies``:
    CUDA float32), which holds for every frame that takes a match graph."""
    for dtype in (torch.float32, torch.float64):
        assert not dt.fused_step_applies(torch.zeros(3, 8, 12, dtype=dtype))
    monkeypatch.setattr(irls_graph, "loop_form", lambda device, group=(): ("while", ()))
    for dtype, want in ((torch.float32, True), (torch.float64, False)):
        stand_in = types.SimpleNamespace(is_cuda=True, dtype=dtype, device=torch.device("cuda"))
        assert dt.fused_step_applies(stand_in) is want
        ref = types.SimpleNamespace(refpack={CFG.first_level: stand_in})
        assert dt._takes_match_graph(ref, CFG.first_level) is want


def _match_per_level_before(cfg, intrinsics, ref, cur, initial_transformation=None,
                            collect_iteration_stats=False):
    """``dense_tracker._match_per_level`` as it was before the glue
    kernels, verbatim but for the spans and the card's counter."""
    refpack0 = ref.refpack[cfg.first_level]
    dtype, device = refpack0.dtype, refpack0.device
    batch = tuple(refpack0.shape[:-2])
    initial = (None if initial_transformation is None
               else torch.as_tensor(initial_transformation, device=device).to(dtype))
    x, T, initial, precision = dt.match_start(initial, batch, dtype, device)

    stats = []
    iteration_stats = []
    final = None
    for level in range(cfg.first_level, cfg.last_level - 1, -1):
        final, level_out, trace = dt._match_level(
            cfg,
            intrinsics.at_level(level),
            ref.sel[level],
            ref.refpack[level],
            cur.quad[level],
            x,
            T,
            initial,
            precision,
            collect_stats=collect_iteration_stats,
            accel=cur.accel[level],
        )
        stats.append(level_out)
        if collect_iteration_stats:
            iteration_stats.append(trace)
        x, T, initial, precision = dt.next_start(final)
    return dt.match_result(cfg, final, stats, iteration_stats)


@pytest.fixture(scope="module")
def frames():
    poses = synthetic.circular_trajectory(3, radius=0.05, rot_amplitude=0.02)
    intensity, depth = odometry.render_sequence(poses, (60, 80), K, workers=1)
    d_i, d_d = odometry.upload_sequence(intensity, depth, torch.device("cpu"))
    prepared = [dt.prepare_frame(CFG, K, odometry.build_frame(CFG, d_i[k], d_d[k]))
                for k in range(3)]
    return prepared, poses


def _cast(frame, dtype, streams):
    """A prepared frame in ``dtype`` (the selection masks stay bool), with
    a stream axis of ``streams`` where that is more than one."""
    def one(t):
        if t is None:
            return None
        t = t if t.dtype == torch.bool else t.to(dtype)
        return t if streams == 1 else t.unsqueeze(0).expand((streams,) + t.shape).contiguous()

    return dt.PreparedFrame(*(tuple(one(t) for t in field) for field in frame))


def _bits(t):
    t = torch.as_tensor(t).contiguous()
    if t.is_floating_point():
        t = t.view({4: torch.int32, 8: torch.int64}[t.element_size()])
    return t


def _fields(result):
    out = [result.transformation, result.information, result.neg_log_likelihood]
    out += [f for s in result.level_stats for f in s]
    out += [f for trace in result.iteration_stats for f in trace]
    return out


@pytest.mark.parametrize("smoothing", [True, False])
@pytest.mark.parametrize("warm", [True, False])
@pytest.mark.parametrize("streams", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_matches_keep_the_plain_glue(frames, monkeypatch, dtype, streams, warm, smoothing):
    prepared, poses = frames
    cfg = dataclasses.replace(CFG, mu=0.05 if smoothing else 0.0)
    ref, cur = (_cast(prepared[k], dtype, streams) for k in (0, 1))
    init = None
    if warm:
        pose = np.linalg.inv(poses[0]) @ poses[1]
        init = np.stack([pose] * streams) if streams > 1 else pose
    for name in ("setup_cuda", "link_cuda", "result_cuda"):
        monkeypatch.setattr(match_glue, name, lambda *a, **k: pytest.fail("glue kernel"))
    want = _match_per_level_before(cfg, K, ref, cur, init, collect_iteration_stats=True)
    got = dt.match_prepared(cfg, K, ref, cur, init, collect_iteration_stats=True)
    assert int(sum(s.iterations.min() for s in want.level_stats)) >= 2
    want_fields, got_fields = _fields(want), _fields(got)
    assert len(want_fields) == len(got_fields) == 3 + 4 * 2 + 5 * 2
    for a, b in zip(want_fields, got_fields):
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))
    row = dt.match_prepared_flat(cfg, K, ref, cur, init, host=True)
    assert row.tobytes() == dt.flatten_result(want).numpy().tobytes()


def test_the_glue_counters_stay_on_the_cpu(frames):
    prepared, _ = frames
    before = [w.launches for w in (match_glue.setup_cuda, match_glue.link_cuda,
                                   match_glue.result_cuda)]
    dt.match_prepared(CFG, K, prepared[0], prepared[1], se3.identity())
    assert [w.launches for w in (match_glue.setup_cuda, match_glue.link_cuda,
                                 match_glue.result_cuda)] == before


@pytest.fixture
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


def _record_frame(graph: bool, glue: bool):
    """One frame's ingest, then its update: a match graph (whose glue is
    the glue kernels where ``glue``) or a match level by level."""
    frame = next(_ids)
    with timers.span("dvo.ingest", frame=frame):
        pass
    with timers.span("dvo.update", frame=frame):
        if graph:
            with timers.span("dvo.match.graph"), timers.span("dvo.match.fused_tail"):
                if glue:
                    with timers.span("dvo.match.glue_kernels"):
                        with timers.span("dvo.level.graph"):
                            pass
                else:
                    with timers.span("dvo.level.graph"):
                        pass
        else:
            with timers.span("dvo.level.graph"):
                pass


def _window(frames):
    timers.disable()
    timers.enable("cpu")
    _record_frame(True, True)  # warm-up: not a window frame
    for graph, glue in frames:
        _record_frame(graph, glue)


def _records():
    # frame 2 in the slice and frame 4 failed: frames 0, 1 and 3 count
    return [_frame_record(0), _frame_record(1), _frame_record(2, traced=True), _frame_record(3),
            _frame_record(4, failed=True)]


def test_the_reader_reads_none_without_the_kernels_spans_or_graphs(_recorder_off, monkeypatch):
    reader = manifest.metric(METRIC)  # arms the recorder
    assert reader.read(_run("fr1_desk_odometry.recorded", [_frame_record(0)])) is None
    _window([(False, False)] * 5)
    assert reader.read(_run("fr1_desk_odometry.recorded", _records())) is None
    _window([(True, True)] * 5)
    monkeypatch.setattr(reader, "_has_glue_kernels", lambda: False)
    assert reader.read(_run("fr1_desk_odometry.recorded", _records())) is None


@pytest.mark.parametrize("cell", ["fr1_desk_odometry.recorded", "rig8_lockstep.recorded"])
def test_the_reader_on_hand_made_spans(_recorder_off, cell):
    reader = manifest.metric(METRIC)
    # frames 0, 1, 3 count; frame 1 matched level by level is left out
    _window([(True, True), (False, False), (True, True), (True, False), (True, True)])
    assert reader.read(_run(cell, _records())) == pytest.approx(1 / 2)


def test_the_reader_where_the_slam_spans_drained_the_recorder(_recorder_off):
    reader = manifest.metric(METRIC)
    _window([(True, True), (True, True), (True, False), (True, True), (True, False)])
    run = _run("fr3_office_slam.recorded", _records())
    assert len(slam_spans.frames(run)) == 5 and not timers.enabled()
    assert reader.read(run) == 1.0
