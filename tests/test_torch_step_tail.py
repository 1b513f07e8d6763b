"""The IRLS step kernels' CPU side (``ops/irls_step``; the kernels run only
on the card, where ``tests_cuda/test_step_tail_cuda.py`` holds them to the
plain step).

* The wrappers raise on CPU tensors, on float64 and on wrong shapes, before
  they load any library.
* The choice: a tracker level's steps take the step kernels only for CUDA
  float32 carries (``dense_tracker.fused_step_applies``); CPU carries, in
  float32 and float64, keep the plain ``_step``: a level's program is
  bit-equal to ``_chunk``'s plain steps from the initial carry, with no
  step kernel launched.
* ``step_tail_share.recorded``'s reader on hand-made spans: None without
  the step kernels, without spans or without a match graph in the window,
  the share of the matched frames whose match graph held the step kernels
  on the odometry cell's span reader, and the same where ``slam_spans``
  drained the recorder first (the SLAM cell).
"""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from dvo_slam_tpu_torch import odometry
from dvo_slam_tpu_torch.config import TrackerConfig
from dvo_slam_tpu_torch.models import dense_tracker as dt
from dvo_slam_tpu_torch.models import irls_graph
from dvo_slam_tpu_torch.ops import irls_step, se3
from dvo_slam_tpu_torch.ops.camera import Intrinsics
from dvo_slam_tpu_torch.utils import synthetic, timers
from slam_bench import harness, manifest, slam_spans

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

K = Intrinsics(80.0, 80.0, 39.5, 29.5)
CFG = TrackerConfig(first_level=1, last_level=0, max_iterations_per_level=15, mu=0.05)
METRIC = "step_tail_share.recorded"


def _head_args(batch=(), dtype=torch.float32):
    eye = torch.eye(4, dtype=dtype).expand(batch + (4, 4))
    return torch.zeros(batch + (6,), dtype=dtype), eye, eye


@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA tensor"),
    ("float64", "float32"),
    ("x_shape", r"\[\.\.\., 6\]"),
    ("T_shape", r"\[4, 4\]"),
    ("batch", r"\[2, 4, 4\]"),
])
def test_the_head_raises_on_what_it_does_not_take(case, match, monkeypatch):
    monkeypatch.setattr(irls_step, "_library", lambda: pytest.fail("loaded the library"))
    x, T, initial = _head_args((2,) if case == "batch" else ())
    if case == "float64":
        x, T, initial = _head_args(dtype=torch.float64)
    elif case == "x_shape":
        x = torch.zeros(5)
    elif case == "T_shape":
        T = torch.eye(4)[:3]
    elif case == "batch":
        T = torch.eye(4)
    with pytest.raises(ValueError, match=match):
        irls_step.step_head_cuda(x, T, initial)


def _carry(batch=(), dtype=torch.float32):
    start = dt.match_start(None, batch, dtype, torch.device("cpu"))
    return dt._Carry(*(t.contiguous() for t in dt._initial_carry(
        *start, dt._constants(CFG, start[0]))))


def _evaluation(batch=(), dtype=torch.float32):
    return (torch.full(batch, 100, dtype=torch.int32), torch.eye(2, dtype=dtype).expand(
        batch + (2, 2)), torch.zeros(batch, dtype=dtype), torch.eye(6, dtype=dtype).expand(
        batch + (6, 6)), torch.zeros(batch + (6,), dtype=dtype))


@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA tensor"),
    ("float64", "float32"),
    ("A_shape", r"\[6, 6\]"),
    ("n_dtype", "int32"),
    ("carry_fields", "12 fields"),
    ("trace_shape", r"\[15, 2, 6\]"),
])
def test_the_tail_raises_on_what_it_does_not_take(case, match, monkeypatch):
    monkeypatch.setattr(irls_step, "_library", lambda: pytest.fail("loaded the library"))
    batch = (2,) if case == "trace_shape" else ()
    dtype = torch.float64 if case == "float64" else torch.float32
    carry, evaluation = _carry(batch, dtype), list(_evaluation(batch, dtype))
    head = [torch.eye(4, dtype=dtype).expand(batch + (4, 4)).contiguous() for _ in range(3)]
    trace = None
    if case == "A_shape":
        evaluation[3] = torch.eye(5)
    elif case == "n_dtype":
        evaluation[0] = torch.full((), 100.0)
    elif case == "carry_fields":
        carry = tuple(carry)[:-1]
    elif case == "trace_shape":
        trace = [t.contiguous() for t in dt._empty_trace(CFG, carry.x)]
        trace[3] = torch.zeros(CFG.max_iterations_per_level, 2, 5)
    with pytest.raises(ValueError, match=match):
        irls_step.step_tail_cuda(evaluation, head, carry, carry, trace, freeze=True,
                                 smoothing=True, mu=0.05, precision=1e-4,
                                 max_iterations=CFG.max_iterations_per_level)


def test_the_choice_goes_by_device_and_dtype():
    for dtype in (torch.float32, torch.float64):
        assert not dt.fused_step_applies(_carry((3,), dtype).x)
    for dtype, want in ((torch.float32, True), (torch.float64, False)):
        stand_in = types.SimpleNamespace(is_cuda=True, dtype=dtype)
        assert dt.fused_step_applies(stand_in) is want


@pytest.fixture(scope="module")
def level():
    poses = synthetic.circular_trajectory(3, radius=0.05, rot_amplitude=0.02)
    intensity, depth = odometry.render_sequence(poses, (60, 80), K, workers=1)
    d_i, d_d = odometry.upload_sequence(intensity, depth, torch.device("cpu"))
    ref, cur = (dt.prepare_frame(CFG, K, odometry.build_frame(CFG, d_i[k], d_d[k]))
                for k in range(2))
    return ref.refpack[0], cur.quad[0], tuple(ref.sel[0].shape)


def _bits(t):
    t = t.contiguous()
    if t.is_floating_point():
        t = t.view({4: torch.int32, 8: torch.int64}[t.element_size()])
    return t


@pytest.mark.parametrize("chunk", [1, 2])
@pytest.mark.parametrize("streams", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_chunks_keep_the_plain_step(level, dtype, streams, chunk, monkeypatch):
    refpack, quad, shape = level
    batch = () if streams == 1 else (streams,)
    widen = ((lambda t: t.to(dtype)) if streams == 1 else
             (lambda t: t.to(dtype).unsqueeze(0).expand((streams,) + t.shape).contiguous()))
    evaluate = dt._evaluation(CFG, "fused", K.at_level(0), shape, (widen(refpack), widen(quad)))
    twist = torch.tensor([0.004, -0.003, 0.002, 0.003, -0.002, 0.001], dtype=dtype)
    scale = torch.linspace(0.5, 1.5, streams, dtype=dtype).reshape(batch + (1,))
    start = dt.match_start(se3.exp_se3(twist * scale if batch else twist), batch, dtype,
                           torch.device("cpu"))
    before = (irls_step.step_head_cuda.launches, irls_step.step_tail_cuda.launches)
    # the plain loop: ``_chunk``'s plain steps from the initial carry until done
    consts = dt._constants(CFG, start[0])
    carry, trace = dt._initial_carry(*start, consts), dt._empty_trace(CFG, start[0])
    first = True
    while first or not dt.read_done(carry):
        carry, trace = dt._chunk(CFG, evaluate, carry, trace, chunk, first, consts)
        first = False
    plain = tuple(carry) + tuple(trace)
    # the level's program, which chooses its step by what the carry is
    monkeypatch.setattr(dt, "_fused_step", lambda *a, **k: pytest.fail("step kernels"))
    program = dt._level_program(CFG, lambda static: evaluate, 0, True, chunk)
    chosen = irls_graph.run_loop("eager", program, start, None, dt._DONE, dt.read_done)
    assert int(dt._Carry(*plain[:dt._CARRY_FIELDS]).iteration.min()) >= 2
    assert len(plain) == len(chosen)
    for a, b in zip(plain, chosen):
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))
    assert (irls_step.step_head_cuda.launches, irls_step.step_tail_cuda.launches) == before


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


def _record_frame(graph: bool, fused: bool):
    """One frame's ingest, then its update: a match graph (with the step
    kernels where ``fused``) or a match level by level."""
    frame = next(_ids)
    with timers.span("dvo.ingest", frame=frame):
        pass
    with timers.span("dvo.update", frame=frame):
        if graph:
            with timers.span("dvo.match.graph"):
                if fused:
                    with timers.span("dvo.match.fused_tail"):
                        with timers.span("dvo.level.graph"):
                            pass
        else:
            with timers.span("dvo.level.graph"):
                pass


def _window(frames):
    timers.disable()
    timers.enable("cpu")
    _record_frame(True, True)  # warm-up: not a window frame
    for graph, fused in frames:
        _record_frame(graph, fused)


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
    monkeypatch.setattr(reader, "_has_step_kernels", lambda: False)
    assert reader.read(_run("fr1_desk_odometry.recorded", _records())) is None


def test_the_reader_on_hand_made_spans(_recorder_off):
    reader = manifest.metric(METRIC)
    # frames 0, 1, 3 count; frame 1 matched level by level is left out
    _window([(True, True), (False, False), (True, True), (True, False), (True, True)])
    assert reader.read(_run("fr1_desk_odometry.recorded", _records())) == pytest.approx(1 / 2)


def test_the_reader_where_the_slam_spans_drained_the_recorder(_recorder_off):
    reader = manifest.metric(METRIC)
    _window([(True, True), (True, True), (True, False), (True, True), (True, False)])
    run = _run("fr3_office_slam.recorded", _records())
    assert len(slam_spans.frames(run)) == 5 and not timers.enabled()
    assert reader.read(run) == 1.0
