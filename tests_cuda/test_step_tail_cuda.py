"""The IRLS step kernels on the card (``ops/irls_step``: ``csrc/fused_stats.cu``'s
step head and tail), against the plain ``dense_tracker._step`` run on the
card.

A step from the same carry, once through ``_chunk`` as the plain step and
once through the step kernels (in place of a copy of the carry):

  * on a 640x480 pair at levels 3 and 1, the first step (also from the
    level's start values, the tail making the initial carry) and the next
    ones, with ``use_estimate_smoothing`` on and off, at B = 1, 2 and 16
    (kernel 1 evaluating each trial pose);
  * on hand-made evaluations, one for each termination code (too few
    constraints, log-likelihood decreased, increment too small, iterations
    exceeded, none) and one whose A holds a NaN, with smoothing on and off;

the integers and flags (n, iteration, termination, done) are equal, every
float field and trace row is bit-equal or within ``GAP_ULPS`` ulps of the
field's largest magnitude (the kernels' fixed order of the small products
and Cholesky sums against cuBLAS's, which differs with B), NaNs where the
plain step has them.  Stream b of a B-stream call is bit-equal to its
one-stream call, a done stream's carry stays as it was, and a tracker
level's tail capture holds at most four kernel nodes and one copy (the
while graph's ``set_while`` the fifth kernel).
"""

import dataclasses

import numpy as np
import pytest
import torch

from dvo_slam_tpu_torch import benchmark_config, odometry
from dvo_slam_tpu_torch.models import dense_tracker as dt
from dvo_slam_tpu_torch.models import irls_graph
from dvo_slam_tpu_torch.ops import irls_step, se3
from dvo_slam_tpu_torch.ops.camera import TUM_FR1
from dvo_slam_tpu_torch.tools import graph_check
from dvo_slam_tpu_torch.utils import synthetic

pytestmark = pytest.mark.cuda

CFG = benchmark_config().tracker
SMOOTHING = {"smoothing": True, "no_smoothing": False}
STREAMS = (1, 2, 16)
WALK = 4  # steps walked on each level
# the largest gap of a float field to the plain step's, in ulps of the
# field's largest magnitude: 13 seen (x, whose Cholesky sums part from
# cuBLAS's order), 2 in A and the precision (kernel 1 at a trial pose a few
# thousandths of an ulp away), 1 in the log-likelihood (PERF.md)
GAP_ULPS = 32
GAPS = {}  # the largest gap seen of each field, printed at the end


@pytest.fixture(scope="module")
def frames():
    poses = synthetic.circular_trajectory(3, radius=0.05, rot_amplitude=0.02)
    intensity, depth = odometry.render_sequence(poses, (480, 640), TUM_FR1, workers=4)
    d_i, d_d = odometry.upload_sequence(intensity, depth, torch.device("cuda"))
    return [dt.prepare_frame(CFG, TUM_FR1, odometry.build_frame(CFG, d_i[k], d_d[k]))
            for k in range(2)]


@pytest.fixture(scope="module", autouse=True)
def _report():
    yield
    print("\nstep kernels against the plain step, largest gap (ulps of the field's scale):",
          {k: v for k, v in sorted(GAPS.items())})


def _cfg(smoothing):
    """The tracker with the prior's weight the reference's benchmark gives it, or none."""
    return dataclasses.replace(CFG, mu=0.05 if smoothing else 0.0)


def _level(frames, level, streams):
    """(evaluate, start values) of one level of the pair at B = ``streams``
    (the pair repeated; the warm start parts by stream)."""
    ref, cur = frames
    batch = () if streams == 1 else (streams,)

    def widen(t):
        return t if streams == 1 else t.unsqueeze(0).expand((streams,) + t.shape).contiguous()

    inputs = (widen(ref.refpack[level]), widen(cur.quad[level]))
    shape = tuple(ref.sel[level].shape[-2:])
    evaluate = dt._evaluation(CFG, "pallas", TUM_FR1.at_level(level), shape, inputs)
    twist = torch.tensor([0.004, -0.003, 0.002, 0.003, -0.002, 0.001], device="cuda")
    scale = torch.linspace(0.5, 1.5, streams, device="cuda").reshape(batch + (1,))
    guess = se3.exp_se3(twist * scale if batch else twist)
    return evaluate, dt.match_start(guess, batch, torch.float32, torch.device("cuda"))


def _owned(carry):
    return dt._Carry(*(t.contiguous().clone() for t in carry))


def _one_step(cfg, evaluate, carry, first, kind, trace=None, start=None):
    """One step of ``_chunk`` from a copy of ``carry``: "plain", or the
    step kernels in place of the copy ("kernels") or from the level's start
    values ``start`` (``carry`` their initial carry) into new buffers
    ("start")."""
    consts = dt._constants(cfg, carry.x)
    trace = None if trace is None else dt.IterationStats(*(t.clone() for t in trace))
    if kind == "plain":
        out, trace = dt._chunk(cfg, evaluate, _owned(carry), trace, 1, first, consts)
    elif kind == "start":
        out, trace = dt._chunk(cfg, evaluate, None, trace, 1, first, None, fused=True,
                               start=start)
    else:
        out, trace = dt._chunk(cfg, evaluate, _owned(carry), trace, 1, first, None, fused=True)
    torch.cuda.synchronize()
    return out, trace


def _gap_ulps(a, b) -> float:
    """The largest |a - b| in ulps of the larger of the two's largest
    finite magnitudes (0 where equal; NaNs and infinities must sit alike)."""
    a, b = a.double().cpu(), b.double().cpu()
    finite = torch.isfinite(a)
    assert torch.equal(finite, torch.isfinite(b)), "NaNs or infinities part"
    assert torch.equal(a[~finite].nan_to_num(), b[~finite].nan_to_num()), "infinities part"
    a, b = a[finite], b[finite]
    if torch.equal(a, b):
        return 0.0
    scale = max(float(a.abs().max()), float(b.abs().max()))
    ulp = float(np.spacing(np.float32(scale)))
    return float((a - b).abs().max()) / ulp


def _compare(got, want, what):
    """Integers and flags equal, floats within GAP_ULPS."""
    for name in dt._Carry._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert a.shape == b.shape and a.dtype == b.dtype, (what, name)
        if a.is_floating_point():
            gap = _gap_ulps(a, b)
            GAPS[name] = max(GAPS.get(name, 0.0), gap)
            assert gap <= GAP_ULPS, (what, name, gap)
        else:
            assert torch.equal(a, b), (what, name, a, b)


def _compare_traces(got, want, what):
    for name, a, b in zip(dt.IterationStats._fields, got, want):
        gap = _gap_ulps(a, b)
        GAPS["trace." + name] = max(GAPS.get("trace." + name, 0.0), gap)
        assert gap <= GAP_ULPS, (what, name, gap)


def _bits(t):
    t = t.contiguous()
    if t.is_floating_point():
        t = t.view(torch.int32)
    return t.cpu()


def _same_bits(a, b):
    return all(torch.equal(_bits(x), _bits(y)) for x, y in zip(a, b))


@pytest.mark.parametrize("smoothing", sorted(SMOOTHING))
@pytest.mark.parametrize("streams", STREAMS)
@pytest.mark.parametrize("level", [CFG.first_level, CFG.last_level])
def test_steps_on_a_level_against_the_plain_step(frames, level, streams, smoothing):
    cfg = _cfg(SMOOTHING[smoothing])
    evaluate, start = _level(frames, level, streams)
    consts = dt._constants(cfg, start[0])
    carry = dt._initial_carry(*start, consts)
    trace = dt._empty_trace(cfg, start[0])
    for k in range(WALK):
        first = k == 0
        want, want_trace = _one_step(cfg, evaluate, carry, first, "plain", trace)
        for kind in ("kernels",) + (("start",) if first else ()):
            got, got_trace = _one_step(cfg, evaluate, carry, first, kind, trace, start)
            _compare(got, want, (level, streams, k, kind))
            _compare_traces(got_trace, want_trace, (level, streams, k, kind))
        if first:  # the level's first step from its start values, as from its initial carry
            assert _same_bits(_one_step(cfg, evaluate, carry, first, "start", trace, start)[0],
                              _one_step(cfg, evaluate, carry, first, "kernels", trace)[0])
        carry, trace = want, want_trace  # the next step from the plain step's carry
        if bool(carry.done.all()):
            break


def _evaluation(n, ll, A_scale, b_value, nan=False, batch=()):
    def full(shape, value, dtype=torch.float32):
        return torch.full(batch + shape, value, dtype=dtype, device="cuda")

    A = torch.eye(6, device="cuda").expand(batch + (6, 6)) * A_scale
    A = A + 0.01 * torch.ones(6, 6, device="cuda")  # not diagonal
    if nan:
        A = A.clone()
        A[..., 0, 0] = float("nan")
    precision = torch.tensor([[2000.0, 10.0], [10.0, 90000.0]], device="cuda").expand(
        batch + (2, 2))
    b = b_value * torch.tensor([1.0, -2.0, 0.5, 0.25, -1.0, 3.0], device="cuda").expand(
        batch + (6,))
    return (full((), n, torch.int32), precision.contiguous(), full((), ll),
            A.contiguous(), b.contiguous())


# name: (expected code or None, evaluation, the carry's error and iteration)
CASES = {
    "too_few": (dt.TERM_TOO_FEW_CONSTRAINTS, dict(n=3, ll=10.0, A_scale=100.0, b_value=1.0),
                (float("inf"), 0)),
    "decreased": (dt.TERM_LOG_LIKELIHOOD_DECREASED,
                  dict(n=5000, ll=10.0, A_scale=100.0, b_value=1.0), (-20.0, 2)),
    "too_small": (dt.TERM_INCREMENT_TOO_SMALL,
                  dict(n=5000, ll=10.0, A_scale=1e9, b_value=1e-4), (float("inf"), 3)),
    "exceeded": (dt.TERM_ITERATIONS_EXCEEDED, dict(n=5000, ll=10.0, A_scale=10.0, b_value=1.0),
                 (float("inf"), CFG.max_iterations_per_level - 1)),
    "none": (dt.TERM_NONE, dict(n=5000, ll=10.0, A_scale=10.0, b_value=1.0), (5.0, 1)),
    "nan_A": (None, dict(n=5000, ll=10.0, A_scale=10.0, b_value=1.0, nan=True),
              (float("inf"), 1)),
}


def _case_carry(case, batch=()):
    """A carry at the case's error and iteration, from a small warm start
    (the identity prior for the increment-too-small case, whose prior term
    must vanish)."""
    _, _, (error, iteration) = CASES[case]
    guess = None if case == "too_small" else se3.exp_se3(
        torch.tensor([0.01, 0.02, -0.01, 0.002, 0.001, -0.003], device="cuda").expand(
            batch + (6,)))
    start = dt.match_start(guess, batch, torch.float32, torch.device("cuda"))
    if case == "too_small":
        start = (torch.zeros_like(start[0]),) + start[1:]
    consts = dt._constants(CFG, start[0])
    carry = _owned(dt._initial_carry(*start, consts))
    carry.error.fill_(error)
    carry.iteration.fill_(iteration)
    return carry


@pytest.mark.parametrize("smoothing", sorted(SMOOTHING))
@pytest.mark.parametrize("case", sorted(CASES))
def test_each_termination_code_and_a_nan(case, smoothing):
    cfg = _cfg(SMOOTHING[smoothing])
    code, ev, _ = CASES[case]
    evaluation = _evaluation(**ev)
    evaluate = lambda T, P, first: evaluation  # noqa: E731
    carry = _case_carry(case)
    trace = dt._empty_trace(cfg, carry.x)
    want, want_trace = _one_step(cfg, evaluate, carry, False, "plain", trace)
    if code is not None:
        assert int(want.termination) == code, (case, int(want.termination))
    else:
        assert torch.isnan(want_trace.increment).any()
    got, got_trace = _one_step(cfg, evaluate, carry, False, "kernels", trace)
    _compare(got, want, case)
    _compare_traces(got_trace, want_trace, case)


def test_a_stream_of_a_batch_equals_its_one_stream_call(frames):
    """B = 16: the six hand-made cases, real steps at level 1 and a done
    stream, in one call, each stream bit-equal to its own one-stream call
    (and the done stream's carry unchanged)."""
    cfg = _cfg(True)
    evaluate, start = _level(frames, CFG.last_level, 16)
    consts = dt._constants(cfg, start[0])
    real = dt._step(cfg, evaluate, dt._initial_carry(*start, consts), True, consts)[0]
    real_ev = evaluate(se3.exp_se3(real.x) @ real.T, real.precision, False)
    names = sorted(CASES)
    carries, evals = [], []
    for b in range(16):
        if b < len(names):
            carries.append(_case_carry(names[b]))
            evals.append(_evaluation(**CASES[names[b]][1]))
        else:
            carries.append(dt._Carry(*(t[b] for t in _owned(real))))
            carries[-1].done.fill_(b == 15)  # the last one frozen in the batch
            evals.append(tuple(t[b] for t in real_ev))
    batched = dt._Carry(*(torch.stack(f) for f in zip(*carries)))
    batched_ev = tuple(torch.stack(f).contiguous() for f in zip(*evals))
    got, _ = _one_step(cfg, lambda T, P, first: batched_ev, batched, False, "kernels")
    for b in range(15):
        solo, _ = _one_step(cfg, lambda T, P, first, e=evals[b]: e, carries[b], False, "kernels")
        assert _same_bits(tuple(t[b] for t in got), solo), b
    assert _same_bits(tuple(t[15] for t in got), carries[15])


@pytest.mark.parametrize("streams", [1, 2])
def test_the_tail_capture_holds_four_kernels(frames, streams):
    ref, cur = frames
    if streams > 1:
        ref, cur = (dt.PreparedFrame(*(tuple(None if t is None else torch.stack([t] * streams)
                                             for t in field) for field in f))
                    for f in (ref, cur))
    irls_graph.release()
    before = irls_step.step_tail_cuda.launches
    with graph_check.loop_mode(True, 1, polled=False):
        result = dt.match_prepared(CFG, TUM_FR1, ref, cur)
    irls_graph.fold_counts()
    iterations = sum(int(s.iterations.max()) for s in result.level_stats)
    assert irls_step.step_tail_cuda.launches - before == iterations
    tracker = [g for key, g in irls_graph._cache.items() if g.head is not None]
    assert len(tracker) == CFG.first_level - CFG.last_level + 1
    for graphs in tracker:
        tail = graphs.census()["tail"]
        print(f"\nB = {streams}, tail capture nodes: {tail}")
        assert tail.get("kernel", 0) + 1 <= 5 and tail.get("memcpy", 0) <= 1, tail
        assert set(tail) <= {"kernel", "memcpy"}, tail


def test_the_wrappers_raise_on_what_they_do_not_take():
    x = torch.zeros(6, device="cuda")
    T = torch.eye(4, device="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        irls_step.step_head_cuda(x.cpu(), T.cpu(), T.cpu())
    with pytest.raises(ValueError, match="float32"):
        irls_step.step_head_cuda(x.double(), T.double(), T.double())
    with pytest.raises(ValueError, match=r"\[4, 4\]"):
        irls_step.step_head_cuda(x, T[:3], T)
