"""The chunked IRLS loop of ``dense_tracker`` on the CPU, without a graph.

The loop carries the iteration counter on the device (the reference's
``_Carry.iteration``), freezes a finished carry for one stream as for B,
and reads its ``done`` flags once per chunk of K steps.  Against the loop
as it was before the chunks (``_loop_before_chunks`` below, a verbatim copy
that read ``done`` after every iteration and counted on the host), K = 1,
2 and 4 give bit-equal carries, level statistics, results and iteration
traces on the scenes of ``tests/test_torch_dense_tracker.py`` (120x160,
two configurations), ``tests/test_torch_multistream.py`` (B = 3 and 2 in
lockstep, 60x80) and ``tests/test_torch_modular_tracker.py`` (the six
modular configurations and the (Huber, MAD) lockstep fixture); a level
evaluates K * ceil(iterations / K) times; a step past ``done`` is inert.
The card's graph form is held to the eager one in
``tests_cuda/test_irls_graph_cuda.py``.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from dvo_slam_tpu_torch.config import (
    InfluenceFunction,
    ScaleEstimator,
    TrackerConfig,
    benchmark_config,
)
from dvo_slam_tpu_torch.models import dense_tracker as t_dt
from dvo_slam_tpu_torch.odometry import build_frame
from dvo_slam_tpu_torch.models.dense_tracker import (
    TERM_INCREMENT_TOO_SMALL,
    TERM_ITERATIONS_EXCEEDED,
    TERM_LOG_LIKELIHOOD_DECREASED,
    TERM_NONE,
    TERM_TOO_FEW_CONSTRAINTS,
    IterationStats,
    _where,
)
from dvo_slam_tpu_torch.ops import least_squares, se3
from dvo_slam_tpu_torch.ops.camera import Intrinsics
from dvo_slam_tpu_torch.ops.pyramid import build_pyramid
from dvo_slam_tpu_torch.parallel import multistream
from dvo_slam_tpu_torch.utils import synthetic

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

CHUNKS = [1, 2, 4]
NOISE = dict(depth_noise=0.002, intensity_noise=1.0)
TWIST = [0.01, -0.008, 0.012, 0.004, -0.005, 0.006]

# tests/test_torch_dense_tracker.py: 120x160, (config, twist, guess, noise)
DENSE_K = Intrinsics(160.0, 160.0, 79.5, 59.5)
DENSE_CFG = TrackerConfig(first_level=2, last_level=0, max_iterations_per_level=50)
BENCH_CFG = benchmark_config().tracker
DENSE_SCENES = {
    "default-z": (DENSE_CFG, [0.0, 0.0, 0.02, 0.0, 0.0, 0.0], False, {}),
    "default-6dof": (DENSE_CFG, TWIST, False, {}),
    "bench-x": (BENCH_CFG, [0.01, 0.0, 0.0, 0.0, 0.0, 0.0], True, NOISE),
    "bench-xz-yaw": (BENCH_CFG, [0.01, 0.0, 0.005, 0.0, 0.0, 0.01], True, NOISE),
}

# tests/test_torch_multistream.py and tests/test_torch_modular_tracker.py: 60x80
SMALL_K = Intrinsics(80.0, 80.0, 39.5, 29.5)
LOCKSTEP_CFG = TrackerConfig(first_level=1, last_level=0, max_iterations_per_level=15,
                             precision=1e-4, use_initial_estimate=True)
HUBER_MAD = dict(influence_function=InfluenceFunction.HUBER, scale_estimator=ScaleEstimator.MAD)
LOCKSTEP_SCENES = {  # (config, streams, noise)
    "buffered": (LOCKSTEP_CFG, 3, None),
    "unbuffered": (dataclasses.replace(LOCKSTEP_CFG, depth_buffered_sampling=False), 2,
                   dict(depth_noise=0.002)),
    "huber-mad": (dataclasses.replace(LOCKSTEP_CFG, **HUBER_MAD), 3, NOISE),
}
MODULAR_BASE = TrackerConfig(first_level=2, last_level=0, max_iterations_per_level=50,
                             kernel_backend="xla")
MODULAR_CONFIGS = {
    "tdist": MODULAR_BASE,
    "huber-normal": dataclasses.replace(MODULAR_BASE, influence_function=InfluenceFunction.HUBER,
                                        scale_estimator=ScaleEstimator.NORMAL),
    "tukey-mad": dataclasses.replace(MODULAR_BASE, influence_function=InfluenceFunction.TUKEY,
                                     scale_estimator=ScaleEstimator.MAD),
    "huber-mad": dataclasses.replace(MODULAR_BASE, **HUBER_MAD),
    "unit-unit": dataclasses.replace(MODULAR_BASE, influence_function=InfluenceFunction.UNIT,
                                     scale_estimator=ScaleEstimator.UNIT),
    "no-weighting": dataclasses.replace(MODULAR_BASE, use_weighting=False),
}


def _loop_before_chunks(cfg, evaluate, x0, T0, initial0, precision0, collect_stats=False,
                        chunk=1):
    """``dense_tracker._irls_level`` before the chunked loop, verbatim but
    for its carry (which had no ``iteration``): the oracle.  ``chunk`` is
    taken and ignored."""
    from collections import namedtuple

    Carry = namedtuple("Carry", "x T initial inc_applied precision error A ll n termination done")
    dtype, device = x0.dtype, x0.device
    batch = tuple(x0.shape[:-1])
    eye6 = torch.eye(6, dtype=dtype, device=device)

    def step(c, iteration: int):
        inc = se3.exp_se3(c.x)
        T_new = inc @ c.T
        initial_new = se3.inverse(inc) @ c.initial

        n, precision_new, ll, A, b = evaluate(T_new, c.precision, iteration == 0)
        too_few = n < 6
        error = -ll

        accept = error < c.error
        reject = too_few | ~accept

        if cfg.use_estimate_smoothing:
            A = A + cfg.mu * eye6
            b = b + cfg.mu * se3.log_se3(initial_new)
        x_new = least_squares.solve_ldlt(A, b)

        converged = torch.amax(torch.abs(x_new), dim=-1) <= cfg.precision
        exceeded = iteration + 1 >= cfg.max_iterations_per_level

        code = lambda k: torch.full((), k, dtype=torch.int32, device=device)  # noqa: E731
        termination = torch.where(
            too_few,
            code(TERM_TOO_FEW_CONSTRAINTS),
            torch.where(
                ~accept,
                code(TERM_LOG_LIKELIHOOD_DECREASED),
                torch.where(
                    converged,
                    code(TERM_INCREMENT_TOO_SMALL),
                    code(TERM_ITERATIONS_EXCEEDED if exceeded else TERM_NONE),
                ),
            ),
        )

        def keep(new, old):
            return _where(reject, old, new)

        new_c = Carry(
            x=keep(x_new, c.x),
            T=keep(T_new, c.T),
            initial=keep(initial_new, c.initial),
            inc_applied=keep(inc, c.inc_applied),
            precision=keep(precision_new, c.precision),
            error=keep(error, c.error),
            A=keep(A, c.A),
            ll=keep(ll, c.ll),
            n=keep(n, c.n),
            termination=termination,
            done=reject | converged | exceeded,
        )
        row = IterationStats(
            valid_constraints=n.to(dtype),
            log_likelihood=ll,
            precision=precision_new,
            increment=x_new,
            information=A,
        )
        return new_c, row

    carry = Carry(
        x=x0,
        T=T0,
        initial=initial0,
        inc_applied=se3.exp_se3(x0),
        precision=precision0,
        error=torch.full(batch, float("inf"), dtype=dtype, device=device),
        A=eye6.expand(batch + (6, 6)),
        ll=torch.full(batch, float("-inf"), dtype=dtype, device=device),
        n=torch.zeros(batch, dtype=torch.int32, device=device),
        termination=torch.full(batch, TERM_NONE, dtype=torch.int32, device=device),
        done=torch.zeros(batch, dtype=torch.bool, device=device),
    )
    trace = None
    if collect_stats:
        max_it = cfg.max_iterations_per_level
        zeros = lambda *s: torch.zeros((max_it,) + batch + s, dtype=dtype, device=device)  # noqa: E731
        trace = IterationStats(
            valid_constraints=zeros(),
            log_likelihood=zeros(),
            precision=zeros(2, 2),
            increment=zeros(6),
            information=zeros(6, 6),
        )
    iterations = torch.zeros(batch, dtype=torch.int32, device=device) if batch else 0
    iteration = 0
    while True:
        stepped, row = step(carry, iteration)
        if batch:
            active = ~carry.done
            carry = Carry(*(_where(active, new, old) for new, old in zip(stepped, carry)))
            if trace is not None:
                row = IterationStats(*(_where(active, r, torch.zeros_like(r)) for r in row))
            iterations = iterations + active.to(torch.int32)
        else:
            carry = stepped
            iterations += 1
        if trace is not None:
            for buf, value in zip(trace, row):
                buf[iteration] = value
        iteration += 1
        if bool(carry.done.all() if batch else carry.done):
            break
    if trace is not None and batch:
        trace = IterationStats(*(buf.movedim(0, len(batch)) for buf in trace))
    return carry, iterations, trace


def _recorded(monkeypatch, loop, chunk=None):
    """Route ``_match_level``'s loop through ``loop`` (with ``chunk``
    passed explicitly) and record each level's (carry, iterations,
    evaluations)."""
    levels = []

    def run(cfg, evaluate, x0, T0, initial0, precision0, collect_stats=False, _chunk=1):
        calls = [0]

        def counted(*args):
            calls[0] += 1
            return evaluate(*args)

        kw = {} if chunk is None else {"chunk": chunk}
        carry, iterations, trace = loop(cfg, counted, x0, T0, initial0, precision0,
                                        collect_stats, **kw)
        levels.append((carry, iterations, calls[0]))
        return carry, iterations, trace

    monkeypatch.setattr(t_dt, "_irls_level", run)
    return levels


def _pyramids(size_k, shape, twist, noise, levels):
    T = se3.exp_se3(torch.tensor(twist, dtype=torch.float32)).numpy().astype(np.float64)
    out = []
    for pose, seed in ((np.eye(4), 0), (T, 1)):
        i, d, v = synthetic.render_frame(pose, size_k, shape, seed=seed, **noise)
        out.append(build_pyramid(*(torch.from_numpy(np.array(a)) for a in (i, d, v)), levels))
    return out


def _streams(streams, frames, noise):
    """u8/u16 [B, T, 60, 80] on circles of different radii."""
    iu = np.zeros((streams, frames, 60, 80), np.uint8)
    du = np.zeros((streams, frames, 60, 80), np.uint16)
    for b in range(streams):
        poses = synthetic.circular_trajectory(frames, radius=0.02 + 0.01 * b)
        for t in range(frames):
            i, d, v = synthetic.render_frame(poses[t], SMALL_K, (60, 80), seed=7 * b + t,
                                             **(noise or {}))
            iu[b, t] = np.clip(i, 0, 255).astype(np.uint8)
            du[b, t] = np.where(v, d * 5000.0, 0).astype(np.uint16)
    return iu, du


def _dense_case(name):
    cfg, twist, guess, noise = DENSE_SCENES[name]
    ref, cur = _pyramids(DENSE_K, (120, 160), twist, noise, cfg.num_levels)
    init = np.eye(4, dtype=np.float32) if guess else None
    return lambda: t_dt.match_pyramids(cfg, DENSE_K, ref, cur, init,
                                       collect_iteration_stats=True)


def _modular_case(name):
    cfg = MODULAR_CONFIGS[name]
    ref, cur = _pyramids(SMALL_K, (60, 80), TWIST, NOISE, cfg.num_levels)
    return lambda: t_dt.match_pyramids(cfg, SMALL_K, ref, cur, collect_iteration_stats=True)


def _lockstep_case(name):
    """The first pair of each stream, batched, through ``match_prepared``."""
    cfg, streams, noise = LOCKSTEP_SCENES[name]
    iu, du = _streams(streams, 2, noise)
    i, d = multistream.as_frames(iu, du, device="cpu")
    ref, cur = (t_dt.prepare_frame(cfg, SMALL_K, build_frame(cfg, i[:, t], d[:, t]))
                for t in (0, 1))
    return lambda: t_dt.match_prepared(cfg, SMALL_K, ref, cur, collect_iteration_stats=True)


# lockstep cases whose streams finish a level apart
FINISH_APART = [("lockstep", "buffered"), ("lockstep", "huber-mad")]
CASES = ([("dense", n) for n in DENSE_SCENES] + [("modular", n) for n in MODULAR_CONFIGS]
         + [("lockstep", n) for n in LOCKSTEP_SCENES])
_MAKERS = {"dense": _dense_case, "modular": _modular_case, "lockstep": _lockstep_case}


@functools.lru_cache(maxsize=None)
def _case(kind, name):
    return _MAKERS[kind](name)


@functools.lru_cache(maxsize=None)
def _before(kind, name):
    """The oracle's result and levels for a case (computed once)."""
    mp = pytest.MonkeyPatch()
    try:
        levels = _recorded(mp, _loop_before_chunks)
        return _case(kind, name)(), levels
    finally:
        mp.undo()


def _equal(a, b):
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    return a == b


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("kind,name", CASES)
def test_chunks_bit_equal_to_the_loop_before(monkeypatch, kind, name, chunk):
    want, want_levels = _before(kind, name)
    levels = _recorded(monkeypatch, t_dt._irls_level, chunk)
    got = _case(kind, name)()
    for field in ("transformation", "information", "neg_log_likelihood"):
        assert torch.equal(getattr(got, field), getattr(want, field)), field
    for s_got, s_want in zip(got.level_stats, want.level_stats, strict=True):
        for field in s_want._fields:
            assert _equal(getattr(s_got, field), getattr(s_want, field)), field
    for t_got, t_want in zip(got.iteration_stats, want.iteration_stats, strict=True):
        for field in t_want._fields:
            assert torch.equal(getattr(t_got, field), getattr(t_want, field)), field
    for (c_got, it_got, calls), (c_want, it_want, _) in zip(levels, want_levels, strict=True):
        for field in c_want._fields:
            assert torch.equal(getattr(c_got, field), getattr(c_want, field)), field
        assert _equal(it_got, it_want) and torch.equal(c_got.iteration, torch.as_tensor(
            it_want, dtype=torch.int32))
        loop = int(torch.as_tensor(it_want).max())
        assert calls == t_dt.executed_steps(loop, chunk) == chunk * -(-loop // chunk)
    if (kind, name) in FINISH_APART:  # so frozen steps ran
        assert any(len(set(s.iterations.tolist())) > 1 for s in want.level_stats)


@pytest.mark.parametrize("batch", [(), (3,)])
def test_a_step_past_done_is_inert(batch):
    """Steps from a finished carry leave every field, the iteration count
    and the trace as they were, though their evaluations run."""
    cfg = dataclasses.replace(LOCKSTEP_CFG, max_iterations_per_level=4)
    iu, du = _streams(3, 2, NOISE)
    i, d = multistream.as_frames(iu, du, device="cpu")
    ref, cur = (t_dt.prepare_frame(cfg, SMALL_K, build_frame(cfg, i[:, t], d[:, t]))
                for t in (0, 1))
    lv = cfg.last_level
    pick = (lambda t: t) if batch else (lambda t: t[0])
    inputs = (pick(ref.refpack[lv]), pick(cur.quad[lv]))
    shape = tuple(ref.sel[lv].shape[-2:])
    evaluate = t_dt._evaluation(cfg, "fused", SMALL_K.at_level(lv), shape, inputs)
    calls = [0]

    def counted(*args):
        calls[0] += 1
        return evaluate(*args)

    x0 = torch.zeros(batch + (6,))
    start = (x0, torch.eye(4).expand(batch + (4, 4)), torch.eye(4).expand(batch + (4, 4)),
             torch.eye(2).expand(batch + (2, 2)))
    carry, iterations, trace = t_dt._irls_level(cfg, counted, *start, collect_stats=True,
                                                chunk=1)
    assert bool(carry.done.all())
    consts = t_dt._constants(cfg, x0)
    # the loop's own layout: [max_iterations, *batch, ...]
    raw_trace = IterationStats(*(buf.movedim(len(batch), 0) for buf in trace))
    before = calls[0]
    frozen, frozen_trace = t_dt._chunk(cfg, counted, carry, raw_trace, 3, False, consts)
    assert calls[0] == before + 3
    for field in carry._fields:
        assert torch.equal(getattr(frozen, field), getattr(carry, field)), field
    for a, b in zip(frozen_trace, raw_trace):
        assert torch.equal(a, b)
    assert torch.equal(frozen.iteration, torch.as_tensor(iterations, dtype=torch.int32))


def test_executed_steps():
    assert t_dt.executed_steps(0, 2) == 0
    assert t_dt.executed_steps(5, 1) == 5
    assert t_dt.executed_steps([1, 2, 3, 4, 5], 2) == 2 + 2 + 4 + 4 + 6
    assert t_dt.executed_steps(torch.tensor([[3, 7], [4, 1]]), 4) == 4 + 8 + 4 + 4
    assert t_dt.CHUNK_STEPS == 1
