"""A tracker IRLS level as one while loop on the card
(``csrc/while_graph.cu``): inside the match graph, the tracker's form
(``irls_graph.MatchGraph``, each level's loop over its key's head and tail
captures), held to the eager loop and the host-polled chunks level by
level; the per-level while-graph launch (``LevelGraphs.run_level``) is held
to both in ``test_match_graph_cuda.py``.

At 640x480 and ``benchmark_config()``'s tracker, for one stream and B = 2
and 8, the iteration trace collected and not, depth-buffered sampling on
and off (kernels 1/1b), and for the plain twin and the modular path:
every level's carry, iterations, terminations and trace from the while
graph are bit-equal to the eager loop's and to the host-polled K = 1
chunk runner's; the while graph reads nothing back, and its kernel
launches, folded in from the card, equal the executed steps.
A NaN start still ends the WHILE loop.  ``match_prepared`` raises nothing
under ``torch.cuda.set_sync_debug_mode("error")``; two threads solve
different keys at once; a key dropped and
captured again gives the same bits and keeps its counts; a graph that CUDA
refuses to build raises with CUDA's text and does not fall back.
"""

import dataclasses
import threading

import pytest
import torch

from dvo_slam_tpu_torch import benchmark_config, odometry
from dvo_slam_tpu_torch.config import InfluenceFunction, ScaleEstimator
from dvo_slam_tpu_torch.models import dense_tracker, irls_graph
from dvo_slam_tpu_torch.models.dense_tracker import PreparedFrame, match_prepared, prepare_frame
from dvo_slam_tpu_torch.ops import least_squares
from dvo_slam_tpu_torch.ops.camera import TUM_FR1
from dvo_slam_tpu_torch.tools import driver_launches, graph_check
from dvo_slam_tpu_torch.utils import synthetic

pytestmark = pytest.mark.cuda

CFG = benchmark_config().tracker
FRAMES = 10
COUNTER = {1: driver_launches.ONE}  # kernel 1 for one stream, 1b for more


@pytest.fixture(scope="module")
def easy():
    poses = synthetic.circular_trajectory(FRAMES, radius=0.05, rot_amplitude=0.02)
    intensity, depth = odometry.render_sequence(poses, (480, 640), TUM_FR1, workers=4)
    return odometry.upload_sequence(intensity, depth, torch.device("cuda"))


def _batched(frames):
    """One PreparedFrame of B prepared frames (each field stacked per level)."""
    return PreparedFrame(*(
        tuple(None if level[0] is None else torch.stack(level) for level in zip(*field))
        for field in zip(*frames)))


def _pair(easy, cfg, streams):
    """(reference, current) prepared frames: frame k against k + 1 for
    stream k, the sequence's pairs repeated past its end."""
    d_i, d_d = easy
    prepared = [prepare_frame(cfg, TUM_FR1, odometry.build_frame(cfg, d_i[k], d_d[k]))
                for k in range(min(streams + 1, FRAMES))]
    if streams == 1:
        return prepared[0], prepared[1]
    pairs = [k % (len(prepared) - 1) for k in range(streams)]
    return (_batched([prepared[k] for k in pairs]),
            _batched([prepared[k + 1] for k in pairs]))


def _solve(cfg, pair, graphs=True, polled=False, collect=True):
    with graph_check.loop_mode(graphs, 1, polled=polled), graph_check.recording() as levels:
        match_prepared(cfg, TUM_FR1, *pair, collect_iteration_stats=collect)
    return levels


def _kernel(streams):
    return COUNTER.get(streams, driver_launches.BATCHED)


@pytest.mark.parametrize("buffered", [True, False])
@pytest.mark.parametrize("collect", [True, False])
@pytest.mark.parametrize("streams", [1, 2, 8])
def test_while_level_bit_equal_to_eager_and_polled(easy, streams, collect, buffered):
    cfg = dataclasses.replace(CFG, depth_buffered_sampling=buffered)
    pair = _pair(easy, cfg, streams)
    eager = _solve(cfg, pair, graphs=False, collect=collect)
    polled = _solve(cfg, pair, polled=True, collect=collect)
    assert graph_check.differences(polled, eager) == []
    _, steps, _ = graph_check.counts(graph_check.stats_of(eager), 1)
    for rep in range(2):  # the first solve of a key captures and builds, the second launches
        driver_launches.reset_counts()
        with graph_check.counting_reads() as reads:
            got = _solve(cfg, pair, collect=collect)
        assert reads == [], (rep, reads)
        assert graph_check.differences(got, eager) == [], rep
        for s in graph_check.stats_of(got):
            assert s.iterations.dtype == torch.int32 and s.iterations.is_cuda
        counts = driver_launches.launches()
        assert counts[_kernel(streams)] == steps, (rep, counts)
        assert not any(v for k, v in counts.items() if k != _kernel(streams)), counts
        levels = len(got)
        assert irls_graph.while_counts.launches == levels
        assert irls_graph.while_counts.set_while == steps  # K = 1: a run per step
        assert dense_tracker.read_done.calls == 0


@pytest.mark.parametrize("streams", [1, 8])
@pytest.mark.parametrize("name", ["fused", "xla-huber-mad"])
def test_while_level_on_the_plain_paths(easy, name, streams):
    """The plain twin and the modular path (no kernel) as while graphs."""
    cfg = dataclasses.replace(CFG, kernel_backend="fused") if name == "fused" else \
        dataclasses.replace(CFG, influence_function=InfluenceFunction.HUBER,
                            scale_estimator=ScaleEstimator.MAD)
    pair = _pair(easy, cfg, streams)
    eager = _solve(cfg, pair, graphs=False)
    for _ in range(2):
        assert graph_check.differences(_solve(cfg, pair), eager) == []


@pytest.mark.parametrize("streams", [1, 2])
def test_a_nan_start_still_ends_the_loop(easy, streams):
    """A NaN initial estimate (for B = 2, in stream 0 only): its first step
    warps no pixel and is rejected, so ``done`` is set on the card and the
    WHILE loop ends, with the eager loop's carry (NaNs by their bits)."""
    pair = _pair(easy, CFG, streams)
    initial = torch.eye(4, device="cuda").expand((streams, 4, 4) if streams > 1 else (4, 4))
    initial = initial.clone()
    initial[..., 0, 3] = float("nan") if streams == 1 else 0.0
    if streams > 1:
        initial[0, 0, 3] = float("nan")

    def solve(graphs):
        with graph_check.loop_mode(graphs, 1, polled=False), graph_check.recording() as levels:
            result = match_prepared(CFG, TUM_FR1, *pair, initial, collect_iteration_stats=True)
        return levels, result

    eager, _ = solve(False)
    got, result = solve(True)
    assert graph_check.differences(got, eager) == []
    for s in result.level_stats:
        assert int(s.iterations.max()) <= CFG.max_iterations_per_level


def test_match_prepared_under_sync_debug_error(easy):
    """Once its keys are built, a match reads nothing back and synchronizes
    nothing: CUDA's sync-debug mode "error" raises on any such call."""
    pairs = [_pair(easy, CFG, streams) for streams in (1, 8)]
    for pair in pairs:
        for collect in (False, True):  # the keys' captures and builds
            match_prepared(CFG, TUM_FR1, *pair, collect_iteration_stats=collect)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        results = [match_prepared(CFG, TUM_FR1, *pair, collect_iteration_stats=collect)
                   for pair in pairs for collect in (False, True)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for r in results:
        assert bool(torch.isfinite(r.transformation).all())


def _bits(result):
    """A result's fields and level statistics, for a bit-for-bit comparison."""
    return [result.transformation, result.information, result.neg_log_likelihood] + [
        f for s in result.level_stats for f in s]


def test_two_threads_solve_different_keys(easy):
    """One stream in this thread and B = 8 in another, at once, each bit-equal
    to its eager solve every round (the module's default forms: while
    graphs on the card)."""
    pairs = {streams: _pair(easy, CFG, streams) for streams in (1, 8)}
    with graph_check.loop_mode(False):
        eager = {streams: _bits(match_prepared(CFG, TUM_FR1, *pair))
                 for streams, pair in pairs.items()}
    errors, rounds = [], 6

    def solve(streams):
        try:
            for k in range(rounds):
                got = _bits(match_prepared(CFG, TUM_FR1, *pairs[streams]))
                assert all(graph_check._same(a, b) for a, b in zip(got, eager[streams])), \
                    (streams, k)
        except Exception as exc:  # reported in the test's thread
            errors.append(exc)

    worker = threading.Thread(target=solve, args=(8,))
    worker.start()
    solve(1)
    worker.join(timeout=600)
    assert not worker.is_alive() and not errors, errors


def test_a_dropped_key_captured_again_gives_the_same_bits(easy, monkeypatch):
    """``release()`` and the cache's bound drop while graphs (their counts
    folded first); captured and built again, the solves give the same
    bits, and the launches over the drops equal the executed steps."""
    pairs = {streams: _pair(easy, CFG, streams) for streams in (1, 2)}
    eager = {streams: _solve(CFG, pair, graphs=False) for streams, pair in pairs.items()}
    driver_launches.reset_counts()
    steps = {driver_launches.ONE: 0, driver_launches.BATCHED: 0}
    monkeypatch.setattr(irls_graph, "CACHE_BYTES", 1)
    for streams in (1, 2, 1, 2):
        got = _solve(CFG, pairs[streams])
        assert graph_check.differences(got, eager[streams]) == [], streams
        steps[_kernel(streams)] += graph_check.counts(graph_check.stats_of(got), 1)[1]
    monkeypatch.undo()
    irls_graph.release()
    assert irls_graph.stats()["while_graphs"] == 0
    got = _solve(CFG, pairs[1])
    assert graph_check.differences(got, eager[1]) == []
    steps[driver_launches.ONE] += graph_check.counts(graph_check.stats_of(got), 1)[1]
    counts = driver_launches.launches()
    assert {k: counts[k] for k in steps} == steps


def _with_empty_products(A, b, n: int = 6):
    """The unrolled Cholesky solve as it was: its empty dot products make
    cuBLAS copy a zero from the host, which a WHILE body refuses."""
    L = torch.zeros_like(A)
    for j in range(n):
        s = A[..., j:, j] - least_squares._matvec(L[..., j:, :j], L[..., j, :j])
        pivot = torch.sqrt(torch.clamp(s[..., 0], min=least_squares._PIVOT_FLOOR))
        L[..., j, j] = pivot
        L[..., j + 1:, j] = s[..., 1:] / pivot.unsqueeze(-1)
    y = torch.zeros_like(b)
    for i in range(n):
        y[..., i] = (b[..., i] - least_squares._dot(L[..., i, :i], y[..., :i])) / L[..., i, i]
    x = torch.zeros_like(b)
    for i in reversed(range(n)):
        x[..., i] = (y[..., i] - least_squares._dot(L[..., i + 1:, i], x[..., i + 1:])) / L[..., i, i]
    return x


def test_a_refused_build_raises_and_does_not_fall_back(easy, monkeypatch):
    """A one-stream step that copies from the host (the step kernels, then
    the unrolled solve as it was on the carry's system): CUDA refuses the
    WHILE body, and the match raises with CUDA's text, the key and the
    levels' node types, without a host-polled chunk or a launch counted."""
    pair = _pair(easy, CFG, 1)
    irls_graph.release()
    step = dense_tracker._fused_step

    def step_with_a_host_copy(*args, **kwargs):
        carry = step(*args, **kwargs)
        _with_empty_products(carry.A, carry.x)
        return carry

    monkeypatch.setattr(dense_tracker, "_fused_step", step_with_a_host_copy)
    driver_launches.reset_counts()
    with pytest.raises(RuntimeError) as info:
        _solve(CFG, pair)
    text = str(info.value)
    assert "building the match graph of 3 IRLS levels failed" in text
    assert "cudaGraphInstantiate" in text and "'memcpy'" in text and "'pallas'" in text
    counts = driver_launches.launches()
    assert not any(counts.values()), counts
    assert dense_tracker.read_done.calls == 0 and irls_graph.while_counts.launches == 0
    monkeypatch.undo()
    irls_graph.release()
