"""The IRLS loop's CUDA graphs on the card, against the eager loop.

At 640x480 and ``benchmark_config()``'s tracker, for every backend that
``_match_level`` resolves on CUDA tensors (``pallas``: kernels 1/1b;
``fused``: the plain twin; ``xla``: the modular path, t-distribution and
(Huber, MAD)) and B = 1, 2 and 8: every level's final carry, level
statistics and iteration trace from the host-polled graph loop at K = 1-4
are bit-equal to the eager loop at K = 1; that loop reads the host once per
chunk, and the kernel (or plain function) runs once per executed step.
(The while graph, the tracker's form on the card, is held to both in
``test_while_graph_cuda.py``; the tests below without a form named run it.)
The same holds with a threaded ``KeyframeTracker`` tracking beside the
comparisons, its worker's validation waves capturing and replaying
graphs of their own; after a solve of more streams than the kernels'
ticket buffer held (it grows, and the graphs captured before keep theirs);
and when the cache's bound drops keys or ``release()`` drops them all, so
that they are captured anew.  A capture that fails raises and names the
op.
"""

import dataclasses
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from dvo_slam_tpu_torch import benchmark_config, odometry
from dvo_slam_tpu_torch.config import InfluenceFunction, ScaleEstimator
from dvo_slam_tpu_torch.models import dense_tracker, irls_graph
from dvo_slam_tpu_torch.models.dense_tracker import PreparedFrame, match_prepared, prepare_frame
from dvo_slam_tpu_torch.models.keyframe_tracker import KeyframeTracker
from dvo_slam_tpu_torch.ops import fused_kernels, residuals
from dvo_slam_tpu_torch.ops.camera import TUM_FR1
from dvo_slam_tpu_torch.tools import graph_check
from dvo_slam_tpu_torch.utils import synthetic, trajectory

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLAM = benchmark_config()
CFG = SLAM.tracker
BACKENDS = {
    "pallas": CFG,
    "fused": dataclasses.replace(CFG, kernel_backend="fused"),
    "xla": dataclasses.replace(CFG, kernel_backend="xla"),
    "xla-huber-mad": dataclasses.replace(CFG, influence_function=InfluenceFunction.HUBER,
                                         scale_estimator=ScaleEstimator.MAD),
}
STREAMS = [1, 2, 8]
FRAMES = 10
SLAM_FRAMES = 24
WORKER_TIMEOUT_S = 600


@pytest.fixture(scope="module")
def easy():
    poses = synthetic.circular_trajectory(FRAMES, radius=0.05, rot_amplitude=0.02)
    intensity, depth = odometry.render_sequence(poses, (480, 640), TUM_FR1, workers=4)
    return odometry.upload_sequence(intensity, depth, torch.device("cuda"))


@pytest.fixture(scope="module")
def hard():
    poses = synthetic.circular_trajectory(SLAM_FRAMES, radius=0.15, rot_amplitude=0.12,
                                          z_amplitude=0.05)
    intensity, depth = odometry.render_sequence(poses, (480, 640), TUM_FR1,
                                                scene=synthetic.occluded_scene(), seed0=1000,
                                                workers=4)
    return intensity, depth, poses


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


def _solve(cfg, pair, graphs, chunk, polled=None):
    with graph_check.loop_mode(graphs, chunk, polled=polled), graph_check.recording() as levels:
        match_prepared(cfg, TUM_FR1, *pair, collect_iteration_stats=True)
    return levels


def _counts():
    irls_graph.fold_counts()
    return (fused_kernels.warp_fused_stats_cuda.launches,
            fused_kernels.warp_fused_stats_batched_cuda.launches,
            residuals.warp_and_sample_cm.calls, residuals.compute_residuals.calls)


def _counter_index(name, streams):
    if name == "pallas":
        return 0 if streams == 1 else 1
    return 2 if name == "fused" else 3


@pytest.mark.parametrize("streams", STREAMS)
@pytest.mark.parametrize("name", sorted(BACKENDS))
def test_graph_loop_bit_equal_to_eager(easy, name, streams):
    cfg = BACKENDS[name]
    pair = _pair(easy, cfg, streams)
    eager = _solve(cfg, pair, graphs=False, chunk=1)
    assert len(eager) == cfg.first_level - cfg.last_level + 1
    for chunk in (1, 2, 3, 4):
        for rep in range(2):  # the first solve captures, the second replays
            before = _counts()
            with graph_check.counting_reads() as reads:
                got = _solve(cfg, pair, graphs=True, chunk=chunk, polled=True)
            moved = [a - b for a, b in zip(_counts(), before)]
            assert graph_check.differences(got, eager) == [], (chunk, rep)
            _, steps, want_reads = graph_check.counts(graph_check.stats_of(eager), chunk)
            assert len(reads) == want_reads, (chunk, rep, reads)
            index = _counter_index(name, streams)
            assert moved[index] == steps, (chunk, rep)
            assert not any(m for i, m in enumerate(moved) if i != index), moved


def test_graph_loop_beside_the_keyframe_worker(easy, hard, monkeypatch):
    """A threaded KeyframeTracker (its worker's waves at B = 2n) tracks on
    the card while this thread's graph solves at B = 1, 2 and 8 stay
    bit-equal to their eager solves made before it started; the tracker's
    thread and its graph's worker solve through the graph loop too."""
    cases = [(name, streams) for name in ("pallas", "xla-huber-mad") for streams in STREAMS]
    pairs = {c: _pair(easy, BACKENDS[c[0]], c[1]) for c in cases}
    eager = {c: _solve(BACKENDS[c[0]], pairs[c], graphs=False, chunk=1) for c in cases}
    intensity, depth, poses = hard
    errors, online = [], []

    def track():
        try:
            kt = KeyframeTracker(TUM_FR1, SLAM)
            for k in range(SLAM_FRAMES):
                online.append(kt.update(kt.make_frame_raw(intensity[k], depth[k], k / 30.0)))
            kt.finish()
            online.append(kt.trajectory())
        except Exception as exc:  # reported below, in the test's thread
            errors.append(exc)

    solvers = set()
    graph_level = dense_tracker._graph_level

    def counted(*args, **kwargs):
        solvers.add(threading.get_ident())
        return graph_level(*args, **kwargs)

    monkeypatch.setattr(dense_tracker, "_graph_level", counted)
    worker = threading.Thread(target=track)
    worker.start()
    rounds, deadline = 0, time.monotonic() + WORKER_TIMEOUT_S
    while worker.is_alive() or rounds < 2:
        assert time.monotonic() < deadline, "the tracking thread did not finish"
        for c in cases:
            got = _solve(BACKENDS[c[0]], pairs[c], graphs=True,
                         chunk=dense_tracker.CHUNK_STEPS)
            assert graph_check.differences(got, eager[c]) == [], (c, rounds)
        rounds += 1
    worker.join(timeout=WORKER_TIMEOUT_S)
    assert not worker.is_alive() and not errors, errors
    stamps, est = online.pop()
    gt = np.arange(SLAM_FRAMES) / 30.0
    assert trajectory.ate_rmse(stamps, est, gt, poses) < 0.01
    assert trajectory.ate_rmse(gt, np.asarray(online), gt, poses) < 0.01
    # the tracking thread's matches and the keyframe graph's waves
    assert len(solvers - {threading.get_ident()}) >= 2


_FAILING_CAPTURE = r"""
import traceback
import torch
from dvo_slam_tpu_torch.models import irls_graph

device = torch.device("cuda")
graphs = irls_graph.graphs_for(("a chunk that reads the host",), device)
graphs.load((torch.ones(4, device=device),))


def program(static, state):
    x = static[0] * 2.0
    if x.sum().item() > 0:  # a host read: not capturable
        x = x + 1.0
    return (x,)


try:
    with graphs.lock:
        graphs.run_head(program, ())
    print("CAPTURED")
except RuntimeError:
    print(traceback.format_exc())
"""


def test_a_failed_capture_raises_and_names_the_op(tmp_path):
    """No fallback: an op that reads the host inside the chunk breaks the
    capture, and the runner raises with that op in its chained traceback
    (in a child process: a void capture is left behind)."""
    script = tmp_path / "failing_capture.py"
    script.write_text(_FAILING_CAPTURE)
    out = subprocess.run([sys.executable, str(script)], cwd=REPO, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    assert "CAPTURED" not in out.stdout
    assert "capturing the IRLS chunk as a CUDA graph failed" in out.stdout
    assert "x.sum().item()" in out.stdout


def test_graphs_captured_before_the_tickets_grow_stay_right(easy):
    """The kernels' ticket buffer of the capture stream starts at 64
    streams.  A graph captured at B = 2 bakes in its address; a solve at
    B = 68 grows the buffer, and the old one must stay allocated: here the
    capture stream then allocates small tensors of ones, which would take
    its place were it freed, and the B = 2 replay stays bit-equal."""
    cfg = BACKENDS["pallas"]
    small, wide = _pair(easy, cfg, 2), _pair(easy, cfg, 68)
    eager_small = _solve(cfg, small, graphs=False, chunk=1)
    eager_wide = _solve(cfg, wide, graphs=False, chunk=1)
    assert graph_check.differences(_solve(cfg, small, graphs=True, chunk=1), eager_small) == []
    assert graph_check.differences(_solve(cfg, wide, graphs=True, chunk=1), eager_wide) == []
    with torch.cuda.stream(irls_graph._capture_stream(torch.device("cuda", 0))):
        ones = [torch.ones(64, dtype=torch.int32, device="cuda") for _ in range(256)]
    torch.cuda.synchronize()
    assert graph_check.differences(_solve(cfg, small, graphs=True, chunk=1), eager_small) == []
    del ones


def test_the_cache_bound_and_release_drop_keys(easy, monkeypatch):
    """Under a bound of one byte each capture drops every other idle key;
    the solves stay bit-equal as keys come back and are captured anew, and
    ``release()`` empties the cache and frees its memory."""
    cfg = BACKENDS["pallas"]
    pairs = {streams: _pair(easy, cfg, streams) for streams in (1, 2)}
    eager = {streams: _solve(cfg, pair, graphs=False, chunk=1) for streams, pair in pairs.items()}
    irls_graph.release()
    monkeypatch.setattr(irls_graph, "CACHE_BYTES", 1)
    evicted = irls_graph.stats()["evicted"]
    for streams in (1, 2, 1, 2):
        got = _solve(cfg, pairs[streams], graphs=True, chunk=1)
        assert graph_check.differences(got, eager[streams]) == [], streams
        assert irls_graph.stats()["keys"] == 1  # the last level's key
    assert irls_graph.stats()["evicted"] - evicted == 4 * (cfg.first_level - cfg.last_level + 1) - 1
    monkeypatch.undo()
    for streams in (1, 2, 1):
        assert graph_check.differences(_solve(cfg, pairs[streams], graphs=True, chunk=1),
                                       eager[streams]) == []
    held = irls_graph.stats()
    assert held["keys"] == 2 * (cfg.first_level - cfg.last_level + 1)
    allocated = torch.cuda.memory_allocated()
    irls_graph.release()
    assert irls_graph.stats()["keys"] == 0
    assert torch.cuda.memory_allocated() <= allocated - held["static_bytes"]
    assert graph_check.differences(_solve(cfg, pairs[2], graphs=True, chunk=1), eager[2]) == []
