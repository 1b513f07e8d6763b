"""A level's iterations as the reference's carried count, and the launch
counts that the card's while graphs keep, on the CPU.

On the card a tracker level is one launch of a CUDA graph around the
whole ``while ~done`` loop (``models/irls_graph``), so no level reads its
iteration count back: ``LevelStats.iterations`` is the carry's int32 count
for one stream as for B, as the reference's ``final.iteration`` is.  Here:

- ``match_pyramids`` (one stream) and ``match_prepared`` at B = 1 and B = 3
  in lockstep on 60x80 pairs rendered as the reference's tests render
  them, against the reference's ``match_pyramids`` run op by op
  (``jax.disable_jit``) pair by pair: per level the iterations an int32
  tensor equal to the reference's, terminations (but for one known near
  tie) and valid constraints equal; the estimate within atol 1e-5 for one
  stream
  (``test_torch_dense_tracker.py``) and 1e-4 in lockstep
  (``test_torch_multistream.py``: the batched 6x6 solve rounds otherwise);
- the eager loop's launch counts (the plain evaluation's calls) equal the
  executed steps and its ``done`` reads one per chunk; the chunk counts a
  while graph keeps on the card for the same levels (one head and the tail
  chunks per level) fold into the same launch counts, also after the key
  is dropped;
- ``odometry.track_sequence``'s total iterations: an int, the sum of its
  matches' level counts.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvo_slam_tpu import config as j_config
from dvo_slam_tpu.models import dense_tracker as j_dt
from dvo_slam_tpu.ops import se3 as j_se3
from dvo_slam_tpu.ops.camera import Intrinsics as JIntrinsics
from dvo_slam_tpu.ops.pyramid import build_pyramid as j_build_pyramid
from dvo_slam_tpu.utils import synthetic as j_syn

from dvo_slam_tpu_torch import odometry
from dvo_slam_tpu_torch.convert import config_from_reference
from dvo_slam_tpu_torch.models import dense_tracker as t_dt
from dvo_slam_tpu_torch.models import irls_graph
from dvo_slam_tpu_torch.ops import residuals as t_res
from dvo_slam_tpu_torch.ops.camera import Intrinsics
from dvo_slam_tpu_torch.ops.pyramid import PyramidLevel
from dvo_slam_tpu_torch.ops.pyramid import build_pyramid as t_build_pyramid
from dvo_slam_tpu_torch.tools import driver_launches
from dvo_slam_tpu_torch.utils import synthetic

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

K = (80.0, 80.0, 39.5, 29.5)  # the reference tests' 60x80 intrinsics
SHAPE = (60, 80)
J_CFG = j_config.TrackerConfig(first_level=2, last_level=0, max_iterations_per_level=50)
CFG = config_from_reference(J_CFG)
NOISE = dict(depth_noise=0.002, intensity_noise=1.0)
TWISTS = ([0.01, -0.008, 0.012, 0.004, -0.005, 0.006], [0.0, 0.0, 0.02, 0.0, 0.0, 0.0],
          [0.012, 0.0, 0.004, 0.0, 0.006, 0.0])
ONE_ATOL = 1e-5  # tests/test_torch_dense_tracker.py: the estimate, op by op
LOCKSTEP_ATOL = 1e-4  # tests/test_torch_multistream.py: POSE_ATOL
# The one near tie on these pairs (ROADMAP queue C), before this slice as
# after it: for one stream the first pair's finest level ends on a step
# that the port accepts (then its increment is too small, 2) and the
# reference rejects (its log-likelihood not lower, 3), the log sum being
# summed in another order; the iterations, the constraints and the
# estimate (within 5.7e-7) agree.  In lockstep (the batched solve rounds
# otherwise) the port ends as the reference does.  (pair, level index) ->
# (the port's termination, the reference's).
NEAR_TIE = {(0, 2): (2, 3)}


def _pair(twist):
    """Both packages' pyramids of a rendered pair (bit-equal levels)."""
    T = np.asarray(j_se3.exp_se3(jnp.asarray(twist, jnp.float32)), np.float64)
    out = []
    for pose, seed in ((np.eye(4), 0), (T, 1)):
        i, d, v = j_syn.render_frame(pose, JIntrinsics(*K), SHAPE, seed=seed, **NOISE)
        out.append((j_build_pyramid(jnp.asarray(i), jnp.asarray(d), jnp.asarray(v),
                                    J_CFG.num_levels),
                    t_build_pyramid(*(torch.from_numpy(np.array(a)) for a in (i, d, v)),
                                    CFG.num_levels)))
    return out


@pytest.fixture(scope="module")
def pairs():
    """Per twist: ((reference levels, port levels) of the reference frame,
    the same of the current frame), and the reference's op-by-op result."""
    out = []
    for twist in TWISTS:
        (j_ref, t_ref), (j_cur, t_cur) = _pair(twist)
        with jax.disable_jit():
            want = j_dt.match_pyramids(J_CFG, JIntrinsics(*K), j_ref, j_cur)
        out.append((t_ref, t_cur, want))
    return out


def _stacked(levels):
    """B streams' pyramids stacked level by level ([B, ...] fields)."""
    return tuple(PyramidLevel(*(torch.stack(f) for f in zip(*lv))) for lv in zip(*levels))


def _assert_levels(pair, got_stats, got_T, want, atol, near_tie=None):
    for level, (s, w) in enumerate(zip(got_stats, want.level_stats, strict=True)):
        assert s.iterations.dtype == torch.int32 and s.iterations.dim() == 0
        assert int(s.iterations) == int(w.iterations)
        terms = (int(s.termination), int(w.termination))
        assert terms == (near_tie or {}).get((pair, level), (terms[1], terms[1]))
        assert int(s.valid_constraints) == int(w.valid_constraints)
    np.testing.assert_allclose(got_T.numpy(), np.asarray(want.transformation), atol=atol)


def test_match_pyramids_iterations_are_the_carrys_count(pairs):
    k = Intrinsics(*K)
    for pair, (t_ref, t_cur, want) in enumerate(pairs):
        got = t_dt.match_pyramids(CFG, k, t_ref, t_cur)
        _assert_levels(pair, got.level_stats, got.transformation, want, ONE_ATOL, NEAR_TIE)


@pytest.mark.parametrize("streams", [1, 3])
def test_match_prepared_lockstep_iterations_are_the_carrys_count(pairs, streams):
    k = Intrinsics(*K)
    ref = t_dt.prepare_frame(CFG, k, _stacked([p[0] for p in pairs[:streams]]))
    cur = t_dt.prepare_frame(CFG, k, _stacked([p[1] for p in pairs[:streams]]))
    got = t_dt.match_prepared(CFG, k, ref, cur)
    for s in got.level_stats:
        assert s.iterations.dtype == torch.int32 and s.iterations.shape == (streams,)
    for b, (_, _, want) in enumerate(pairs[:streams]):
        stats = [type(s)(*(f[b] for f in s)) for s in got.level_stats]
        _assert_levels(b, stats, got.transformation[b], want, LOCKSTEP_ATOL)


@pytest.mark.parametrize("chunk", [1, 2])
def test_launch_counts_fold_to_the_executed_steps(pairs, monkeypatch, chunk):
    """The eager loop counts its plain evaluations and ``done`` reads as it
    runs; a while graph's chunk counts (kept on the card) for the same
    levels fold into the same totals through ``fold_counts``, and a key
    that is dropped keeps its counts for the next fold."""
    monkeypatch.setattr(t_dt, "CHUNK_STEPS", chunk)
    t_ref, t_cur, _ = pairs[0]
    driver_launches.reset_counts()
    result = t_dt.match_pyramids(CFG, Intrinsics(*K), t_ref, t_cur)
    its = [int(s.iterations) for s in result.level_stats]
    chunks = [-(-it // chunk) for it in its]
    assert t_res.warp_and_sample_cm.calls == t_dt.executed_steps(its, chunk) == chunk * sum(chunks)
    assert t_dt.read_done.calls == sum(chunks)
    assert irls_graph.while_counts.launches == 0

    # the same levels as while graphs: per level one head and its tail
    # chunks, each chunk moving the counter by K, as a capture records
    counter = types.SimpleNamespace(launches=0)
    graphs = []
    for level, n in enumerate(chunks):
        g = irls_graph.graphs_for(("fold", chunk, level), torch.device("cpu"))
        g.tally = irls_graph._Tally(torch.tensor([1, n - 1], dtype=torch.int64),
                                    ([chunk], [chunk]), ((counter, "launches"),))
        graphs.append(g)
    try:
        irls_graph.fold_counts()
        assert counter.launches == t_res.warp_and_sample_cm.calls
        assert irls_graph.while_counts.set_while == sum(chunks)
        irls_graph.fold_counts()  # nothing new on the card
        assert counter.launches == t_res.warp_and_sample_cm.calls
        graphs[0].tally.runs += torch.tensor([1, chunks[0] - 1])  # the first level again
        irls_graph.release(where=lambda key: key[0] == "fold")  # drops, keeps the tallies
        assert all(g.tally is None for g in graphs)
        assert counter.launches == t_res.warp_and_sample_cm.calls
        irls_graph.fold_counts()
        assert counter.launches == t_res.warp_and_sample_cm.calls + chunk * chunks[0]
    finally:
        irls_graph.release(where=lambda key: key[0] == "fold")
        irls_graph.while_counts.set_while = 0


def test_track_sequence_total_iterations():
    frames = synthetic.circular_trajectory(4, radius=0.02, rot_amplitude=0.01)
    iu = np.zeros((len(frames),) + SHAPE, np.uint8)
    du = np.zeros((len(frames),) + SHAPE, np.uint16)
    for t, pose in enumerate(frames):
        i, d, v = synthetic.render_frame(pose, Intrinsics(*K), SHAPE, seed=t, **NOISE)
        iu[t] = np.clip(i, 0, 255).astype(np.uint8)
        du[t] = np.where(v, d * 5000.0, 0).astype(np.uint16)
    d_i, d_d = odometry.upload_sequence(iu, du, torch.device("cpu"))
    results = []
    poses, total, _ = odometry.track_sequence(CFG, Intrinsics(*K), d_i, d_d,
                                              on_result=results.append)
    assert type(total) is int
    assert total == sum(int(s.iterations) for r in results for s in r.level_stats) > 0
    assert poses.shape == (len(frames), 4, 4) and np.isfinite(poses).all()
