"""The port's multi-stream lockstep odometry and temporal chunking against
the reference and against itself, on the CPU.

Batched layers (one [B, ...] call against B single-stream calls of the
port): the per-pixel ops (sampling, warp) and the fused statistics are
bit-equal, since every op is the same op on one more axis (torch capped at
one thread, so the batched and single Gram products sum in the same
order); the batched 6x6 solve agrees to float32 rounding (its column dot
products are batched matrix products, summed in another order).  Against the reference under
``jax.vmap`` (compiled, so XLA may contract multiply-adds): masks and
counts equal, floats within the atol stated per test.

Trackers: the lockstep and sequential schedules against the reference's
``make_multistream_tracker`` on the scenes of
``tests/test_parallel.py::test_multistream_sequential_matches_lockstep``
(B = 3) and ``::test_multistream_unbuffered_sampling_mode``; poses within
atol 1e-4 (the compiled reference moves the estimate by ~2e-5 against the
port's op-by-op float32).  Lockstep against the port's own single-stream
solve: per stream, frame and level the iterations and terminations equal.
The tracker on a two-rank gloo mesh (child processes) equals the local
run.  The temporal tracker within 1e-4 of the reference's on the scene of
``::test_temporal_tracker_matches_sequential``.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvo_slam_tpu.config import TrackerConfig
from dvo_slam_tpu.ops import interp as j_interp
from dvo_slam_tpu.ops import least_squares as j_ls
from dvo_slam_tpu.ops import pallas_kernels as j_pk
from dvo_slam_tpu.ops import residuals as j_res
from dvo_slam_tpu.ops import se3 as j_se3
from dvo_slam_tpu.ops.camera import Intrinsics
from dvo_slam_tpu.parallel import temporal as j_temporal
from dvo_slam_tpu.parallel.multistream import make_multistream_tracker as j_multistream
from dvo_slam_tpu.utils import synthetic

from dvo_slam_tpu_torch.convert import config_from_reference
from dvo_slam_tpu_torch.models.dense_tracker import match_prepared, prepare_frame
from dvo_slam_tpu_torch.odometry import build_frame
from dvo_slam_tpu_torch.ops import fused_kernels as t_fk
from dvo_slam_tpu_torch.ops import interp as t_interp
from dvo_slam_tpu_torch.ops import least_squares as t_ls
from dvo_slam_tpu_torch.ops import residuals as t_res
from dvo_slam_tpu_torch.ops import se3 as t_se3
from dvo_slam_tpu_torch.parallel import multistream as t_ms
from dvo_slam_tpu_torch.parallel import temporal as t_temporal

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 120
K = Intrinsics(80.0, 80.0, 39.5, 29.5)  # tests/test_parallel.py
SHAPE = (60, 80)
B = 3
POSE_ATOL = 1e-4  # port vs the compiled reference's trackers
# tests/test_parallel.py:264-265 and :423-425
BASE_CFG = dict(first_level=1, last_level=0, max_iterations_per_level=15, precision=1e-4,
                use_initial_estimate=True)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(**kw):
    """The reference's TrackerConfig and the port's, built from it."""
    cfg = TrackerConfig(**kw)
    return cfg, config_from_reference(cfg)


def _streams(streams, frames, noise):
    """The reference tests' streams: u8/u16 [B, T, 60, 80]."""
    iu = np.zeros((streams, frames) + SHAPE, np.uint8)
    du = np.zeros((streams, frames) + SHAPE, np.uint16)
    for b in range(streams):
        poses = synthetic.circular_trajectory(frames, radius=0.02 + 0.01 * b)
        for t in range(frames):
            kw = dict(depth_noise=0.002) if noise else {}
            i_img, d_img, v = synthetic.render_frame(poses[t], K, SHAPE, seed=7 * b + t, **kw)
            iu[b, t] = np.clip(i_img, 0, 255).astype(np.uint8)
            du[b, t] = np.where(v, d_img * 5000.0, 0).astype(np.uint16)
    return iu, du


# name -> (config, streams, noise): tests/test_parallel.py:264-275 and :423-442
TRACKER_SCENES = {
    "buffered": (BASE_CFG, 3, False),
    "unbuffered": (dict(BASE_CFG, depth_buffered_sampling=False), 2, True),
}


@pytest.fixture(scope="module")
def tracker_runs():
    """Per scene: the frames, the port's lockstep and sequential tracks and
    the reference's lockstep poses."""
    out = {}
    for name, (cfg_kw, streams, noise) in TRACKER_SCENES.items():
        cfg, t_cfg = _cfgs(**cfg_kw)
        iu, du = _streams(streams, 4, noise)
        out[name] = dict(
            iu=iu, du=du, cfg=t_cfg,
            lockstep=t_ms.make_multistream_tracker(t_cfg, K).tracks(iu, du),
            sequential=t_ms.make_multistream_tracker(t_cfg, K, schedule="sequential").tracks(iu, du),
            reference=np.asarray(j_multistream(cfg, K)(jnp.asarray(iu), jnp.asarray(du))),
        )
    return out


def _pose_err(a, b):
    rel = np.linalg.inv(np.asarray(a, np.float64)) @ np.asarray(b, np.float64)
    return np.abs(np.asarray(j_se3.log_se3(jnp.asarray(rel, jnp.float32)))).max()


# ---------------------------------------------------------------- batched layers


def _prepared_streams(cfg, streams=B):
    """Each stream's prepared frames 0 and 1 (the reference tests' streams),
    batched: ([B] ref, [B] cur) PreparedFrames."""
    iu, du = _streams(streams, 2, noise=True)
    i, d = t_ms.as_frames(iu, du)
    return tuple(prepare_frame(cfg, K, build_frame(cfg, i[:, t], d[:, t])) for t in (0, 1))


def test_solve_ldlt_batched_matches_single_and_reference():
    """One chain of launches for [B, 6, 6]: each system within 1e-5 of its
    largest entry of the single solve (the dot products inside a column
    are batched matrix products there and vector dots here, summed in
    another order), and of the reference under vmap."""
    rng = np.random.default_rng(0)
    J = rng.normal(size=(5, 40, 6)).astype(np.float32)
    A = np.einsum("bni,bnj->bij", J, J) + 1e-3 * np.eye(6, dtype=np.float32)
    b = rng.normal(size=(5, 6)).astype(np.float32)
    x = t_ls.solve_ldlt(_t(A), _t(b))
    assert x.shape == (5, 6)
    for k in range(5):
        one = t_ls.solve_ldlt(_t(A[k]), _t(b[k]))
        assert float((x[k] - one).abs().max()) <= 1e-5 * float(one.abs().max())
    ref = np.asarray(jax.vmap(j_ls.solve_ldlt)(jnp.asarray(A), jnp.asarray(b)))
    np.testing.assert_allclose(x.numpy(), ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("buffered", [True, False])
def test_sample_quad_batched_and_reference_tuple_sampler(buffered):
    """[B, 32, N] tables with one gather against each stream's own sample
    (bit-equal) and against the reference's tuple-of-tables sampler under
    vmap with ``lockstep_stream_indices`` (validity equal, values atol
    1e-5: the compiled reference contracts the bilinear blend)."""
    cfg = _cfgs(**BASE_CFG)[1]
    _, cur = _prepared_streams(cfg)
    quad = cur.quad[0]  # [B, 32, N]
    h, w = SHAPE
    rng = np.random.default_rng(1)
    n = h * w
    u = (np.tile(np.arange(w, dtype=np.float32), h)[None] + rng.uniform(-1, 2, (B, 1))).astype(np.float32)
    v = (np.repeat(np.arange(h, dtype=np.float32), w)[None] + rng.uniform(-1, 2, (B, 1))).astype(np.float32)
    z = (1.0 + 0.5 * rng.random((B, n))).astype(np.float32) if buffered else None
    values, valid = t_interp.sample_quad(quad, SHAPE, _t(u), _t(v), None if z is None else _t(z))
    assert values.shape == (B, 8, n) and valid.shape == (B, n)
    for b in range(B):
        one_v, one_ok = t_interp.sample_quad(
            quad[b], SHAPE, _t(u[b]), _t(v[b]), None if z is None else _t(z[b])
        )
        assert torch.equal(values[b], one_v) and torch.equal(valid[b], one_ok)
    tables = tuple(jnp.asarray(quad[b].numpy()) for b in range(B))
    streams = j_interp.lockstep_stream_indices(B)
    ref_v, ref_ok = jax.vmap(
        lambda s, uu, vv, zz: j_interp.bilinear_sample_quad_cm(
            tables, SHAPE, uu, vv, z_expected=zz, stream_index=s)
    )(streams, jnp.asarray(u), jnp.asarray(v), None if z is None else jnp.asarray(z))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_ok))
    np.testing.assert_allclose(values.numpy(), np.asarray(ref_v), atol=1e-5)
    assert valid.float().mean() > 0.5


@pytest.mark.parametrize("buffered", [True, False])
def test_warp_and_sample_batched_and_reference(buffered):
    """T [B, 4, 4], refpack [B, 8, N], quad [B, 32, N] -> sampled [B, 8, N]:
    bit-equal to each stream's warp; against the reference's
    ``stream_index`` lockstep under vmap, the validity channel equal and
    the rest within atol 1e-4 (the compiled warp moves u, v by an ulp)."""
    cfg = _cfgs(**BASE_CFG)[1]
    ref, cur = _prepared_streams(cfg)
    twists = np.array([[0.004 * (b - 1), 0.002, -0.001, 0.001, -0.002 * b, 0.003]
                       for b in range(B)], np.float32)
    T = t_se3.exp_se3(_t(twists))
    sampled = t_res.warp_and_sample_cm(ref.refpack[0], cur.quad[0], SHAPE, K, T,
                                       depth_buffered=buffered)
    for b in range(B):
        one = t_res.warp_and_sample_cm(ref.refpack[0][b], cur.quad[0][b], SHAPE, K, T[b],
                                       depth_buffered=buffered)
        assert torch.equal(sampled[b], one)
    tables = tuple(jnp.asarray(cur.quad[0][b].numpy()) for b in range(B))
    ref_sampled = jax.vmap(
        lambda rp, tt, s: j_res.warp_and_sample_cm(
            rp, tables, SHAPE, K, tt, stream_index=s, depth_buffered=buffered)
    )(jnp.asarray(ref.refpack[0].numpy()), jnp.asarray(T.numpy()),
      j_interp.lockstep_stream_indices(B))
    ref_sampled = np.asarray(ref_sampled)
    np.testing.assert_array_equal(sampled[:, 6].numpy(), ref_sampled[:, 6])
    np.testing.assert_allclose(sampled.numpy(), ref_sampled, atol=1e-4)


@pytest.mark.parametrize("first", [0, 1])
def test_fused_stats_plain_batched_and_reference(first):
    """The batched plain twin ([B, 16, N] @ [B, N, 16]) against each
    stream's (bit-equal at one thread) and against the reference's
    ``fused_stats_xla`` under vmap (num_valid equal; the Gram entries
    within rtol 1e-4 of sqrt(G_aa G_bb), log_sum rtol 1e-5: the
    tolerances of ``tools/fused_check.py``)."""
    cfg = _cfgs(**BASE_CFG)[1]
    ref, cur = _prepared_streams(cfg)
    T = t_se3.exp_se3(_t(np.array([[0.003, -0.002, 0.004, 0.001, 0.002, -0.001]] * B, np.float32)))
    sampled = t_res.warp_and_sample_cm(ref.refpack[0], cur.quad[0], SHAPE, K, T)
    refpack = ref.refpack[0]
    p3 = _t(np.array([[4000.0, 10.0, 1.5e5]], np.float32) * (1 + 0.1 * np.arange(B))[:, None])
    flag = torch.tensor(first, dtype=torch.int32)
    stats = t_fk.fused_stats_plain(sampled, refpack, p3, flag, K, 5.0)
    for b in range(B):
        one = t_fk.fused_stats_plain(sampled[b], refpack[b], p3[b], flag, K, 5.0)
        for field, x, y in zip(one._fields, stats, one):
            assert torch.equal(x[b], y), (b, field)
    ref_stats = jax.vmap(
        lambda s, r, p: j_pk.fused_stats_xla(s, r, p, jnp.int32(first), K, 5.0)
    )(jnp.asarray(sampled.numpy()), jnp.asarray(refpack.numpy()), jnp.asarray(p3.numpy()))
    np.testing.assert_array_equal(stats.num_valid.numpy(), np.asarray(ref_stats.num_valid))
    diag = np.concatenate([np.diagonal(stats.m00.numpy(), axis1=-2, axis2=-1),
                           np.diagonal(stats.m11.numpy(), axis1=-2, axis2=-1)], axis=-1)
    bound = 1e-4 * diag.max(axis=-1)
    for field in ("m00", "m01", "m11", "v"):
        err = np.abs(getattr(stats, field).numpy() - np.asarray(getattr(ref_stats, field)))
        assert (err.reshape(B, -1).max(axis=-1) <= bound).all(), field
    np.testing.assert_allclose(stats.log_sum.numpy(), np.asarray(ref_stats.log_sum), rtol=1e-5)


def test_match_prepared_batched_returns_batched_stats():
    """B pairs in lockstep: [B]-batched result fields, and per stream the
    single-stream solve's level statistics and iteration trace (a finished
    stream's trace rows stay zero while the others iterate)."""
    cfg = _cfgs(**BASE_CFG)[1]
    ref, cur = _prepared_streams(cfg)
    result = match_prepared(cfg, K, ref, cur, collect_iteration_stats=True)
    assert result.transformation.shape == (B, 4, 4)
    assert result.information.shape == (B, 6, 6)
    assert result.neg_log_likelihood.shape == (B,)
    for b in range(B):
        one = match_prepared(cfg, K, _stream_frame(ref, b), _stream_frame(cur, b),
                             collect_iteration_stats=True)
        for s_b, s_one in zip(result.level_stats, one.level_stats):
            assert s_b.iterations.dtype == torch.int32 and s_b.iterations.shape == (B,)
            assert int(s_b.iterations[b]) == s_one.iterations
            assert int(s_b.termination[b]) == int(s_one.termination)
            assert int(s_b.valid_constraints[b]) == int(s_one.valid_constraints)
            assert int(s_b.valid_pixels[b]) == int(s_one.valid_pixels)
        for t_b, t_one in zip(result.iteration_stats, one.iteration_stats):
            assert t_b.increment.shape == (B, cfg.max_iterations_per_level, 6)
            np.testing.assert_array_equal(t_b.valid_constraints[b].numpy(),
                                          t_one.valid_constraints.numpy())
            np.testing.assert_allclose(t_b.log_likelihood[b].numpy(), t_one.log_likelihood.numpy(),
                                       rtol=1e-6)
        np.testing.assert_allclose(result.transformation[b].numpy(), one.transformation.numpy(),
                                   atol=1e-6)
    assert len({int(s) for s in result.level_stats[-1].iterations}) > 1  # streams finish apart


def _stream_frame(prepared, b):
    """Stream b of a batched PreparedFrame."""
    return type(prepared)(*(
        tuple(None if lv is None else lv[b] for lv in field) for field in prepared
    ))


# ---------------------------------------------------------------- trackers


@pytest.mark.parametrize("scene", sorted(TRACKER_SCENES))
@pytest.mark.parametrize("schedule", ["lockstep", "sequential"])
def test_tracker_matches_reference(tracker_runs, scene, schedule):
    run = tracker_runs[scene]
    poses = run[schedule].poses.numpy()
    streams = run["iu"].shape[0]
    assert poses.shape == (streams, 3, 4, 4) == run["reference"].shape
    np.testing.assert_allclose(poses, run["reference"], atol=POSE_ATOL)
    for b in range(streams):
        for t in range(3):
            assert _pose_err(run["reference"][b, t], poses[b, t]) < POSE_ATOL


@pytest.mark.parametrize("scene", sorted(TRACKER_SCENES))
def test_lockstep_counts_equal_single_stream(tracker_runs, scene):
    """Per stream, frame and level: the lockstep loop's iterations and
    terminations are the single-stream solve's (``match_pyramids``); the
    loop runs each level until its slowest stream is done."""
    lock, seq = tracker_runs[scene]["lockstep"], tracker_runs[scene]["sequential"]
    assert lock.iterations.shape == seq.iterations.shape == (lock.poses.shape[0], 3, 2)
    assert torch.equal(lock.iterations, seq.iterations)
    assert torch.equal(lock.termination, seq.termination)
    assert lock.loop_iterations == int(lock.iterations.amax(dim=0).sum())
    assert seq.loop_iterations == int(seq.iterations.sum())
    assert lock.loop_iterations < seq.loop_iterations
    np.testing.assert_allclose(lock.poses.numpy(), seq.poses.numpy(), atol=1e-5)


def test_unbuffered_mode_tracks_like_buffered(tracker_runs):
    """tests/test_parallel.py:443-455: the unbuffered lockstep tracks the
    clean scene to within 5e-3 of the buffered run."""
    run = tracker_runs["unbuffered"]
    cfg = _cfgs(**BASE_CFG)[1]
    buffered = t_ms.make_multistream_tracker(cfg, K)(run["iu"], run["du"]).numpy()
    for b in range(2):
        for t in range(3):
            assert _pose_err(buffered[b, t], run["lockstep"].poses[b, t].numpy()) < 5e-3


def test_unknown_schedule_and_mesh_axis():
    with pytest.raises(ValueError, match="unknown schedule"):
        t_ms.make_multistream_tracker(_cfgs()[1], K, schedule="interleaved")
    from dvo_slam_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh(None, "streams", 0, 1, torch.device("cpu"))
    with pytest.raises(ValueError, match="mesh axis"):
        t_ms.make_multistream_tracker(_cfgs()[1], K, mesh)


def test_as_frames_widens_u16():
    i, d = t_ms.as_frames(np.zeros((1, 2, 3, 4), np.uint8), np.full((1, 2, 3, 4), 65535, np.uint16))
    assert i.dtype == torch.uint8 and d.dtype == torch.int32 and int(d.max()) == 65535


# ---------------------------------------------------------------- temporal


@pytest.mark.parametrize("frames,chunks", [(9, 4), (10, 4), (2, 3), (17, 8), (5, 1)])
def test_chunk_sequence_bit_equal(frames, chunks):
    rng = np.random.default_rng(frames)
    iu = rng.integers(0, 255, (frames, 2, 3), dtype=np.uint8)
    du = rng.integers(0, 65535, (frames, 2, 3), dtype=np.uint16)
    ref = j_temporal.chunk_sequence(iu, du, chunks)
    mine = t_temporal.chunk_sequence(iu, du, chunks)
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a, b)
    as_tensors = t_temporal.chunk_sequence(torch.from_numpy(iu), torch.from_numpy(du.astype(np.int32)),
                                           chunks)
    np.testing.assert_array_equal(as_tensors[0].numpy(), ref[0])
    np.testing.assert_array_equal(as_tensors[1].numpy(), ref[1].astype(np.int32))


def test_chunk_sequence_needs_two_frames():
    with pytest.raises(ValueError, match="2 frames"):
        t_temporal.chunk_sequence(np.zeros((1, 2, 2)), np.zeros((1, 2, 2)), 2)


@pytest.mark.parametrize("total", [8, 7, 5])
def test_compose_chunks_bit_equal(total):
    rng = np.random.default_rng(total)
    chunk_abs = np.stack([
        np.stack([np.asarray(j_se3.exp_se3(jnp.asarray(rng.normal(0, 0.05, 6), jnp.float32)),
                             np.float64) for _ in range(2)])
        for _ in range(4)
    ])
    np.testing.assert_array_equal(t_temporal.compose_chunks(chunk_abs, total),
                                  j_temporal.compose_chunks(chunk_abs, total))


@pytest.fixture(scope="module")
def temporal_scene():
    """tests/test_parallel.py:228-238: 9 frames, one scene, a constant step."""
    frames = 9
    step = np.asarray(j_se3.exp_se3(jnp.asarray([0.006, -0.003, 0.0, 0.0, 0.0, 0.004],
                                                jnp.float32)), np.float64)
    poses = [np.eye(4)]
    for _ in range(1, frames):
        poses.append(poses[-1] @ step)
    iu = np.zeros((frames,) + SHAPE, np.uint8)
    du = np.zeros((frames,) + SHAPE, np.uint16)
    for t in range(frames):
        i_img, d_img, v_img = synthetic.render_frame(poses[t], K, SHAPE, seed=5)
        iu[t] = np.clip(i_img, 0, 255).astype(np.uint8)
        du[t] = np.where(v_img, d_img * 5000.0, 0).astype(np.uint16)
    return iu, du, np.stack(poses)


def test_temporal_tracker_matches_reference(temporal_scene):
    iu, du, poses = temporal_scene
    cfg, t_cfg = _cfgs(first_level=1, last_level=0, max_iterations_per_level=15)
    ref = j_temporal.make_temporal_tracker(cfg, K, None, num_chunks=4)(jnp.asarray(iu), jnp.asarray(du))
    mine = t_temporal.make_temporal_tracker(t_cfg, K, num_chunks=4)(iu, du)
    assert mine.shape == (8, 4, 4) and mine.dtype == np.float64
    np.testing.assert_allclose(mine, ref, atol=1e-4)
    seq = t_ms.make_multistream_tracker(t_cfg, K)(iu[None], du[None])[0].numpy()
    for t in range(8):
        assert _pose_err(seq[t], mine[t]) < 1e-3  # tests/test_parallel.py:251
        assert _pose_err(poses[t + 1], mine[t]) < 8e-3


# ---------------------------------------------------------------- two gloo ranks

# One rank of the port.  argv: work directory, rank.
_CHILD = r"""
import json, sys, warnings
sys.modules["jax"] = None  # the port's multi-rank path needs no JAX
import numpy as np
import torch
torch.set_num_threads(1)
from dvo_slam_tpu_torch.config import TrackerConfig
from dvo_slam_tpu_torch.ops.camera import Intrinsics
from dvo_slam_tpu_torch.parallel import distributed, mesh as mesh_lib
from dvo_slam_tpu_torch.parallel.multistream import make_multistream_tracker
from dvo_slam_tpu_torch.parallel.temporal import make_temporal_tracker

work, rank = sys.argv[1], int(sys.argv[2])
spec = json.load(open(f"{work}/spec.json"))
data = np.load(f"{work}/inputs.npz")
K = Intrinsics(*spec["K"])
cfg = TrackerConfig(**spec["cfg"])
distributed.initialize(init_method=f"file://{work}/store", world_size=2, rank=rank, backend="gloo")
mesh = mesh_lib.make_mesh(2)
out = {}
for schedule in ("lockstep", "sequential"):
    tracks = make_multistream_tracker(cfg, K, mesh, schedule=schedule).tracks(data["iu"], data["du"])
    out[schedule + "/poses"] = tracks.poses.numpy()
    out[schedule + "/iterations"] = tracks.iterations.numpy()
    out[schedule + "/termination"] = tracks.termination.numpy()
    out[schedule + "/loop"] = np.array(tracks.loop_iterations)
with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter("always")
    run = make_temporal_tracker(cfg, K, mesh, num_chunks=3)
out["temporal/warned"] = np.array(any("shrinking" in str(w.message) for w in caught))
out["temporal/poses"] = run(data["t_iu"], data["t_du"])
np.savez(f"{work}/out_r{rank}.npz", **out)
distributed.shutdown()
print("rank", rank, "done")
"""


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, temporal_scene):
    """Two gloo ranks in child processes: the unbuffered scene's streams
    (one each) through both schedules, and the temporal scene in 3 chunks
    (the mesh shrinks to one rank)."""
    work = tmp_path_factory.mktemp("ms_ranks")
    cfg_kw, streams, noise = TRACKER_SCENES["unbuffered"]
    iu, du = _streams(streams, 4, noise)
    t_iu, t_du, _ = temporal_scene
    np.savez(work / "inputs.npz", iu=iu, du=du, t_iu=t_iu, t_du=t_du)
    cfg = dict(cfg_kw)
    (work / "spec.json").write_text(json.dumps({"K": list(K), "cfg": cfg}))
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen([sys.executable, "-c", _CHILD, str(work), str(rank)], cwd=REPO, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)
    ]
    try:
        for proc in procs:
            log, _ = proc.communicate(timeout=CHILD_TIMEOUT_S)
            assert proc.returncode == 0, log
    except subprocess.TimeoutExpired:
        pytest.fail(f"a rank did not finish within {CHILD_TIMEOUT_S} s")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return (iu, du, _cfgs(**cfg)[1], (t_iu, t_du),
            [np.load(work / f"out_r{rank}.npz") for rank in range(2)])


@pytest.mark.parametrize("schedule", ["lockstep", "sequential"])
def test_dp_tracker_on_two_ranks_equals_local(two_ranks, schedule):
    """Each rank tracks one stream; the all-gathered results on both ranks
    equal the local run of both streams (poses to the last bit for the
    sequential schedule, within 1e-6 for lockstep, whose local run batches
    two streams where each rank has one)."""
    iu, du, cfg, _, outs = two_ranks
    local = t_ms.make_multistream_tracker(cfg, K, schedule=schedule).tracks(iu, du)
    for out in outs:
        np.testing.assert_array_equal(out[schedule + "/iterations"], local.iterations.numpy())
        np.testing.assert_array_equal(out[schedule + "/termination"], local.termination.numpy())
        np.testing.assert_allclose(out[schedule + "/poses"], local.poses.numpy(),
                                   atol=0 if schedule == "sequential" else 1e-6)
    np.testing.assert_array_equal(outs[0][schedule + "/poses"], outs[1][schedule + "/poses"])


def test_temporal_on_two_ranks_shrinks_and_broadcasts(two_ranks):
    """3 chunks over 2 ranks: the chunks run on the first rank (with a
    warning), and both ranks return the local run's trajectory."""
    _, _, cfg, (t_iu, t_du), outs = two_ranks
    local = t_temporal.make_temporal_tracker(cfg, K, num_chunks=3)(t_iu, t_du)
    for out in outs:
        assert bool(out["temporal/warned"])
        np.testing.assert_array_equal(out["temporal/poses"], local)
