"""The port's streaming SLAM front end (``models/streaming``) on the CPU.

- Against the reference: ``StreamingSLAM.track_frontend`` of both packages
  on ``tests/test_streaming.py``'s tiny 30x40 run (10 frames on a 4 cm
  circle, its config) with the benchmark's sensor noise (depth 2 mm,
  intensity 1), the reference compiled once for the module: the accept,
  divergence and force flags and the constraint and pixel counts equal on
  every frame; poses and keyframe transforms within 1e-4, the keyframe
  stream's negative log-likelihood within rtol 1e-5 and its information
  within 1e-5 of its largest entry.  The odometry stream starts at the
  identity warp, where the compiled reference moves pixel-centre ties by
  an ulp (ROADMAP queue C): its transform within 1e-3, its negative
  log-likelihood within rtol 1e-3 and its information within 1e-2 of its
  largest entry, and the frames whose odometry nll parts beyond rtol 1e-5
  are pinned (2 of 8: frames 2 and 4); the entropy ratio, which divides by
  a map's first odometry nll, within 1e-4.
- Against the port's own ``KeyframeTracker`` (``tests/test_streaming.py``'s
  120x160 14-frame case): online poses within 2e-3, keyframes = switches
  + 1, the replayed graph's ATE < 10 mm.
- The pipelined form's records and graph bit-equal to the monolithic one;
  ``pipeline_chunk=1`` refused; ``host_reduce_ingest`` (NumPy and native)
  bit-equal to the reference's; ``ingest_level=1`` records bit-equal to
  ``ingest_level=0``; a frame without valid depth; ``reset()`` after a
  poisoned back end; no host read-back in the frame loop beyond the IRLS
  loop's ``done`` reads; the device rule.
- The stream axis (B streams in lockstep, the reference's vmapped front
  end) on 3 tiny 30x40 streams: each stream's records bit-equal to that
  stream run alone, monolithic and chunked, B = 1 bit-equal to the
  one-stream call; only the IRLS ``done`` reads in its frame loop; and
  why the bootstrap and the pose products go stream by stream (pinned:
  a bootstrap match at B parts from the one-stream matches within 1e-5).
"""

import dataclasses

import numpy as np
import pytest
import torch

from dvo_slam_tpu.config import GraphConfig, KeyframeConfig, SlamConfig, TrackerConfig
from dvo_slam_tpu.models import streaming as j_streaming
from dvo_slam_tpu.ops.camera import Intrinsics

from dvo_slam_tpu_torch import convert, native
from dvo_slam_tpu_torch.models import dense_tracker as t_dense
from dvo_slam_tpu_torch.models import streaming as t_streaming
from dvo_slam_tpu_torch.models.keyframe_tracker import KeyframeTracker
from dvo_slam_tpu_torch.models.streaming import StreamingSLAM, host_reduce_ingest
from dvo_slam_tpu_torch.utils import synthetic, trajectory

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

NOISE = dict(depth_noise=0.002, intensity_noise=1.0)
K_TINY = Intrinsics(40.0, 40.0, 19.5, 14.5)
SHAPE_TINY = (30, 40)
TINY_CFG = SlamConfig(  # tests/test_streaming.py::test_streaming_smoke_tiny
    tracker=TrackerConfig(first_level=1, last_level=0, max_iterations_per_level=15,
                          precision=1e-4, use_initial_estimate=True),
    keyframe=KeyframeConfig(max_translational_distance=0.05, min_entropy_ratio=0.5,
                            min_equation_system_constraint_ratio=0.1),
    graph=GraphConfig(new_constraint_search_radius=5.0,
                      new_constraint_min_entropy_ratio_coarse=0.03,
                      new_constraint_min_entropy_ratio_fine=0.3,
                      min_equation_system_constraint_ratio=0.1, optimization_iterations=10,
                      final_optimization_iterations=20),
)
POSE_ATOL = 1e-4
KF_ATOL = 1e-4
ODO_ATOL = 1e-3
NLL_RTOL = 1e-5
INFO_RTOL = 1e-5  # of the matrix's largest entry
ODO_NLL_RTOL = 1e-3
ODO_INFO_RTOL = 1e-2
RATIO_ATOL = 1e-4
ODO_PARTED_FRAMES = [2, 4]  # identity-seeded odometry streams parting beyond NLL_RTOL

K = Intrinsics(160.0, 160.0, 79.5, 59.5)  # tests/test_streaming.py
SHAPE = (120, 160)
CFG = convert.config_from_reference(SlamConfig(  # tests/test_streaming.py's CFG
    tracker=TrackerConfig(first_level=2, last_level=0, max_iterations_per_level=30,
                          precision=1e-4, use_initial_estimate=True),
    keyframe=KeyframeConfig(max_translational_distance=0.08, min_entropy_ratio=0.6,
                            min_equation_system_constraint_ratio=0.3),
    graph=GraphConfig(new_constraint_search_radius=5.0,
                      new_constraint_min_entropy_ratio_coarse=0.03,
                      new_constraint_min_entropy_ratio_fine=0.3,
                      min_equation_system_constraint_ratio=0.3, optimization_iterations=20,
                      final_optimization_iterations=100, optimization_remove_outliers=True,
                      optimization_outlier_weight_threshold=0.1,
                      final_optimization_remove_outliers=True,
                      final_optimization_outlier_weight_threshold=0.1),
))
KT_ONLINE_ATOL = 2e-3  # tests/test_streaming.py: streaming against the per-frame loop


def _raw_sequence(poses, intrinsics=K, shape=SHAPE):
    """u8 intensity and u16 depth [T, H, W] with the benchmark's noise."""
    t = len(poses)
    iu8 = np.zeros((t,) + shape, np.uint8)
    du16 = np.zeros((t,) + shape, np.uint16)
    for i, pose in enumerate(poses):
        intensity, depth, valid = synthetic.render_frame(pose, intrinsics, shape, seed=i, **NOISE)
        iu8[i] = np.clip(intensity, 0, 255).astype(np.uint8)
        du16[i] = np.where(valid, depth * 5000.0, 0).astype(np.uint16)
    return iu8, du16


def _slam(cfg=CFG, k=K, **kw):
    return StreamingSLAM(k, cfg, device="cpu", **kw)


@pytest.fixture(scope="module")
def tiny_runs():
    """The reference's (compiled) and the port's front end on the tiny run."""
    iu8, du16 = _raw_sequence(
        synthetic.circular_trajectory(10, radius=0.04, rot_amplitude=0.02), K_TINY, SHAPE_TINY)
    ref = j_streaming.StreamingSLAM(K_TINY, TINY_CFG)
    ref_out = ref.track_frontend(iu8, du16)
    ref.graph.shutdown()
    port = _slam(convert.config_from_reference(TINY_CFG), K_TINY)
    out = port.track_frontend(iu8, du16)
    port.graph.shutdown()
    return ref_out, out


def test_tiny_frontend_matches_reference(tiny_runs):
    (ref_records, ref_poses), (records, poses) = tiny_runs
    assert len(records) == len(ref_records) == 10
    parted = []
    for i, (a, b) in enumerate(zip(records, ref_records)):
        assert (a.accept, a.diverged, a.forced) == (b.accept, b.diverged, b.forced), i
        assert (a.kf_n, a.kf_pixels, a.odo_n, a.odo_pixels) == (
            b.kf_n, b.kf_pixels, b.odo_n, b.odo_pixels), i
        np.testing.assert_allclose(a.kf_T, b.kf_T, atol=KF_ATOL, rtol=0)
        np.testing.assert_allclose(a.kf_nll, b.kf_nll, rtol=NLL_RTOL)
        np.testing.assert_allclose(a.kf_info, b.kf_info, rtol=0,
                                   atol=INFO_RTOL * np.abs(b.kf_info).max())
        np.testing.assert_allclose(a.odo_T, b.odo_T, atol=ODO_ATOL, rtol=0)
        np.testing.assert_allclose(a.odo_nll, b.odo_nll, rtol=ODO_NLL_RTOL)
        np.testing.assert_allclose(a.odo_info, b.odo_info, rtol=0,
                                   atol=ODO_INFO_RTOL * np.abs(b.odo_info).max())
        np.testing.assert_allclose(a.entropy_ratio, b.entropy_ratio, atol=RATIO_ATOL, rtol=0)
        if abs(a.odo_nll - b.odo_nll) > NLL_RTOL * abs(b.odo_nll):
            parted.append(i)
    assert parted == ODO_PARTED_FRAMES
    np.testing.assert_allclose(poses, ref_poses, atol=POSE_ATOL, rtol=0)
    # the run switches keyframes and forces the last frame
    assert 0 < sum(not r.accept for r in records[2:]) < 8 and records[-1].forced


def test_matches_keyframe_tracker():
    """tests/test_streaming.py::test_streaming_matches_keyframe_tracker on
    the port: the same online trajectory and keyframe decisions as the
    per-frame host loop, then the replayed graph's accuracy."""
    poses = synthetic.circular_trajectory(14, radius=0.06, rot_amplitude=0.03)
    iu8, du16 = _raw_sequence(poses)
    stamps = np.arange(len(poses)) / 30.0

    kt = KeyframeTracker(K, CFG, use_threading=False, device="cpu")
    kt.init()
    est_ref = []
    for i in range(len(poses)):
        depth = np.where(du16[i] > 0, du16[i].astype(np.float32) / 5000.0, 0.0)
        f = kt.make_frame(iu8[i].astype(np.float32), depth, du16[i] > 0, stamps[i])
        est_ref.append(np.asarray(kt.update(f), np.float64))
    kt.finish()

    ss = _slam()
    records, est = ss.track_frontend(iu8, du16, force_last=False)
    np.testing.assert_allclose(est, np.asarray(est_ref), atol=KT_ONLINE_ATOL, rtol=0)
    n_switches = sum(1 for r in records[2:] if not r.accept)
    assert n_switches >= 1 and len(kt.graph.keyframes) == n_switches + 1

    ss.reset()
    est2 = ss.track_sequence(iu8, du16, stamps, force_last=False)
    g_stamps, g_poses = ss.trajectory()
    assert len(g_stamps) == len(poses)
    assert len(ss.graph.keyframes) == n_switches + 1
    assert trajectory.ate_rmse(g_stamps, g_poses, stamps, poses) < 0.01
    assert trajectory.ate_rmse(stamps, est2, stamps, poses) < 0.01
    ss.graph.shutdown()


def test_pipelined_matches_monolithic():
    """tests/test_streaming.py::test_pipelined_track_sequence_matches_monolithic:
    records, poses and the graph trajectory bit-equal."""
    poses = synthetic.circular_trajectory(13, radius=0.05, rot_amplitude=0.03)
    iu8, du16 = _raw_sequence(poses)
    stamps = np.arange(len(poses)) / 30.0
    ss_a, ss_b = _slam(), _slam()
    est_a = ss_a.track_sequence(iu8, du16, stamps)
    est_b = ss_b.track_sequence(iu8, du16, stamps, pipeline_chunk=5)
    np.testing.assert_array_equal(est_a, est_b)
    assert len(ss_a.records) == len(ss_b.records) == len(poses)
    for a, b in zip(ss_a.records, ss_b.records):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    for a, b in zip(ss_a.trajectory(), ss_b.trajectory()):
        np.testing.assert_array_equal(a, b)
    ss_a.graph.shutdown()
    ss_b.graph.shutdown()


def test_pipeline_chunk_of_one_rejected():
    ss = _slam()
    iu8 = np.zeros((4,) + SHAPE, np.uint8)
    du16 = np.ones((4,) + SHAPE, np.uint16)
    with pytest.raises(ValueError, match="pipeline_chunk"):
        ss.track_sequence(iu8, du16, np.arange(4) / 30.0, pipeline_chunk=1)
    ss.graph.shutdown()


@pytest.mark.parametrize("shape", [(2, 31, 45), (3, 30, 46), (2, 96, 128)])
@pytest.mark.parametrize("levels", [1, 2, 3])
def test_host_reduce_ingest_matches_reference(shape, levels):
    """Bit-equal to the reference's reduction on odd and even shapes; the
    native C++ form where it takes the shape, the NumPy one elsewhere."""
    rng = np.random.default_rng(5)
    iu = rng.integers(0, 256, shape, dtype=np.uint8)
    du = rng.integers(0, 60000, shape, dtype=np.uint16)
    i_ref, d_ref = j_streaming.host_reduce_ingest(iu, du, levels)
    i_out, d_out = host_reduce_ingest(iu, du, levels)
    assert i_out.dtype == np.uint16 and d_out.dtype == np.uint16
    np.testing.assert_array_equal(i_out, i_ref)
    np.testing.assert_array_equal(d_out, d_ref)
    even = all(s % (1 << levels) == 0 for s in shape[1:])
    expected = "native" if even and native.native_available() else "numpy"
    assert host_reduce_ingest.last_path == expected, host_reduce_ingest.last_reason
    if native.native_available() and even:
        a_i, a_d = native.reduce_ingest_native(iu, du, levels)
        np.testing.assert_array_equal(a_i, i_ref)
        np.testing.assert_array_equal(a_d, d_ref)
    with pytest.raises(ValueError, match="levels <= 3"):
        host_reduce_ingest(iu, du, 4)


def test_ingest_level_is_bit_exact():
    """tests/test_streaming.py::test_host_reduced_ingest_is_bit_exact: at
    last_level 1 the host-reduced upload gives the records of the
    full-resolution one, bit for bit."""
    cfg = dataclasses.replace(
        CFG, tracker=dataclasses.replace(CFG.tracker, first_level=2, last_level=1))
    iu8, du16 = _raw_sequence(synthetic.circular_trajectory(8, radius=0.04, rot_amplitude=0.02))
    full = _slam(cfg, ingest_level=0)
    reduced = _slam(cfg)
    assert reduced.ingest_level == 1
    rec_full, poses_full = full.track_frontend(iu8, du16, force_last=False)
    rec_red, poses_red = reduced.track_frontend(iu8, du16, force_last=False)
    np.testing.assert_array_equal(poses_full, poses_red)
    for a, b in zip(rec_full, rec_red):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match="ingest_level"):
        _slam(cfg, ingest_level=2)
    full.graph.shutdown()
    reduced.graph.shutdown()


def test_invalid_frame_mid_sequence():
    """tests/test_streaming.py::test_streaming_survives_invalid_frame_mid_sequence:
    a frame without valid depth forces a switch, the trajectory stays
    finite and relative tracking after it matches the ground truth."""
    poses = synthetic.circular_trajectory(12, radius=0.04, rot_amplitude=0.02)
    iu8, du16 = _raw_sequence(poses)
    du16[6] = 0
    ss = _slam()
    stamps = np.arange(len(poses)) / 30.0
    est = ss.track_sequence(iu8, du16, stamps, force_last=False)
    assert np.isfinite(est).all()
    assert ss.records[6].forced or ss.records[6].diverged or not ss.records[6].accept
    rel_est = np.linalg.inv(est[8]) @ est[11]
    rel_gt = np.linalg.inv(poses[8]) @ poses[11]
    assert np.linalg.norm(rel_est[:3, 3] - rel_gt[:3, 3]) < 0.01
    assert np.isfinite(ss.trajectory()[1]).all()
    ss.graph.shutdown()


def test_reset_after_poisoned_backend_recovers():
    ss = _slam()
    validator = ss.graph.validator
    ss.graph.add(object())  # poison the worker
    ss.graph._queue.join()
    assert ss.graph._poisoned
    ss.reset()  # must not raise
    assert not ss.graph._poisoned and ss.graph.validator is validator and ss.records == []
    ss.graph.shutdown()


def _expected_reads(calls, chunk):
    """The IRLS loop's reads for the recorded matches at K = ``chunk``: per
    level one per chunk of its slowest stream's iterations, ``done.all()``
    in lockstep; one stream reads ``done`` alone at K = 1 and ``done`` with
    its count (one ``tolist``) at larger K."""
    reads = []
    for level_stats in calls:
        for s in level_stats:
            batched = isinstance(s.iterations, torch.Tensor)
            its = int(s.iterations.max()) if batched else s.iterations
            kind = "tolist" if chunk > 1 and not batched else "__bool__"
            reads += [kind] * -(-its // chunk)
    return reads


@pytest.mark.parametrize("chunk", [1, 2, 4])
def test_frame_loop_reads_back_only_the_irls_flags(monkeypatch, chunk):
    """Inside the front end's frame loop the only host reads are the IRLS
    loop's ``done`` flags, one per chunk of K lockstep iterations: every
    read of a tensor to the host is counted with a patch and set against
    the matches' iterations (at K = 1, one ``done`` read per iteration)."""
    monkeypatch.setattr(t_dense, "CHUNK_STEPS", chunk)
    iu8, du16 = _raw_sequence(synthetic.circular_trajectory(6, radius=0.04, rot_amplitude=0.02))
    ss = _slam()
    d_i, d_d = ss._upload(iu8, du16)
    force = torch.zeros(len(iu8), dtype=torch.bool)
    calls = []
    match = t_streaming.match_prepared

    def counted_match(*args, **kwargs):
        result = match(*args, **kwargs)
        calls.append(result.level_stats)
        return result

    reads = []
    for name in ("__bool__", "item", "cpu", "numpy", "tolist", "__int__", "__float__",
                 "__index__"):
        original = getattr(torch.Tensor, name)

        def counted(self, *args, _original=original, _name=name, **kwargs):
            reads.append(_name)
            return _original(self, *args, **kwargs)

        monkeypatch.setattr(torch.Tensor, name, counted)
    monkeypatch.setattr(t_streaming, "match_prepared", counted_match)
    records = ss._run(d_i, d_d, force, torch.eye(4))
    monkeypatch.undo()
    lockstep = sum(int(s.iterations.max()) if isinstance(s.iterations, torch.Tensor)
                   else s.iterations for ls in calls for s in ls)
    assert len(calls) == len(iu8) - 1  # the bootstrap and one dual match per frame
    if chunk == 1:
        assert reads == ["__bool__"] * lockstep
    assert reads == _expected_reads(calls, chunk)
    assert records.shape == (len(iu8), t_streaming.RECORD_WIDTH)
    ss.graph.shutdown()


def test_streaming_asks_for_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingSLAM(K, CFG)
    ss = _slam()
    assert ss.device == torch.device("cpu")
    ss.graph.shutdown()


def test_default_backend_is_the_plain_twin_on_the_cpu():
    assert t_dense._resolve_backend(CFG.tracker, torch.device("cpu")) == "fused"


def _tiny_streams(count=3, frames=10):
    """``count`` tiny streams on circles of 35, 39, 43, ... mm: u8/u16
    [count, frames, 30, 40]."""
    pairs = [_raw_sequence(synthetic.circular_trajectory(frames, radius=0.035 + 0.004 * s,
                                                         rot_amplitude=0.02), K_TINY, SHAPE_TINY)
             for s in range(count)]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


def _front(ingest_level=0, chunked=False):
    return t_streaming.make_streaming_frontend(
        convert.config_from_reference(TINY_CFG), K_TINY, ingest_level=ingest_level,
        chunked=chunked)


def _tensors(iu, du, force_last=True):
    force = np.zeros(iu.shape[:-2], bool)
    if force_last:
        force[..., -1] = True
    init = np.broadcast_to(np.eye(4, dtype=np.float32), iu.shape[:-3] + (4, 4))
    return (torch.from_numpy(iu), torch.from_numpy(du.astype(np.int32)), torch.from_numpy(force),
            torch.from_numpy(init.copy()))


def test_stream_axis_bit_equal_to_solo_runs():
    """B = 3 streams in lockstep (the reference's vmapped front end): each
    stream's [T, 130] records bit-equal to that stream run alone, in the
    monolithic and the chunked form; B = 1 bit-equal to the one-stream
    call.  The switches differ between the streams, so their keyframe
    references part inside the 2B dual match."""
    iu, du = _tiny_streams()
    run = _front()
    records = run(*_tensors(iu, du)).numpy()
    assert records.shape == (3, 10, t_streaming.RECORD_WIDTH)
    solo = [run(*_tensors(iu[b], du[b])).numpy() for b in range(3)]
    for b in range(3):
        np.testing.assert_array_equal(records[b], solo[b])
    accepts = records[:, 2:, 0]
    assert len({tuple(a) for a in accepts}) > 1 and (accepts == 0).any()
    np.testing.assert_array_equal(run(*_tensors(iu[:1], du[:1])).numpy()[0], solo[0])

    run_first, run_cont = _front(chunked=True)
    d_i, d_d, d_f, init = _tensors(iu, du)
    state, first = run_first(d_i[:, :4], d_d[:, :4], d_f[:, :4], init)
    state, rest = run_cont(state, d_i[:, 4:], d_d[:, 4:], d_f[:, 4:])
    np.testing.assert_array_equal(torch.cat([first, rest], dim=1).numpy(), records)


def test_batched_bootstrap_and_pose_products_part_from_solo():
    """Why the lockstep front end bootstraps and composes poses stream by
    stream (ROADMAP queue C): one match at B for the bootstrap, and a
    batched [B, 4, 4] pose product, round otherwise than the one-stream
    forms (the 6x6 solve's batched products against matrix-vector ones,
    its stated 1e-5), so stream b would part from its solo run from
    frame 1 on.  Pinned: the batched bootstrap's transforms differ from the
    one-stream matches' within 1e-5."""
    iu, du = _tiny_streams()
    cfg = convert.config_from_reference(TINY_CFG)
    from dvo_slam_tpu_torch.ops.pyramid import build_pyramid, convert_raw_depth

    def prepared(k):
        depth, valid = convert_raw_depth(torch.from_numpy(du[:, k].astype(np.int32)))
        levels = build_pyramid(torch.from_numpy(iu[:, k]).float(), depth, valid,
                               cfg.tracker.num_levels, skip_below=cfg.tracker.last_level)
        return t_dense.prepare_frame(cfg.tracker, K_TINY, levels)

    f0, f1 = prepared(0), prepared(1)
    batched = t_dense.match_prepared(cfg.tracker, K_TINY, f0, f1).transformation
    single = torch.stack([
        t_dense.match_prepared(cfg.tracker, K_TINY, t_streaming._stream_of(f0, b),
                               t_streaming._stream_of(f1, b)).transformation for b in range(3)])
    assert not torch.equal(batched, single)
    np.testing.assert_allclose(batched.numpy(), single.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("chunk", [1, 2, 4])
def test_stream_axis_reads_back_only_the_irls_flags(monkeypatch, chunk):
    """The B-stream frame loop's only host reads are the IRLS ``done``
    flags: one per chunk of K lockstep iterations of the dual matches and
    of the stream-by-stream bootstrap matches."""
    monkeypatch.setattr(t_dense, "CHUNK_STEPS", chunk)
    iu, du = _tiny_streams(count=2, frames=5)
    run = _front()
    args = _tensors(iu, du)
    calls = []
    match = t_streaming.match_prepared

    def counted_match(*a, **k):
        result = match(*a, **k)
        calls.append(result.level_stats)
        return result

    reads = []
    for name in ("__bool__", "item", "cpu", "numpy", "tolist", "__int__", "__float__",
                 "__index__"):
        original = getattr(torch.Tensor, name)

        def counted(self, *a, _original=original, _name=name, **k):
            reads.append(_name)
            return _original(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, counted)
    monkeypatch.setattr(t_streaming, "match_prepared", counted_match)
    run(*args)
    monkeypatch.undo()
    lockstep = sum(int(s.iterations.max()) if isinstance(s.iterations, torch.Tensor)
                   else s.iterations for ls in calls for s in ls)
    assert len(calls) == 2 + 3  # two bootstrap matches, one dual match per later frame
    if chunk == 1:
        assert reads == ["__bool__"] * lockstep
    assert reads == _expected_reads(calls, chunk)
