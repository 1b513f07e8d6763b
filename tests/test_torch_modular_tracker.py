"""The port's modular tracker backend (``kernel_backend="xla"``, and
``auto`` with any configuration other than t-distribution weights and
scale) against the reference's, on the CPU.

- ``match_pyramids`` under the six configurations that ``chip_smoke.py``
  phase 16 drives (the t-distribution on the modular path, Huber with the
  normal scale, Tukey with MAD, Huber with MAD, unit weights and scale,
  ``use_weighting=False``) on a 60x80 pair, two of them also at 120x160,
  against the reference's ``xla`` route run op by op
  (``jax.disable_jit``): per level the valid constraints, iterations and
  terminations equal; the transformation within 1e-5, the negative
  log-likelihood within rtol 1e-5, the information within 1e-4 of its
  largest entry (the Gram and the scale sums are summed in another order,
  and the point transform rounds otherwise by an ulp, see
  ``test_torch_modular.py``).
- ``tests/test_pallas.py::test_fused_match_recovers_motion`` on the
  port's ``xla`` and ``fused`` backends.
- The modular path always depth-buffers its sample, whatever
  ``depth_buffered_sampling`` says, as the reference's does (ROADMAP C).
- B = 3 streams in lockstep under (Huber, MAD) against their solo runs:
  iterations and terminations equal, poses within 1e-5; per evaluation,
  batched against each stream alone, n, the precision, ll, A and b
  bit-equal (ROADMAP C (g), repaired: b is contracted stream by stream).
- ``StreamingSLAM`` on ``tests/test_torch_streaming.py``'s tiny 30x40 run
  under (Huber, MAD) against the reference's compiled front end: flags and
  counts equal on every frame but three, pinned: the odometry counts of
  frames 7 and 8, whose identity-seeded matches part from the compiled
  reference's (there the port equals the reference's op-by-op match;
  ROADMAP C), and the keyframe count
  of frame 9, seeded by frame 8's odometry result (within one
  constraint); poses within 1e-4 before frame 7, 2e-3 from it.
- The routing: ``auto`` runs the modular evaluation exactly for the
  configurations no kernel serves; ``pallas`` and ``fused`` with them
  raise ``ValueError``; the dual match of ``BatchedMatcher`` on modular
  frames.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvo_slam_tpu import config as j_config
from dvo_slam_tpu.models import dense_tracker as j_dt
from dvo_slam_tpu.models import streaming as j_streaming
from dvo_slam_tpu.ops import pyramid as j_pyr
from dvo_slam_tpu.ops import se3 as j_se3
from dvo_slam_tpu.ops.camera import Intrinsics as JIntrinsics
from dvo_slam_tpu.utils import synthetic as j_syn

from dvo_slam_tpu_torch import convert
from dvo_slam_tpu_torch.config import InfluenceFunction, ScaleEstimator, TrackerConfig
from dvo_slam_tpu_torch.models import dense_tracker as t_dt
from dvo_slam_tpu_torch.models.frames import BatchedMatcher, Frame
from dvo_slam_tpu_torch.models.streaming import StreamingSLAM
from dvo_slam_tpu_torch.ops import pyramid as t_pyr
from dvo_slam_tpu_torch.ops import residuals as t_res
from dvo_slam_tpu_torch.ops import se3
from dvo_slam_tpu_torch.ops.camera import Intrinsics
from dvo_slam_tpu_torch.ops.pyramid import build_pyramid
from dvo_slam_tpu_torch.parallel import multistream
from dvo_slam_tpu_torch.utils import synthetic

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

SIZES = {"60x80": ((60, 80), (80.0, 80.0, 39.5, 29.5)),
         "120x160": ((120, 160), (160.0, 160.0, 79.5, 59.5))}
TWIST = [0.01, -0.008, 0.012, 0.004, -0.005, 0.006]
NOISE = dict(depth_noise=0.002, intensity_noise=1.0)
IF, SE = j_config.InfluenceFunction, j_config.ScaleEstimator
BASE = j_config.TrackerConfig(first_level=2, last_level=0, max_iterations_per_level=50,
                              kernel_backend="xla")
# chip_smoke.py phase 16(b)'s configurations
CONFIGS = {
    "tdist": BASE,
    "huber-normal": dataclasses.replace(BASE, influence_function=IF.HUBER,
                                        scale_estimator=SE.NORMAL),
    "tukey-mad": dataclasses.replace(BASE, influence_function=IF.TUKEY, scale_estimator=SE.MAD),
    "huber-mad": dataclasses.replace(BASE, influence_function=IF.HUBER, scale_estimator=SE.MAD),
    "unit-unit": dataclasses.replace(BASE, influence_function=IF.UNIT, scale_estimator=SE.UNIT),
    "no-weighting": dataclasses.replace(BASE, use_weighting=False),
}
CASES = [(name, "60x80") for name in CONFIGS] + [("huber-mad", "120x160"), ("tdist", "120x160")]
T_ATOL = 1e-5
NLL_RTOL = 1e-5
INFO_RTOL = 1e-4  # of the information's largest entry
# lockstep against solo runs: the batched 6x6 solve rounds otherwise (the
# normal equations are each stream's bits: ROADMAP C (g), repaired)
LOCKSTEP_ATOL = 1e-5
# frames of the tiny (Huber, MAD) streaming run whose identity-seeded
# odometry match parts from the compiled reference's (ROADMAP C)
MODULAR_ODO_PARTED_FRAMES = [7, 8]
# frame 8 starts a keyframe from its parted odometry result, which seeds
# frame 9's keyframe match: its count parts by one constraint
MODULAR_KF_SEEDED_BY_PARTED = [9]


def _pair(size, twist=TWIST, noise=NOISE):
    """Both packages' pyramids of a rendered pair (bit-equal levels)."""
    shape, k = SIZES[size]
    T = np.asarray(j_se3.exp_se3(jnp.asarray(twist, jnp.float32)), np.float64)
    out = []
    for pose, seed in ((np.eye(4), 0), (T, 1)):
        i, d, v = j_syn.render_frame(pose, JIntrinsics(*k), shape, seed=seed, **noise)
        out.append((j_pyr.build_pyramid(jnp.asarray(i), jnp.asarray(d), jnp.asarray(v), 3),
                    build_pyramid(*(torch.from_numpy(np.array(a)) for a in (i, d, v)), 3)))
    return out, k, T


def _counts(result):
    return [(int(s.valid_constraints), int(s.iterations), int(s.termination))
            for s in result.level_stats]


@pytest.mark.parametrize("name,size", CASES)
def test_match_pyramids_matches_reference(name, size):
    cfg = CONFIGS[name]
    (ref, cur), k, _ = _pair(size)
    with jax.disable_jit():
        want = j_dt.match_pyramids(cfg, JIntrinsics(*k), ref[0], cur[0])
    calls = t_res.compute_residuals.calls
    got = t_dt.match_pyramids(convert.config_from_reference(cfg), Intrinsics(*k), ref[1], cur[1])
    assert t_res.compute_residuals.calls - calls == sum(s.iterations for s in got.level_stats)
    assert _counts(got) == _counts(want)
    np.testing.assert_allclose(got.transformation.numpy(), np.asarray(want.transformation),
                               rtol=0, atol=T_ATOL)
    np.testing.assert_allclose(float(got.neg_log_likelihood), float(want.neg_log_likelihood),
                               rtol=NLL_RTOL)
    info = np.asarray(want.information)
    np.testing.assert_allclose(got.information.numpy(), info, rtol=0,
                               atol=INFO_RTOL * np.abs(info).max())


@pytest.mark.parametrize("backend", ["xla", "fused"])
def test_fused_match_recovers_motion(backend):
    """tests/test_pallas.py::test_fused_match_recovers_motion on the port."""
    twist = [0.01, -0.008, 0.012, 0.004, -0.005, 0.006]
    T_gt = se3.exp_se3(torch.tensor(twist, dtype=torch.float64)).numpy()
    cfg = TrackerConfig(first_level=1, last_level=0, max_iterations_per_level=30,
                        kernel_backend=backend)
    k = Intrinsics(80.0, 80.0, 39.5, 29.5)
    pyrs = []
    for pose in (np.eye(4), T_gt):
        i, d, v = synthetic.render_frame(pose, k, (60, 80), seed=5, depth_noise=0.002)
        pyrs.append(build_pyramid(*(torch.from_numpy(np.array(a)) for a in (i, d, v)), 2))
    res = t_dt.match_pyramids(cfg, k, *pyrs)
    est = res.transformation.numpy().astype(np.float64)
    err = se3.log_se3(torch.tensor(np.linalg.inv(T_gt) @ est, dtype=torch.float32)).numpy()
    assert np.abs(err).max() < 5e-3, (backend, err)


def test_modular_path_always_depth_buffers():
    """``depth_buffered_sampling=False`` changes the fused path's sample
    and not the modular path's: ``compute_residuals`` depth-buffers
    whatever the flag says, in the reference and in the port (ROADMAP C).
    On the occluded scene the two settings give bit-equal modular results
    in the port and in the reference, while the fused path's differ."""
    k = Intrinsics(80.0, 80.0, 39.5, 29.5)
    scene = j_syn.occluded_scene()
    T = np.asarray(j_se3.exp_se3(jnp.asarray([0.05, 0.0, 0.0, 0.0, 0.03, 0.0])), np.float64)
    pyrs = []
    for pose, seed in ((np.eye(4), 0), (T, 1)):
        i, d, v = j_syn.render_frame(pose, JIntrinsics(*k), (60, 80), scene=scene, seed=seed)
        pyrs.append((j_pyr.build_pyramid(jnp.asarray(i), jnp.asarray(d), jnp.asarray(v), 2),
                     build_pyramid(*(torch.from_numpy(np.array(a)) for a in (i, d, v)), 2)))
    cfg = j_config.TrackerConfig(first_level=1, last_level=0, max_iterations_per_level=20,
                                 precision=1e-4, kernel_backend="xla")
    port, ref = {}, {}
    for backend in ("xla", "fused"):
        for buffered in (True, False):
            c = dataclasses.replace(cfg, kernel_backend=backend, depth_buffered_sampling=buffered)
            port[backend, buffered] = t_dt.match_pyramids(
                convert.config_from_reference(c), k, pyrs[0][1], pyrs[1][1])
            if backend == "xla":
                with jax.disable_jit():
                    ref[buffered] = j_dt.match_pyramids(c, JIntrinsics(*k), pyrs[0][0],
                                                        pyrs[1][0])
    for a, b in ((port["xla", True], port["xla", False]), (ref[True], ref[False])):
        assert _counts(a) == _counts(b)
        np.testing.assert_array_equal(np.asarray(a.transformation), np.asarray(b.transformation))
    assert _counts(port["xla", True]) == _counts(ref[True])
    fused_on, fused_off = port["fused", True], port["fused", False]
    assert (_counts(fused_on) != _counts(fused_off)
            or not torch.equal(fused_on.transformation, fused_off.transformation))


def _streams(streams, frames):
    """u8/u16 [B, T, 60, 80] on circles of different radii."""
    k = Intrinsics(80.0, 80.0, 39.5, 29.5)
    iu = np.zeros((streams, frames, 60, 80), np.uint8)
    du = np.zeros((streams, frames, 60, 80), np.uint16)
    for b in range(streams):
        poses = synthetic.circular_trajectory(frames, radius=0.02 + 0.01 * b)
        for t in range(frames):
            i, d, v = synthetic.render_frame(poses[t], k, (60, 80), seed=7 * b + t, **NOISE)
            iu[b, t] = np.clip(i, 0, 255).astype(np.uint8)
            du[b, t] = np.where(v, d * 5000.0, 0).astype(np.uint16)
    return k, iu, du


def test_lockstep_modular_matches_solo_runs():
    """B = 3 streams in lockstep on the modular path (the reference's
    ``_track_streams_vmapped``): each stream's iterations and
    terminations are its solo run's, poses within 1e-5; the lockstep loop
    runs each level until its slowest stream is done."""
    cfg = TrackerConfig(first_level=1, last_level=0, max_iterations_per_level=15,
                        precision=1e-4, use_initial_estimate=True,
                        influence_function=InfluenceFunction.HUBER,
                        scale_estimator=ScaleEstimator.MAD)
    k, iu, du = _streams(3, 4)
    lock = multistream.make_multistream_tracker(cfg, k, device="cpu").tracks(iu, du)
    solo = multistream.make_multistream_tracker(cfg, k, schedule="sequential",
                                                device="cpu").tracks(iu, du)
    flips = int((lock.iterations != solo.iterations).sum()
                + (lock.termination != solo.termination).sum())
    assert flips == 0
    assert lock.loop_iterations == int(lock.iterations.amax(dim=0).sum()) < solo.loop_iterations
    np.testing.assert_allclose(lock.poses.numpy(), solo.poses.numpy(), rtol=0, atol=LOCKSTEP_ATOL)


def test_lockstep_modular_evaluations_part_only_in_b():
    """ROADMAP C (g), repaired: on the fixture above, every batched modular
    evaluation of the lockstep run, repeated for each stream alone on the
    same warp and previous precision, gives bit-equal n, precision, ll, A
    and b (b is contracted stream by stream in the one-stream call's
    shape; before, the batched contraction parted from it by up to 1.4e-5
    of its largest entry)."""
    from dvo_slam_tpu_torch.tools import fused_check

    cfg = TrackerConfig(first_level=1, last_level=0, max_iterations_per_level=15,
                        precision=1e-4, use_initial_estimate=True,
                        influence_function=InfluenceFunction.HUBER,
                        scale_estimator=ScaleEstimator.MAD)
    k, iu, du = _streams(3, 4)
    with fused_check.solo_evaluations() as rows:
        multistream.make_multistream_tracker(cfg, k, device="cpu").tracks(iu, du)
    assert len({r["solve"] for r in rows}) == 3 * 2  # three frame pairs, two levels
    for field in ("n", "precision", "ll", "A"):
        assert all(all(r[field]) for r in rows), field
    worst = max(max(r["b_scaled"]) for r in rows)
    assert worst == 0, worst


def test_streaming_huber_mad_matches_reference():
    """``StreamingSLAM.track_frontend`` of both packages on the tiny 30x40
    run (``tests/test_torch_streaming.py``) under (Huber, MAD): the
    reference's front end stacks the current frame twice and vmaps the
    modular match; the port's dual match is one lockstep call at B = 2 on
    its acceleration tensors.  Flags equal on every frame, counts on
    every frame but the pinned ones."""
    from dvo_slam_tpu.config import GraphConfig, KeyframeConfig, SlamConfig

    tracker = j_config.TrackerConfig(
        first_level=1, last_level=0, max_iterations_per_level=15, precision=1e-4,
        use_initial_estimate=True, influence_function=IF.HUBER, scale_estimator=SE.MAD)
    cfg = SlamConfig(
        tracker=tracker,
        keyframe=KeyframeConfig(max_translational_distance=0.05, min_entropy_ratio=0.5,
                                min_equation_system_constraint_ratio=0.1),
        graph=GraphConfig(new_constraint_search_radius=5.0),
    )
    k = Intrinsics(40.0, 40.0, 19.5, 14.5)
    poses = synthetic.circular_trajectory(10, radius=0.04, rot_amplitude=0.02)
    iu8 = np.zeros((10, 30, 40), np.uint8)
    du16 = np.zeros((10, 30, 40), np.uint16)
    for i, pose in enumerate(poses):
        intensity, depth, valid = synthetic.render_frame(pose, k, (30, 40), seed=i, **NOISE)
        iu8[i] = np.clip(intensity, 0, 255).astype(np.uint8)
        du16[i] = np.where(valid, depth * 5000.0, 0).astype(np.uint16)
    ref = j_streaming.StreamingSLAM(JIntrinsics(*k), cfg)
    ref_records, ref_poses = ref.track_frontend(iu8, du16)
    ref.graph.shutdown()
    calls = t_res.compute_residuals.calls
    port = StreamingSLAM(k, convert.config_from_reference(cfg), device="cpu")
    records, out_poses = port.track_frontend(iu8, du16)
    port.graph.shutdown()
    assert t_res.compute_residuals.calls > calls
    assert len(records) == len(ref_records) == 10
    parted = []
    for i, (a, b) in enumerate(zip(records, ref_records)):
        assert (a.accept, a.diverged, a.forced) == (b.accept, b.diverged, b.forced), i
        assert (a.kf_pixels, a.odo_pixels) == (b.kf_pixels, b.odo_pixels), i
        if i in MODULAR_KF_SEEDED_BY_PARTED:
            assert abs(a.kf_n - b.kf_n) <= 1, i
        else:
            assert a.kf_n == b.kf_n, i
        if a.odo_n != b.odo_n:
            parted.append(i)
    assert any(not r.accept for r in records[2:])  # the run switches keyframes
    first = MODULAR_ODO_PARTED_FRAMES[0]
    np.testing.assert_allclose(out_poses[:first], ref_poses[:first], rtol=0, atol=1e-4)
    # a parted odometry result anchors the next keyframe's map (frame 8)
    np.testing.assert_allclose(out_poses[first:], ref_poses[first:], rtol=0, atol=2e-3)
    # the identity-seeded odometry stream meets the compiled reference's
    # contracted multiply-adds (ROADMAP C): on the parted frames the port's
    # record is the reference's op-by-op match of the pair
    assert parted == MODULAR_ODO_PARTED_FRAMES
    t_cfg = convert.config_from_reference(tracker)
    for i in parted:
        pyrs = []
        for t in (i - 1, i):
            depth, valid = j_pyr.convert_raw_depth(jnp.asarray(du16[t]))
            pyrs.append(j_pyr.build_pyramid(jnp.asarray(iu8[t]).astype(jnp.float32), depth,
                                            valid, tracker.num_levels))
        with jax.disable_jit():
            op_by_op = j_dt.match_pyramids(tracker, JIntrinsics(*k), *pyrs)
        assert records[i].odo_n == int(op_by_op.last_level.valid_constraints)
        solo = t_dt.match_pyramids(t_cfg, k, *(
            build_pyramid(torch.from_numpy(iu8[t]).float(),
                          *t_pyr.convert_raw_depth(torch.from_numpy(du16[t].astype(np.int32))),
                          tracker.num_levels)
            for t in (i - 1, i)))
        assert _counts(solo) == _counts(op_by_op)


@pytest.mark.parametrize("backend", ["pallas", "fused"])
def test_kernel_backends_refuse_other_configurations(backend):
    pair, k, _ = _pair("60x80")
    cfg = TrackerConfig(first_level=1, last_level=0, kernel_backend=backend,
                        influence_function=InfluenceFunction.HUBER,
                        scale_estimator=ScaleEstimator.MAD)
    with pytest.raises(ValueError, match="requires t-distribution"):
        t_dt.match_pyramids(cfg, Intrinsics(*k), pair[0][1], pair[1][1])
    with pytest.raises(ValueError, match="requires t-distribution"):
        t_dt.match_pyramids(dataclasses.replace(cfg, influence_function=InfluenceFunction.TDISTRIBUTION,
                                                scale_estimator=ScaleEstimator.TDISTRIBUTION,
                                                use_weighting=False),
                            Intrinsics(*k), pair[0][1], pair[1][1])


def test_auto_routes_by_configuration():
    """``auto``: the fused evaluation for t-distribution weights and scale
    (``warp_and_sample_cm`` once per iteration on the CPU), the modular one
    for anything else (``compute_residuals`` once per iteration, no
    ``warp_and_sample_cm``); frames prepared for one path hold its current
    role's artifact only, and the other path refuses them."""
    from dvo_slam_tpu_torch.ops.residuals import warp_and_sample_cm

    pair, k, _ = _pair("60x80")
    k = Intrinsics(*k)
    ref, cur = pair[0][1], pair[1][1]
    tdist = TrackerConfig(first_level=1, last_level=0)
    huber = dataclasses.replace(tdist, influence_function=InfluenceFunction.HUBER)
    for cfg, modular in ((tdist, False), (huber, True)):
        before = (warp_and_sample_cm.calls, t_res.compute_residuals.calls)
        r = t_dt.match_pyramids(cfg, k, ref, cur)
        its = sum(s.iterations for s in r.level_stats)
        assert (warp_and_sample_cm.calls - before[0], t_res.compute_residuals.calls - before[1]) \
            == ((0, its) if modular else (its, 0))
        prepared = t_dt.prepare_frame(cfg, k, cur)
        assert (prepared.accel[1] is not None) == modular == (prepared.quad[1] is None)
        if modular:
            assert prepared.accel[1].shape == (30, 40, 8)
    with pytest.raises(ValueError, match="acceleration tensor"):
        t_dt.match_prepared(huber, k, t_dt.prepare_frame(tdist, k, ref),
                            t_dt.prepare_frame(tdist, k, cur))
    with pytest.raises(ValueError, match="quad table"):
        t_dt.match_prepared(tdist, k, t_dt.prepare_frame(huber, k, ref),
                            t_dt.prepare_frame(huber, k, cur))


def test_batched_matcher_dual_match_on_modular_frames():
    """``BatchedMatcher.match_many`` on frames prepared for the modular
    path: the dual match (two requests on one current frame, its
    acceleration tensor stacked twice) gives each request's single match
    (counts equal, transforms within 1e-5)."""
    k = Intrinsics(80.0, 80.0, 39.5, 29.5)
    cfg = TrackerConfig(first_level=1, last_level=0, max_iterations_per_level=15,
                        influence_function=InfluenceFunction.TUKEY,
                        scale_estimator=ScaleEstimator.MAD)
    poses = synthetic.circular_trajectory(3, radius=0.02)
    frames = []
    for t, pose in enumerate(poses):
        i, d, v = synthetic.render_frame(pose, k, (60, 80), seed=t, **NOISE)
        frames.append(Frame.from_arrays(i, d, v, float(t), cfg.num_levels, device="cpu"))
    matcher = BatchedMatcher(cfg, k)
    dual = matcher.match_many([(frames[0], frames[2], None), (frames[1], frames[2], None)])
    for r, ref in zip(dual, (frames[0], frames[1])):
        one = matcher.match(ref, frames[2])
        assert [tuple(s) for s in r.level_stats] == [tuple(s) for s in one.level_stats]
        np.testing.assert_allclose(r.transformation, one.transformation, rtol=0,
                                   atol=LOCKSTEP_ATOL)
    assert matcher.prepared(frames[2]).quad[0] is None


@pytest.mark.parametrize("first", [0, 1])
def test_kernel_vs_modular_check(monkeypatch, first):
    """``tools/fused_check.compare_modular_to_kernel`` (``chip_smoke.py``
    phase 16(a), ``tests_cuda/test_modular_cuda.py``) with the folded
    kernel's plain version in its place: the fused and the modular
    evaluations of one warp pass its checks at every level of a 120x160
    pair, and a moved Gram entry fails them."""
    from dvo_slam_tpu_torch.ops import fused_kernels
    from dvo_slam_tpu_torch.ops.residuals import warp_and_sample_cm
    from dvo_slam_tpu_torch.tools import fused_check

    def plain_rows(refpack, quad, shape, k, T, P_prev, first, dof=5.0, depth_buffered=True):
        args = (refpack, quad, shape, k, T, P_prev, first, dof, depth_buffered)
        sampled = warp_and_sample_cm(refpack, quad, shape, k, T, depth_buffered=depth_buffered)
        p3 = torch.stack([P_prev[0, 0], P_prev[0, 1], P_prev[1, 1]])
        stats = fused_kernels.fused_stats_plain(
            sampled, refpack, p3, torch.tensor(int(first), dtype=torch.int32), k, dof)
        return (fused_kernels.warp_fused_stats_plain(*args), stats,
                fused_check.twin_stash(*args))

    monkeypatch.setattr(fused_kernels, "warp_fused_stats_rows_cuda", plain_rows)
    pair, k, _ = _pair("120x160")
    cfg = TrackerConfig(first_level=2, last_level=0)
    P_prev = torch.tensor([[4000.0, 10.0], [10.0, 1.5e5]])
    for level in (2, 1, 0):
        errors = fused_check.compare_modular_to_kernel(cfg, Intrinsics(*k), pair[0][1],
                                                       pair[1][1], level, bool(first), P_prev)
        assert errors["n"] == errors["modular_n"] > 0 and errors["mask_differ"] == 0
    def off_rows(*args, **kwargs):
        kernel, stats, stash = plain_rows(*args, **kwargs)
        m00 = stats.m00.clone()
        m00[0, 0] *= 1.01
        return kernel, stats._replace(m00=m00), stash

    monkeypatch.setattr(fused_kernels, "warp_fused_stats_rows_cuda", off_rows)
    with pytest.raises(RuntimeError, match="A_worst_over_tol"):
        fused_check.compare_modular_to_kernel(cfg, Intrinsics(*k), pair[0][1], pair[1][1], 0,
                                              bool(first), P_prev)
