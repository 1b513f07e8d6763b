"""The port's ``TwoStageMatcher`` and ``ConstraintProposalValidator``
against the reference, on the CPU, on ``tests/test_constraints.py``'s
fixture: eight noisy 60x80 keyframes on a 12 cm circle,
``TrackerConfig(first_level=1, last_level=0)`` at the benchmark's
precision 1e-4 (at the default 5e-7 the stop test sits at float32's
rounding floor, where the order of a sum decides the iteration count),
each keyframe's evaluation a log-likelihood average of 100.

Keyframes go into the port with ``convert.keyframe_from_reference``.  One
wave of eight proposals (three matchable pairs and one against a frame
with almost no valid depth, each with an identity and a relative
initialization):
- ``TwoStageMatcher.match_pairs``: the four results of every pair with a
  relative initialization against the compiled reference's wave, those of
  every identity-seeded pair against the reference's same solves op by op
  (``jax.disable_jit``): the compiled reference contracts multiply-adds,
  which moves samples taken at the identity warp's pixel centres (ROADMAP
  queue C); level statistics (valid pixels, valid constraints, iterations,
  terminations) equal, transformations within 1e-4;
- the fused validator: the same accepted (reference, current) pairs as the
  compiled reference's, transformations within 1e-4, the pair with the
  empty frame rejected;
- the port's fused wave against its staged path (the oracle): the same
  accepted pairs and directions, transformations within 1e-5 (the staged
  path inverts the backward seed in float64 on the host, the wave in
  float32 on the device, as the reference's do);
- nine pairs run as chunks of eight and one, each within 1e-5 of the pair
  matched alone.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvo_slam_tpu import config as j_config
from dvo_slam_tpu.config import GraphConfig, TrackerConfig
from dvo_slam_tpu.models import constraints as j_con
from dvo_slam_tpu.models import dense_tracker as j_dt
from dvo_slam_tpu.models import frames as j_frames
from dvo_slam_tpu.models.frames import Frame as JFrame
from dvo_slam_tpu.models.frames import Keyframe as JKeyframe
from dvo_slam_tpu.models.frames import TwoStageMatcher as JTwoStage
from dvo_slam_tpu.models.streaming import _ReplayEvaluation
from dvo_slam_tpu.ops import se3 as j_se3
from dvo_slam_tpu.ops.camera import Intrinsics
from dvo_slam_tpu.utils import synthetic

from dvo_slam_tpu_torch import convert
from dvo_slam_tpu_torch.models import constraints as t_con
from dvo_slam_tpu_torch.models import frames as t_frames
from dvo_slam_tpu_torch.ops import se3 as t_se3

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

K = Intrinsics(80.0, 80.0, 39.5, 29.5)
SHAPE = (60, 80)
TCFG = TrackerConfig(first_level=1, last_level=0, use_initial_estimate=True, precision=1e-4)
GCFG = GraphConfig(
    new_constraint_min_entropy_ratio_coarse=0.01,
    new_constraint_min_entropy_ratio_fine=0.1,
)
PAIRS = ((0, 3), (0, 5), (1, 6))  # matchable; (0, 8) is not
REFERENCE_ATOL = 1e-4
STAGED_ATOL = 1e-5
CHUNK_ATOL = 1e-5


@pytest.fixture(scope="module")
def keyframes():
    """(reference keyframes, port keyframes): the eight of the fixture and
    one with 3 % of its depth valid (id 40) last."""
    poses = synthetic.circular_trajectory(8, radius=0.12, rot_amplitude=0.04)
    ref = []
    for i, p in enumerate(poses):
        i_, d_, v_ = synthetic.render_frame(p, K, SHAPE, seed=i, depth_noise=0.002,
                                            intensity_noise=1.0)
        ref.append(JKeyframe(id=i + 1, frame=JFrame.from_arrays(i_, d_, v_, i / 30.0,
                                                                 TCFG.num_levels),
                             pose=p.copy(), evaluation=_ReplayEvaluation(100.0)))
    i_, d_, v_ = synthetic.render_frame(np.eye(4), K, SHAPE, seed=99, depth_noise=0.3,
                                        intensity_noise=40.0, invalid_fraction=0.97)
    ref.append(JKeyframe(id=40, frame=JFrame.from_arrays(i_, d_, v_, 9.9, TCFG.num_levels),
                         pose=np.eye(4), evaluation=_ReplayEvaluation(100.0)))
    return ref, [convert.keyframe_from_reference(k, device="cpu") for k in ref]


def _proposals(module, kfs):
    """The wave: identity and relative proposals per pair (even and odd
    positions), then the empty frame's pair."""
    props = []
    for a, b in PAIRS + ((0, 8),):
        props.append(module.ConstraintProposal.with_identity(kfs[a], kfs[b]))
        props.append(module.ConstraintProposal.with_relative(kfs[a], kfs[b]))
    return props


def _requests(props):
    return [(p.reference.frame, p.current.frame, p.initial_pose) for p in props]


def _matchers():
    port_cfg = convert.config_from_reference(TCFG)
    ref = JTwoStage(j_con.validation_tracker_config(TCFG), j_con.constraint_tracker_config(TCFG), K)
    port = t_frames.TwoStageMatcher(t_con.validation_tracker_config(port_cfg),
                                    t_con.constraint_tracker_config(port_cfg), K)
    return ref, port


def _accepted(props):
    return {(p.reference.id, p.current.id): np.asarray(p.result.transformation) for p in props}


def _op_by_op_pair(matcher, request):
    """The reference's four solves of one pair as its wave computes them,
    one stream at a time and op by op: (coarse forward, coarse backward
    from the float32 inverse seed, fine forward and backward seeded by
    them)."""
    ref = matcher.artifacts.prepared(request[0])
    cur = matcher.artifacts.prepared(request[1])
    with jax.disable_jit():
        seed = jnp.asarray(np.asarray(request[2], np.float32))
        f1 = j_dt.match_prepared(matcher.coarse_cfg, K, ref, cur, seed)
        b1 = j_dt.match_prepared(matcher.coarse_cfg, K, cur, ref, j_se3.inverse(seed))
        f2 = j_dt.match_prepared(matcher.fine_cfg, K, ref, cur, f1.transformation)
        b2 = j_dt.match_prepared(matcher.fine_cfg, K, cur, ref, b1.transformation)
        return tuple(j_frames._decode_result(np.asarray(j_frames._flatten_result(r)))
                     for r in (f1, b1, f2, b2))


@pytest.fixture(scope="module")
def reference_wave(keyframes):
    """The reference's compiled ``match_pairs`` of the wave, its op-by-op
    solves of the identity-seeded pairs, and its fused validation."""
    ref_kfs, _ = keyframes
    matcher, _ = _matchers()
    requests = _requests(_proposals(j_con, ref_kfs))
    quads = matcher.match_pairs(requests)
    op_by_op = {k: _op_by_op_pair(matcher, requests[k]) for k in range(0, len(requests), 2)}
    accepted = j_con.ConstraintProposalValidator(K, GCFG, TCFG).validate(
        _proposals(j_con, ref_kfs))
    return quads, op_by_op, _accepted(accepted)


def _counts(result):
    return [tuple(s) for s in result.level_stats]


def test_configs_match_reference():
    """The stage configs, and the reference's defect kept: both are built
    from ``TrackerConfig()`` defaults, so the base's kernel_backend and
    depth_buffered_sampling do not reach the waves (ROADMAP queue C)."""
    base = dataclasses.replace(TCFG, kernel_backend="fused", depth_buffered_sampling=False,
                               max_iterations_per_level=7, mu=0.05)
    port_base = convert.config_from_reference(base)
    for name in ("validation_tracker_config", "constraint_tracker_config"):
        got = getattr(t_con, name)(port_base)
        assert got == convert.config_from_reference(getattr(j_con, name)(base))
        assert convert.config_to_reference(got, j_config) == getattr(j_con, name)(base)
        assert got.kernel_backend == "auto" and got.depth_buffered_sampling
        assert got.max_iterations_per_level == 100 and got.mu == 0.05
    assert t_con.validation_tracker_config(port_base).last_level == base.first_level


def test_two_stage_matcher_matches_reference(keyframes, reference_wave):
    """Per pair the four results (coarse and fine, forward and backward)
    against the reference's (module docstring)."""
    _, port_kfs = keyframes
    _, matcher = _matchers()
    quads = matcher.match_pairs(_requests(_proposals(t_con, port_kfs)))
    compiled, op_by_op, _ = reference_wave
    assert len(quads) == len(compiled) == 2 * len(PAIRS) + 2
    for k, pair in enumerate(quads):
        want = op_by_op.get(k, compiled[k])
        for r, ref in zip(pair, want):
            assert _counts(r) == _counts(ref), (k, _counts(r), _counts(ref))
            np.testing.assert_allclose(r.transformation, ref.transformation,
                                       atol=REFERENCE_ATOL, rtol=0)


def test_known_identity_seed_ties(keyframes, reference_wave):
    """The compiled reference parts from its own op-by-op solves only on
    identity-seeded streams (pixel-centre samples), and there on some
    results (ROADMAP queue C): pinned so that a change shows."""
    compiled, op_by_op, _ = reference_wave
    differ = [(k, j) for k, quad in op_by_op.items() for j in range(4)
              if _counts(quad[j]) != _counts(compiled[k][j])]
    assert differ and len(differ) < 4 * len(op_by_op), differ


def test_fused_validation_matches_reference(keyframes, reference_wave):
    """The fused validator accepts the reference's pairs, in the same
    directions, the foreign pair rejected; accepted proposals carry their
    refined pose as their initial pose."""
    _, port_kfs = keyframes
    validator = t_con.ConstraintProposalValidator(K, convert.config_from_reference(GCFG),
                                                  convert.config_from_reference(TCFG))
    assert validator.use_fused_wave
    accepted = validator.validate(_proposals(t_con, port_kfs))
    _, _, ref_accepted = reference_wave
    got = _accepted(accepted)
    assert sorted(got) == sorted(ref_accepted) and len(got) > 0
    assert all(40 not in pair for pair in got)
    for pair in got:
        np.testing.assert_allclose(got[pair], ref_accepted[pair], atol=REFERENCE_ATOL, rtol=0)
    for p in accepted:
        np.testing.assert_array_equal(p.initial_pose, np.asarray(p.result.transformation,
                                                                 np.float64))


def test_fused_wave_matches_staged_oracle(keyframes):
    """tests/test_constraints.py::test_fused_wave_matches_staged_oracle and
    ::test_fused_wave_rejects_unmatchable_pair on the port."""
    _, port_kfs = keyframes
    results = []
    for fused in (True, False):
        validator = t_con.ConstraintProposalValidator(K, convert.config_from_reference(GCFG),
                                                      convert.config_from_reference(TCFG))
        validator.use_fused_wave = fused
        results.append(_accepted(validator.validate(_proposals(t_con, port_kfs))))
    fused, staged = results
    assert sorted(fused) == sorted(staged) and len(fused) > 0
    for pair in fused:
        np.testing.assert_allclose(fused[pair], staged[pair], atol=STAGED_ATOL, rtol=0)


def test_backward_seed_is_inverted_in_float32_on_the_device(keyframes):
    """The wave's backward streams start from the float32 inverse of the
    forward seed, computed on the tensors' device (the reference's
    frames.py:529); the staged path inverts in float64 on the host.  The
    relative initializations make the two differ in the last bits."""
    _, port_kfs = keyframes
    _, matcher = _matchers()
    props = _proposals(t_con, port_kfs)
    seeds = []
    original = t_frames.match_prepared_flat

    def spy(cfg, intrinsics, ref, cur, initial, *args, **kwargs):
        seeds.append(initial)
        return original(cfg, intrinsics, ref, cur, initial, *args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_frames, "match_prepared_flat", spy)
        matcher.match_pairs(_requests(props))
    n = len(props)
    coarse = seeds[0]
    assert coarse.shape == (2 * n, 4, 4) and coarse.dtype == torch.float32
    forward = torch.from_numpy(np.stack([np.asarray(p.initial_pose, np.float32) for p in props]))
    assert torch.equal(coarse[:n], forward)
    assert torch.equal(coarse[n:], t_se3.inverse(forward))
    host = np.stack([np.linalg.inv(p.initial_pose).astype(np.float32) for p in props])
    assert not np.array_equal(coarse[n:].numpy(), host)
    np.testing.assert_allclose(coarse[n:].numpy(), host, atol=1e-6)
    # the fine solve is seeded by the coarse transforms, on the device
    assert seeds[1].shape == (2 * n, 4, 4)


def test_two_stage_matcher_chunks_past_eight_pairs(keyframes):
    """tests/test_constraints.py::test_two_stage_matcher_chunks_past_eight_pairs
    with nine pairs: results in request order, each within 1e-5 of the pair
    matched alone, its level statistics equal."""
    _, port_kfs = keyframes
    _, matcher = _matchers()
    reqs = [(port_kfs[a].frame, port_kfs[b].frame, np.eye(4))
            for a in range(4) for b in range(4) if a != b][:9]
    calls = []
    original = t_frames.match_prepared_flat
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_frames, "match_prepared_flat",
                   lambda *a, **k: (calls.append(a[4].shape[0]), original(*a, **k))[1])
        out = matcher.match_pairs(reqs)
    assert calls == [16, 16, 2, 2]  # coarse and fine per chunk, at B = 2n
    assert len(out) == 9
    for k in (0, 8):
        solo = matcher.match_pairs(reqs[k:k + 1])[0]
        for r_big, r_solo in zip(out[k], solo):
            assert r_big.level_stats == r_solo.level_stats
            np.testing.assert_allclose(r_big.transformation, r_solo.transformation,
                                       atol=CHUNK_ATOL)
    for quad in out:
        for r in quad:
            assert np.isfinite(r.transformation).all()
    assert matcher.match_pairs([]) == []


def test_prepared_artifacts_evicted_after_the_wave(keyframes):
    """The LRU keeps at most MAX_CACHED_FRAMES frames' fine artifacts and
    evicts only after a wave (the reference's keyframe_graph.py:375-385:
    during a wave every touched frame is prepared, ROADMAP queue C)."""
    _, port_kfs = keyframes
    validator = t_con.ConstraintProposalValidator(K, convert.config_from_reference(GCFG),
                                                  convert.config_from_reference(TCFG))
    validator.MAX_CACHED_FRAMES = 2
    key = validator.stage2_matcher._prep_key
    for kf in port_kfs:
        validator.stage2_matcher.evict(kf.frame)
    live = []
    original = validator.two_stage.match_pairs

    def counting(requests):
        out = original(requests)
        live.append(sum(key in kf.frame.__dict__.get("_prepared", {}) for kf in port_kfs))
        return out

    validator.two_stage.match_pairs = counting
    validator.validate(_proposals(t_con, port_kfs)[:4])  # frames 0, 3 and 5
    assert live == [3]
    cached = [kf.id for kf in port_kfs if key in kf.frame.__dict__.get("_prepared", {})]
    assert len(cached) == 2 and len(validator._lru) == 2
    assert validator.validate([]) == []
