"""The port's frames and batched matcher against the reference, on the CPU.

``Frame.from_arrays`` / ``from_raw`` build the reference's pyramids (bit
for bit but the depth channels, within 1e-6: the compiled reference
multiplies the raw depth by 1/5000).  ``BatchedMatcher.match`` and
``match_many`` at n = 1, 2, 3 against the reference's compiled
``BatchedMatcher`` on the frames of
``tests/test_slam.py`` (120x160, levels 2->0): per request and level the
selected pixels, valid constraints, iterations and terminations EQUAL; the
transformation within 1e-4; the information within rtol 1e-3 plus an atol
of 1e-3 of its largest entry; the negative log-likelihood within rtol 1e-4
(the tolerances of ``tests/test_torch_dense_tracker.py``).  The port's
lockstep wave against its one-request calls: counts equal, the estimate
within 1e-5.  The prepared cache: a frame matched twice is prepared once,
``evict`` drops the entry, the artifact range check raises.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvo_slam_tpu.config import TrackerConfig
from dvo_slam_tpu.models import frames as j_frames
from dvo_slam_tpu.ops import se3 as j_se3
from dvo_slam_tpu.ops.camera import Intrinsics
from dvo_slam_tpu.utils import synthetic

from dvo_slam_tpu_torch.convert import config_from_reference, frame_from_reference
from dvo_slam_tpu_torch.models import dense_tracker as t_dt
from dvo_slam_tpu_torch.models import frames as t_frames

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

K = Intrinsics(160.0, 160.0, 79.5, 59.5)  # tests/test_slam.py
SHAPE = (120, 160)
CFG = TrackerConfig(first_level=2, last_level=0, max_iterations_per_level=30, precision=1e-4,
                    use_initial_estimate=True)
T_CFG = config_from_reference(CFG)
POSES = synthetic.linear_trajectory(4, np.array([0.01, 0.0, 0.004]), np.array([0.0, 0.004, 0.0]))


def _raw(pose, seed):
    i, d, v = synthetic.render_frame(pose, K, SHAPE, seed=seed, depth_noise=0.002,
                                     intensity_noise=1.0)
    return (np.clip(i, 0, 255).astype(np.uint8),
            np.where(v, d * 5000.0, 0).astype(np.uint16))


@pytest.fixture(scope="module")
def frames():
    """[(reference Frame, port Frame)] for POSES, from raw u8/u16 images."""
    out = []
    for k, pose in enumerate(POSES):
        iu, du = _raw(pose, k)
        ref = j_frames.Frame.from_raw(iu, du, k / 30.0, CFG.num_levels)
        out.append((ref, t_frames.Frame.from_raw(iu, du, k / 30.0, T_CFG.num_levels,
                                                 device="cpu")))
    return out


DEPTH_FIELDS = ("depth", "zdx", "zdy")


def _levels_equal(port_levels, ref_levels):
    """Every field bit-equal, but the depth channels within 1e-6: compiled,
    the reference's raw conversion multiplies by 1/5000 where the port
    divides by 5000 (an ulp apart)."""
    assert len(port_levels) == len(ref_levels)
    for p, r in zip(port_levels, ref_levels):
        for field, a, b in zip(r._fields, p, r):
            if field in DEPTH_FIELDS:
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6,
                                           err_msg=field)
            else:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=field)


def test_from_raw_and_from_arrays_match_reference(frames):
    for ref, port in frames:
        _levels_equal(port.levels, ref.levels)
        assert port.timestamp == ref.timestamp
    i, d, v = synthetic.render_frame(POSES[1], K, SHAPE, seed=3)
    ref = j_frames.Frame.from_arrays(i, d, v, 0.5, 3)
    _levels_equal(t_frames.Frame.from_arrays(i, d, v, 0.5, 3, device="cpu").levels, ref.levels)
    _levels_equal(frame_from_reference(ref, device="cpu").levels, ref.levels)


def test_from_raw_prepare_for_fills_the_cache(frames):
    iu, du = _raw(POSES[0], 0)
    calls = t_dt.prepare_frame.calls
    frame = t_frames.Frame.from_raw(iu, du, 0.0, T_CFG.num_levels, prepare_for=(T_CFG, K),
                                    device="cpu")
    assert t_dt.prepare_frame.calls == calls + 1
    matcher = t_frames.BatchedMatcher(T_CFG, K)
    prepared = matcher.prepared(frame)
    assert t_dt.prepare_frame.calls == calls + 1
    plain = t_dt.prepare_frame(T_CFG, K, frames[0][1].levels)
    for a, b in zip(prepared, plain):
        for x, y in zip(a, b):
            assert (x is None and y is None) or torch.equal(x, y)


def _counts(result):
    return [tuple(s) for s in result.level_stats]


def _close(port, ref):
    assert _counts(port) == _counts(ref)
    np.testing.assert_allclose(port.transformation, ref.transformation, atol=1e-4)
    np.testing.assert_allclose(port.information, ref.information, rtol=1e-3,
                               atol=1e-3 * np.abs(ref.information).max())
    np.testing.assert_allclose(port.neg_log_likelihood, ref.neg_log_likelihood, rtol=1e-4)


def _init(twist):
    return np.asarray(j_se3.exp_se3(jnp.asarray(twist, jnp.float32)), np.float64)


# (reference index, current index, initial pose twist or None)
REQUESTS = [(0, 1, None), (1, 3, [0.02, 0.0, 0.008, 0.0, 0.008, 0.0]), (0, 2, None)]


@pytest.mark.parametrize("n", [1, 2, 3])
def test_match_many_matches_reference(frames, n):
    reqs = REQUESTS[:n]
    ref_matcher = j_frames.BatchedMatcher(CFG, K)
    port_matcher = t_frames.BatchedMatcher(T_CFG, K)

    def requests(side):
        return [(frames[a][side], frames[b][side], None if t is None else _init(t))
                for a, b, t in reqs]

    ref_results = ref_matcher.match_many(requests(0))
    port_results = port_matcher.match_many(requests(1))
    assert len(port_results) == n
    for port, ref in zip(port_results, ref_results):
        assert isinstance(port, t_frames.HostTrackingResult)
        assert port.transformation.dtype == np.float64 and not port.is_nan()
        _close(port, ref)
        assert port.last_level == port.level_stats[-1]
        assert port.level_stats[0].valid_constraints > 100
    if n == 1:
        _close(port_matcher.match(*requests(1)[0]), ref_results[0])
    else:
        # the lockstep wave against the port's one-request calls
        for req, wave in zip(requests(1), port_results):
            one = port_matcher.match(*req)
            assert _counts(one) == _counts(wave)
            np.testing.assert_allclose(wave.transformation, one.transformation, atol=1e-5)


def test_match_many_one_call_and_one_copy(frames, monkeypatch):
    """One match_prepared_flat call and one device-to-host copy per wave, at
    the wave's size (no padding); each frame prepared once."""
    matcher = t_frames.BatchedMatcher(T_CFG, K)
    port = [f for _, f in frames]
    for f in port:
        matcher.evict(f)
    calls, flats = [], []
    match_flat = t_frames.match_prepared_flat

    def counted_match(cfg, intrinsics, ref, cur, init, host):
        calls.append(tuple(init.shape))
        flat = match_flat(cfg, intrinsics, ref, cur, init, host=host)
        assert host and isinstance(flat, np.ndarray)
        flats.append(tuple(flat.shape))
        return flat

    monkeypatch.setattr(t_frames, "match_prepared_flat", counted_match)
    prepares = t_dt.prepare_frame.calls
    matcher.match_many([(port[0], port[1], None), (port[2], port[1], None),
                        (port[0], port[3], None)])
    assert calls == [(3, 4, 4)] and flats == [(3, 53 + 4 * 3)]
    assert t_dt.prepare_frame.calls == prepares + 4
    matcher.match(port[0], port[1])
    assert calls[-1] == (4, 4) and t_dt.prepare_frame.calls == prepares + 4
    matcher.evict(port[0])
    assert matcher._prep_key not in port[0].__dict__["_prepared"]
    matcher.match(port[0], port[1])
    assert t_dt.prepare_frame.calls == prepares + 5
    assert matcher.match_many([]) == []


def test_artifact_cfg_range_check():
    with pytest.raises(ValueError, match="artifact_cfg level range"):
        t_frames.BatchedMatcher(T_CFG, K, artifact_cfg=dataclasses.replace(T_CFG, first_level=1))
    coarse = dataclasses.replace(T_CFG, last_level=1)
    t_frames.BatchedMatcher(coarse, K, artifact_cfg=T_CFG)


def test_host_result_decoding(frames):
    """The flat layout of one stream and of a lockstep batch decodes to the
    result's fields (float32 values, integer counts)."""
    ref, cur = (t_dt.prepare_frame(T_CFG, K, frames[k][1].levels) for k in (0, 1))
    one = t_dt.match_prepared(T_CFG, K, ref, cur)
    its = one.level_stats[0].iterations  # the carry's count, as the reference's
    assert its.dtype == torch.int32 and its.dim() == 0
    host = t_frames._decode_result(t_dt.flatten_result(one).numpy())
    np.testing.assert_array_equal(host.transformation, one.transformation.numpy())
    np.testing.assert_array_equal(host.information, one.information.numpy())
    assert host.neg_log_likelihood == float(one.neg_log_likelihood)
    assert _counts(host) == [(int(s.valid_pixels), int(s.valid_constraints), int(s.iterations),
                              int(s.termination)) for s in one.level_stats]
    assert host.last_level == host.level_stats[-1] and not host.is_nan()
    nan = host._replace(transformation=np.full((4, 4), np.nan))
    assert nan.is_nan()
    stack = lambda *ps: t_dt.PreparedFrame(*(  # noqa: E731
        tuple(None if x[0] is None else torch.stack(x) for x in zip(*fields))
        for fields in zip(*ps)))
    batched = t_dt.match_prepared(T_CFG, K, stack(ref, ref), stack(cur, cur),
                                  torch.eye(4).expand(2, 4, 4))
    flat = t_dt.flatten_result(batched).numpy()
    assert flat.shape == (2, 53 + 4 * 3)
    for b in range(2):
        host_b = t_frames._decode_result(flat[b])
        assert host_b.level_stats == tuple(t_frames.HostLevelStats(
            int(s.valid_pixels[b]), int(s.valid_constraints[b]), int(s.iterations[b]),
            int(s.termination[b])) for s in batched.level_stats)


def test_stack_frames_and_keyframe(frames):
    port = [f for _, f in frames[:2]]
    stacked = t_frames.stack_frames(port)
    ref = j_frames.stack_frames([f for f, _ in frames[:2]])
    _levels_equal(stacked, ref)
    kf = t_frames.Keyframe(id=3, frame=port[1], pose=np.eye(4))
    assert kf.timestamp == port[1].timestamp and kf.evaluation is None


def test_frames_ask_for_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    iu, du = _raw(POSES[0], 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_frames.Frame.from_raw(iu, du, 0.0, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_frames.Frame.from_arrays(iu.astype(np.float32), du / 5000.0, du > 0, 0.0, 3)


def test_fused_backend_is_the_twin_on_either_device():
    """``kernel_backend="fused"`` names the plain twin on CPU and CUDA
    tensors alike (the reference runs its twin on the accelerator when
    asked); ``auto`` and ``pallas`` take the kernel on the card."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    fused = dataclasses.replace(T_CFG, kernel_backend="fused")
    assert t_dt._resolve_backend(fused, cuda) == t_dt._resolve_backend(fused, cpu) == "fused"
    for backend in ("auto", "pallas"):
        assert t_dt._resolve_backend(dataclasses.replace(T_CFG, kernel_backend=backend),
                                     cuda) == "pallas"
