"""The folded IRLS evaluation (``fused_kernels.warp_fused_stats``) against
the reference, on the CPU.

The port's plain version (``warp_fused_stats_plain``, the CPU path and the
CUDA kernel's oracle) is held against the reference's chain: its
``warp_and_sample_cm`` (``dvo_slam_tpu/ops/residuals.py:130``), then
``fused_stats_xla`` (``ops/pallas_kernels.py:336``), then the tail of
``evaluate_fused`` (``models/dense_tracker.py:329-338``), run op by op
under ``jax.disable_jit()`` as the tracker parity tests run it.  Both get
the same inputs: the reference's ``prepare_frame`` artifacts carried across
by ``convert.prepared_from_numpy``, the same T and P_prev.  60x80 scenes,
numpy-seeded; ``first`` 0/1, depth-buffered sampling on/off, one stream and
B = 3.

Tolerances (``tools/fused_check.compare_warp_fused_stats``, the card's
check): ``n`` equal; the precision's diagonal, ll, A's diagonal within rtol
1e-5, P01 within 1e-5 of sqrt(P00 P11), b_a within 1e-5 of
sqrt(2 n A_aa), and every entry of A within 1e-4 of sqrt(A_aa A_bb).  Per
pixel the two packages compute the same float32 operations; only the Gram
and the log sum are summed in another order, and the off-diagonal and
right-hand-side entries cancel, so an element-wise rtol is no measure of
them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvo_slam_tpu.config import TrackerConfig
from dvo_slam_tpu.models import dense_tracker as j_dt
from dvo_slam_tpu.ops import pallas_kernels as j_pk
from dvo_slam_tpu.ops import residuals as j_res
from dvo_slam_tpu.ops import robust as j_robust
from dvo_slam_tpu.ops import se3 as j_se3
from dvo_slam_tpu.ops.camera import Intrinsics
from dvo_slam_tpu.ops.pyramid import build_pyramid
from dvo_slam_tpu.utils import synthetic

from dvo_slam_tpu_torch.convert import config_from_reference, prepared_from_numpy
from dvo_slam_tpu_torch.models import dense_tracker as t_dt
from dvo_slam_tpu_torch.ops import fused_kernels
from dvo_slam_tpu_torch.ops import residuals as t_res
from dvo_slam_tpu_torch.ops.camera import Intrinsics as TIntrinsics
from dvo_slam_tpu_torch.tools import fused_check

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

K = Intrinsics(80.0, 80.0, 39.5, 29.5)  # tests/test_pallas.py
SHAPE = (60, 80)
CFG = TrackerConfig(first_level=1, last_level=0)
DOF = CFG.influence_function_param
P_PREV = np.asarray([[4000.0, 10.0], [10.0, 1.5e5]], np.float32)
# per stream: (twist of the current camera, render seed, warp twist)
STREAMS = [
    ([0.008, -0.004, 0.0, 0.002, 0.0, -0.003], 3, [0.003, -0.002, 0.004, 0.001, 0.002, -0.001]),
    ([0.009, -0.003, 0.004, 0.002, 0.001, -0.002], 4, [0.0, 0.004, 0.0, -0.002, 0.001, 0.0]),
    ([-0.01, 0.006, 0.002, 0.0, -0.003, 0.002], 5, [-0.006, 0.005, 0.004, -0.001, 0.002, -0.002]),
]


def _exp(twist):
    return np.asarray(j_se3.exp_se3(jnp.asarray(twist, jnp.float32)))


def _prepared_pair(twist, seed):
    """The reference's prepared frames of a frame and its move by exp(twist),
    on the occluded scene (so the depth buffer has work to do)."""
    scene = synthetic.occluded_scene()
    out = []
    for pose in (np.eye(4), _exp(twist).astype(np.float64)):
        i, d, v = synthetic.render_frame(pose, K, SHAPE, scene=scene, seed=seed,
                                         depth_noise=0.002, invalid_fraction=0.03)
        levels = build_pyramid(jnp.asarray(i), jnp.asarray(d), jnp.asarray(v), CFG.num_levels)
        out.append(j_dt.prepare_frame(CFG, K, levels))
    return out


@pytest.fixture(scope="module")
def streams():
    """Per stream: (reference ref/cur PreparedFrames, the warp T [4, 4])."""
    return [(_prepared_pair(twist, seed), _exp(warp)) for twist, seed, warp in STREAMS]


def _reference_chain(refpack, quad, shape, k, T, P_prev, first, depth_buffered):
    """The reference's evaluate_fused on one stream, op by op, as NumPy."""
    with jax.disable_jit():
        sampled = j_res.warp_and_sample_cm(refpack, quad, shape, k, T, depth_buffered=depth_buffered)
        p3 = jnp.stack([P_prev[0, 0], P_prev[0, 1], P_prev[1, 1]])
        stats = j_pk.fused_stats_xla(sampled, refpack, p3, jnp.int32(first), k, DOF)
        denom = jnp.maximum(stats.num_valid - 3.0, 1.0)
        precision = j_robust.precision_from_scale(j_pk.scale_matrix(stats) / denom)
        det = precision[0, 0] * precision[1, 1] - precision[0, 1] * precision[1, 0]
        logdet = jnp.log(jnp.maximum(det, jnp.asarray(1e-38, jnp.float32)))
        ll = 0.5 * stats.num_valid * logdet - 0.5 * (DOF + 2.0) * stats.log_sum
        A, b = j_pk.assemble_normal_equations(stats, precision)
    return fused_kernels.WarpFusedStats(
        n=np.asarray(stats.num_valid.astype(jnp.int32)), precision=np.asarray(precision),
        ll=np.asarray(ll), A=np.asarray(A), b=np.asarray(b),
    )


def _inputs(streams, batch, level):
    """The reference's inputs of one level as NumPy: B streams stacked, or
    stream 0 without a batch axis (B = 0)."""
    picked = streams[:batch] if batch else streams[:1]
    refpack = np.stack([np.asarray(p[0].refpack[level]) for p, _ in picked])
    quad = np.stack([np.asarray(p[1].quad[level]) for p, _ in picked])
    T = np.stack([t for _, t in picked])
    P = np.stack([P_PREV * (1.0 + 0.1 * b) for b in range(len(picked))]).astype(np.float32)
    if not batch:
        refpack, quad, T, P = refpack[0], quad[0], T[0], P[0]
    return refpack, quad, T, P


def _port_args(streams, batch, level, first, buffered):
    """The port's arguments of ``warp_fused_stats*`` for the same inputs:
    the prepared frames carried across by ``convert.prepared_from_numpy``."""
    picked = streams[:batch] if batch else streams[:1]
    refpack = torch.stack([prepared_from_numpy(p[0]).refpack[level] for p, _ in picked])
    quad = torch.stack([prepared_from_numpy(p[1]).quad[level] for p, _ in picked])
    _, _, T, P = _inputs(streams, batch, level)
    if not batch:
        refpack, quad = refpack[0], quad[0]
    shape = (SHAPE[0] >> level, SHAPE[1] >> level)
    return (refpack, quad, shape, TIntrinsics(*K.at_level(level)), torch.from_numpy(T),
            torch.from_numpy(P), bool(first), DOF, buffered)


@pytest.mark.parametrize("buffered", [True, False])
@pytest.mark.parametrize("first", [0, 1])
@pytest.mark.parametrize("batch", [0, 3])
def test_plain_matches_reference_chain(streams, batch, first, buffered):
    """At both levels: B = 0 means one stream without a batch axis."""
    for level in (1, 0):
        args = _port_args(streams, batch, level, first, buffered)
        port = fused_kernels.warp_fused_stats_plain(*args)
        refpack, quad, T, P = _inputs(streams, batch, level)
        k = K.at_level(level)
        if batch:
            refs = [_reference_chain(refpack[b], quad[b], args[2], k, T[b], P[b], first, buffered)
                    for b in range(batch)]
            ref = fused_kernels.WarpFusedStats(*(np.stack(f) for f in zip(*refs)))
        else:
            ref = _reference_chain(refpack, quad, args[2], k, T, P, first, buffered)
        assert port.n.dtype == torch.int32 and port.A.shape == ((batch,) if batch else ()) + (6, 6)
        worst = fused_check.compare_warp_fused_stats(port, ref)
        assert np.asarray(ref.n).min() > 0.3 * args[2][0] * args[2][1], level
        assert worst["A_entries"] <= fused_check.GRAM_RTOL


@pytest.mark.parametrize("buffered", [True, False])
def test_batched_plain_equals_per_stream(streams, buffered):
    """B = 3 in one call against each stream's own call: bit-equal (one
    torch thread, so the batched Gram product sums in the same order)."""
    args = _port_args(streams, 3, 0, 0, buffered)
    batched = fused_kernels.warp_fused_stats_plain(*args)
    for b in range(3):
        one = fused_kernels.warp_fused_stats_plain(
            args[0][b], args[1][b], args[2], args[3], args[4][b], args[5][b], *args[6:])
        for field, x, y in zip(one._fields, batched, one):
            assert torch.equal(x[b], y), (b, field)


@pytest.mark.parametrize("buffered", [True, False])
def test_stash_is_the_reference_residuals(streams, buffered):
    """``fused_check.twin_stash`` (what the kernel's stash is held against)
    equals the reference's per-pixel residuals and mask, bit for bit; the
    stash check passes on it and fails once a residual moves by 2e-6."""
    refpack, quad, T, P = _inputs(streams, 0, 0)
    args = _port_args(streams, 0, 0, 0, buffered)
    stash = fused_check.twin_stash(*args)
    with jax.disable_jit():
        sampled = j_res.warp_and_sample_cm(refpack, quad, SHAPE, K, T, depth_buffered=buffered)
        p3 = jnp.asarray([P[0, 0], P[0, 1], P[1, 1]])
        parts = j_pk.fused_partials_xla(sampled, refpack, p3, jnp.int32(0), K, DOF)
    np.testing.assert_array_equal(stash[:2].numpy(), np.asarray(parts.residuals))
    np.testing.assert_array_equal(stash[2].numpy() > 0.5, np.asarray(parts.weights) > 0)
    assert fused_check.compare_stash(stash, stash.clone()) == (0.0, 0)
    bad = stash.clone()
    bad[1, int(torch.nonzero(stash[2])[0])] += 2e-6
    with pytest.raises(RuntimeError, match="residuals"):
        fused_check.compare_stash(bad, stash)
    bad = stash.clone()
    bad[2, 0] = 1.0 - bad[2, 0]
    with pytest.raises(RuntimeError, match="mask"):
        fused_check.compare_stash(bad, stash)


def test_warp_exact_gram_matches_plain_rows(streams):
    """The float64 Gram the card's check holds the kernel to agrees with the
    plain version's float32 Gram within the sqrt(G_aa G_bb) bound."""
    args = _port_args(streams, 0, 0, 1, True)
    exact = fused_check.warp_exact_gram(*args)
    sampled = t_res.warp_and_sample_cm(args[0], args[1], args[2], args[3], args[4])
    twin = fused_kernels.fused_stats_plain(sampled, args[0], fused_check._p3(args[5]), 1, args[3],
                                           DOF)
    g = fused_check.gram14(twin)
    scale = np.sqrt(np.outer(np.diag(exact), np.diag(exact)))
    assert (np.abs(g - exact) <= fused_check.GRAM_RTOL * scale).all()


def test_compare_warp_fused_stats_catches_errors(streams):
    """The tail check passes on the plain version against itself and fails
    on a changed n, a moved P01, b or A entry, each just past its bound."""
    port = fused_kernels.warp_fused_stats_plain(*_port_args(streams, 0, 0, 0, True))
    assert max(fused_check.compare_warp_fused_stats(port, port).values()) == 0.0
    P00, P11 = float(port.precision[0, 0]), float(port.precision[1, 1])
    A, n = port.A, float(port.n)
    moved = {
        "n": port._replace(n=port.n + 1),
        "precision_offdiagonal": port._replace(precision=port.precision + torch.tensor(
            [[0.0, 2e-5], [2e-5, 0.0]]) * (P00 * P11) ** 0.5),
        "b": port._replace(b=port.b + torch.tensor([0, 0, 2e-5, 0, 0, 0])
                           * float((2.0 * n * A[2, 2]) ** 0.5)),
        "A_entries": port._replace(A=A + torch.eye(6).roll(1, 0) * 2e-4
                                   * float((A[0, 0] * A[1, 1]) ** 0.5)),
        "ll": port._replace(ll=port.ll * (1.0 + 1e-3)),
    }
    for name, bad in moved.items():
        with pytest.raises(RuntimeError, match=name):
            fused_check.compare_warp_fused_stats(bad, port)


def test_dispatch_by_device(streams):
    """CPU tensors take the plain version (bit-equal to it, no kernel
    launch); it calls warp_and_sample_cm once, which counts the call."""
    args = _port_args(streams, 0, 1, 1, True)
    launches = (fused_kernels.warp_fused_stats_cuda.launches,
                fused_kernels.warp_fused_stats_batched_cuda.launches)
    calls = t_res.warp_and_sample_cm.calls
    got = fused_kernels.warp_fused_stats(*args)
    assert t_res.warp_and_sample_cm.calls == calls + 1
    want = fused_kernels.warp_fused_stats_plain(*args)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert launches == (fused_kernels.warp_fused_stats_cuda.launches,
                        fused_kernels.warp_fused_stats_batched_cuda.launches)


def test_cpu_tracker_evaluates_once_per_iteration(streams):
    """The tracker's evaluate is one warp_fused_stats call: on the CPU one
    warp_and_sample_cm per solver iteration."""
    ref, cur = (prepared_from_numpy(p) for p in streams[0][0])
    cfg = config_from_reference(CFG)
    calls = t_res.warp_and_sample_cm.calls
    result = t_dt.match_prepared(cfg, TIntrinsics(*K), ref, cur)
    iterations = sum(s.iterations for s in result.level_stats)
    assert iterations > 2 and t_res.warp_and_sample_cm.calls == calls + iterations


@pytest.mark.parametrize("entry", ["warp_fused_stats_cuda", "warp_fused_stats_batched_cuda",
                                   "warp_fused_stats_rows_cuda"])
def test_cuda_wrappers_raise_on_cpu_tensors(streams, entry):
    batch = 3 if entry == "warp_fused_stats_batched_cuda" else 0
    with pytest.raises(ValueError, match="CUDA tensor"):
        getattr(fused_kernels, entry)(*_port_args(streams, batch, 0, 0, True))


def test_cuda_wrappers_raise_on_wrong_shapes(streams):
    one = _port_args(streams, 0, 0, 0, True)
    three = _port_args(streams, 3, 0, 0, True)
    with pytest.raises(ValueError, match=r"\[8, N\]"):
        fused_kernels.warp_fused_stats_cuda(*three)
    with pytest.raises(ValueError, match=r"\[B, 8, N\]"):
        fused_kernels.warp_fused_stats_batched_cuda(*one)
    with pytest.raises(ValueError, match="does not hold"):
        fused_kernels.warp_fused_stats_cuda(one[0], one[1], (SHAPE[0], SHAPE[1] - 1), *one[3:])
    with pytest.raises(ValueError, match=r"\[8, N\]"):
        fused_kernels.warp_fused_stats_rows_cuda(one[0][None, None], *one[1:])


def test_reference_config_moves_through_convert():
    """The tracker's config for both packages: the port's from the
    reference's, with the depth-buffer switch carried."""
    cfg = config_from_reference(dataclasses.replace(CFG, depth_buffered_sampling=False))
    assert cfg.depth_buffered_sampling is False and cfg.first_level == 1
    assert t_dt._resolve_backend(cfg, torch.device("cpu")) == "fused"
