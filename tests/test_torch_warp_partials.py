"""The pixel-sharded IRLS evaluation (``fused_kernels.warp_fused_partials``)
against the reference, on the CPU.

The port's plain version (``warp_fused_partials_plain`` ->
``sharded_loglik_plain`` -> ``sharded_tail_plain``: the CPU path and the
oracle of the three CUDA launches) is held against the reference's sharded
``evaluate`` (``dvo_slam_tpu/parallel/sharded_alignment.py:76-139``), run
per shard, op by op under ``jax.disable_jit()``: its ``_warp_sample_slice``,
``fused_partials_xla``, and the tail, with the shards' values added in rank
order where the reference psums.  Both get the same inputs: the reference's
refpack and quad table of a numpy-seeded pair of the occluded scene at
60x80 and 120x160, zero-padded and cut into the blocks of 1, 2, 3 and 7
ranks (7 forces padding), the same T and P_prev, ``first`` 0/1.

Tolerances: per pixel, residuals and weights bit-equal (the same float32
operations in the same order); each block's 136 sums and the reduced sums
within 1e-5 of sqrt(G_aa G_bb) (the rounding scale of a float32 dot
product), the count equal; the blocks' sums add up to the whole frame's
within the same bound; the precision, ll, A and b as
``tools/fused_check.compare_warp_fused_stats`` holds them (1e-5 of each
quantity's rounding scale, A's entries within 1e-4 of sqrt(A_aa A_bb)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvo_slam_tpu.config import TrackerConfig
from dvo_slam_tpu.models import dense_tracker as j_dt
from dvo_slam_tpu.ops import pallas_kernels as j_pk
from dvo_slam_tpu.ops import robust as j_robust
from dvo_slam_tpu.ops import se3 as j_se3
from dvo_slam_tpu.ops.camera import Intrinsics
from dvo_slam_tpu.ops.pyramid import build_pyramid
from dvo_slam_tpu.parallel import sharded_alignment as j_sa
from dvo_slam_tpu.utils import synthetic

import dvo_slam_tpu_torch
from dvo_slam_tpu_torch import convert
from dvo_slam_tpu_torch.ops import fused_kernels
from dvo_slam_tpu_torch.ops import residuals as t_res
from dvo_slam_tpu_torch.ops.camera import Intrinsics as TIntrinsics
from dvo_slam_tpu_torch.parallel import multistream as t_ms
from dvo_slam_tpu_torch.tools import fused_check, gather_probe

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

CFG = TrackerConfig(first_level=1, last_level=0)
DOF = CFG.influence_function_param
P_PREV = np.array([[4000.0, 10.0], [10.0, 1.5e5]], np.float32)
WARP = [0.003, -0.002, 0.004, 0.001, 0.002, -0.001]
SUMS_RTOL = 1e-5
# name -> (shape, intrinsics, twist of the current camera, render seed)
SCENES = {
    "60x80": ((60, 80), (80.0, 80.0, 39.5, 29.5), [0.008, -0.004, 0.0, 0.002, 0.0, -0.003], 3),
    "120x160": ((120, 160), (160.0, 160.0, 79.5, 59.5), [-0.01, 0.006, 0.002, 0.0, -0.003, 0.002], 5),
}
WORLDS = (1, 2, 3, 7)


def _exp(twist):
    return np.array(j_se3.exp_se3(jnp.asarray(twist, jnp.float32)))


@pytest.fixture(scope="module")
def scenes():
    """Per scene, level 0 of the reference's prepared pair as NumPy: the
    reference frame's refpack [8, N], the current frame's quad table
    [32, N], the level's shape and intrinsics."""
    out = {}
    for name, (shape, k, twist, seed) in SCENES.items():
        K = Intrinsics(*k)
        prepared = []
        for pose in (np.eye(4), _exp(twist).astype(np.float64)):
            i, d, v = synthetic.render_frame(pose, K, shape, scene=synthetic.occluded_scene(),
                                             seed=seed, depth_noise=0.002, invalid_fraction=0.03)
            levels = build_pyramid(jnp.asarray(i), jnp.asarray(d), jnp.asarray(v), CFG.num_levels)
            prepared.append(j_dt.prepare_frame(CFG, K, levels))
        out[name] = (np.array(prepared[0].refpack[0]), np.array(prepared[1].quad[0]), shape, K)
    return out


def _blocks(refpack, world):
    """The reference's cut: zero-pad to a multiple of ``world`` columns,
    then contiguous column blocks (``sharded_alignment.py:239-246``)."""
    n = refpack.shape[1]
    per = -(-n // world)
    padded = np.pad(refpack, ((0, 0), (0, per * world - n)))
    return [padded[:, r * per:(r + 1) * per] for r in range(world)]


def _reference(blocks, quad, shape, K, T, first):
    """The reference's sharded evaluate, shard by shard -> (each shard's
    ``FusedPartials`` as NumPy, the reduced 136 sums, ``WarpFusedStats``)."""
    P = jnp.asarray(P_PREV)
    with jax.disable_jit():
        p3 = jnp.stack([P[0, 0], P[0, 1], P[1, 1]])
        parts = []
        for block in blocks:
            sampled = j_sa._warp_sample_slice(jnp.asarray(block), jnp.asarray(quad), shape, K,
                                              jnp.asarray(T))
            parts.append(j_pk.fused_partials_xla(sampled, jnp.asarray(block), p3, jnp.int32(first),
                                                 K, DOF))
        full = {}
        for f in ("m00", "m01", "m11", "v", "scale_sum", "num_valid"):  # the psums, in rank order
            full[f] = getattr(parts[0], f)
            for p in parts[1:]:
                full[f] = full[f] + getattr(p, f)
        s, n_total = full["scale_sum"], full["num_valid"]
        sigma = jnp.array([[s[0], s[1]], [s[1], s[2]]], jnp.float32) / jnp.maximum(n_total - 3.0, 1.0)
        precision = j_robust.precision_from_scale(sigma)
        p00, p01, p11 = precision[0, 0], precision[0, 1], precision[1, 1]
        log_sum = 0.0
        for p in parts:
            r_i, r_z = p.residuals[0], p.residuals[1]
            d2 = r_i * (p00 * r_i + p01 * r_z) + r_z * (p01 * r_i + p11 * r_z)
            log_sum = log_sum + jnp.sum(jnp.where(p.weights > 0, jnp.log1p(d2 / DOF), 0.0))
        det = precision[0, 0] * precision[1, 1] - precision[0, 1] * precision[1, 0]
        ll = 0.5 * n_total * jnp.log(jnp.maximum(det, 1e-30)) - 0.5 * (DOF + 2.0) * log_sum
        whole = j_pk.FusedPartials(residuals=None, weights=None, **full)
        A, b = j_pk.assemble_normal_equations(whole, precision)
    sums = np.concatenate([np.asarray(full[f]).reshape(-1) for f, _ in fused_kernels.PACKED_SUMS])
    stats = fused_kernels.WarpFusedStats(
        n=np.asarray(n_total.astype(jnp.int32)), precision=np.asarray(precision),
        ll=np.asarray(ll), A=np.asarray(A), b=np.asarray(b))
    return parts, sums, stats


def _port(blocks, quad, shape, K, T, first):
    """The plain version on the same blocks -> ``sharded_on_one_device``'s
    (results, evaluations, own sums, reduced sums)."""
    steps = (fused_kernels.warp_fused_partials_plain, fused_kernels.sharded_loglik_plain,
             fused_kernels.sharded_tail_plain)
    return fused_check.sharded_on_one_device(
        steps, [torch.from_numpy(np.ascontiguousarray(b)) for b in blocks], torch.from_numpy(quad),
        shape, TIntrinsics(*K), torch.from_numpy(T), torch.from_numpy(P_PREV), bool(first), DOF)


def _as_stats(sums):
    return fused_kernels.sums_as_stats(torch.as_tensor(np.asarray(sums)))


@pytest.mark.parametrize("first", [0, 1])
@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_plain_matches_reference_evaluate(scenes, scene, world, first):
    refpack, quad, shape, K = scenes[scene]
    T = _exp(WARP)
    blocks = _blocks(refpack, world)
    ref_parts, ref_sums, ref_stats = _reference(blocks, quad, shape, K, T, first)
    results, evaluations, own_sums, total = _port(blocks, quad, shape, K, T, first)
    assert int(ref_stats.n) > 0.3 * refpack.shape[1]
    for rank, (ev, ref) in enumerate(zip(evaluations, ref_parts)):
        parts = ev.state[0]
        # per pixel: the same float32 operations, bit for bit
        np.testing.assert_array_equal(parts.residuals.numpy(), np.asarray(ref.residuals))
        np.testing.assert_array_equal(parts.weights.numpy(), np.asarray(ref.weights))
        ref_own = np.concatenate([np.asarray(getattr(ref, f)).reshape(-1)
                                  for f, _ in fused_kernels.PACKED_SUMS])
        if float(ref.num_valid) > 0:
            fused_check.compare_gram(_as_stats(own_sums[rank]), _as_stats(ref_own), rtol=SUMS_RTOL)
    fused_check.compare_gram(_as_stats(total), _as_stats(ref_sums), rtol=SUMS_RTOL)
    for result in results:
        assert result.n.dtype == torch.int32 and result.A.shape == (6, 6)
        worst = fused_check.compare_warp_fused_stats(result, ref_stats)
        assert worst["A_entries"] <= fused_check.GRAM_RTOL
        for x, y in zip(result, results[0]):  # every rank holds the same bits
            assert torch.equal(x, y)


@pytest.mark.parametrize("world", WORLDS[1:])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_shards_add_up_to_the_whole_frame(scenes, scene, world):
    """The blocks' sums, added, are the whole frame's within the rounding
    scale; the padded columns add nothing (their count is the frame's)."""
    refpack, quad, shape, K = scenes[scene]
    T = _exp(WARP)
    _, _, _, whole = _port(_blocks(refpack, 1), quad, shape, K, T, 0)
    results, evaluations, own, total = _port(_blocks(refpack, world), quad, shape, K, T, 0)
    assert sum(e.state[0].residuals.shape[1] for e in evaluations) >= refpack.shape[1]
    assert float(total[135]) == float(whole[135]) == float(own[:, 135].sum())
    fused_check.compare_gram(_as_stats(total), _as_stats(whole), rtol=SUMS_RTOL)


def test_padded_columns_are_masked_with_a_safe_index(scenes):
    """The last rank's zero-padded columns (x = y = z = 0, sel = 0): weight
    0, residuals 0, and a sample index inside the table."""
    refpack, quad, shape, K = scenes["60x80"]
    blocks = _blocks(refpack, 7)
    pad = 7 * blocks[0].shape[1] - refpack.shape[1]
    assert pad > 0 and not blocks[-1][:, -pad:].any()
    ev = fused_kernels.warp_fused_partials_plain(
        torch.from_numpy(np.ascontiguousarray(blocks[-1])), torch.from_numpy(quad), shape,
        TIntrinsics(*K), torch.from_numpy(_exp(WARP)), torch.from_numpy(P_PREV), False, DOF)
    parts = ev.state[0]
    assert not parts.weights[-pad:].any() and not parts.residuals[:, -pad:].any()
    assert torch.isfinite(ev.sums).all()


def test_packed_layout_is_the_all_reduce_layout():
    """``pack_sums`` / ``unpack_sums`` follow ``PACKED_SUMS``, and the
    kernel's own table of the 136 entries (``fused_check.packed_entry``)
    names the same Gram entries."""
    assert sum(int(np.prod(shape)) for _, shape in fused_kernels.PACKED_SUMS) == 136
    assert [name for name, _ in fused_kernels.PACKED_SUMS] == [
        "m00", "m01", "m11", "v", "scale_sum", "num_valid"]
    u = torch.from_numpy(np.random.default_rng(0).normal(size=(16, 50)).astype(np.float32))
    gram = u @ u.T
    m00, m01, m11, v, scale_sum, n = fused_kernels._unpack_gram(gram)
    stats = fused_kernels.FusedStats(m00, m01, m11, v, scale_sum, n, None)
    packed = fused_kernels.pack_sums(stats)
    assert packed.shape == (136,)
    for k in range(136):
        a, b = fused_check.packed_entry(k)
        assert float(packed[k]) == float(gram[a, b]), k
    back = fused_kernels.unpack_sums(packed)
    for name, shape in fused_kernels.PACKED_SUMS:
        assert tuple(back[name].shape) == shape and torch.equal(back[name], getattr(stats, name))
    assert fused_kernels._LAYOUT[8:] == (464, 320, 456)


def test_dispatch_by_device_needs_a_group_and_counts_no_launch(scenes):
    """CPU tensors take the plain version: without a process group the
    first collective raises, after one ``warp_and_sample_cm`` call and no
    kernel launch."""
    refpack, quad, shape, K = scenes["60x80"]
    args = (torch.from_numpy(refpack), torch.from_numpy(quad), shape, TIntrinsics(*K),
            torch.from_numpy(_exp(WARP)), torch.from_numpy(P_PREV), True, DOF)
    launches = fused_kernels.warp_fused_partials_cuda.launches
    calls = t_res.warp_and_sample_cm.calls
    with pytest.raises((RuntimeError, ValueError), match="(?i)process group"):
        fused_kernels.warp_fused_partials(*args)
    assert t_res.warp_and_sample_cm.calls == calls + 1
    assert fused_kernels.warp_fused_partials_cuda.launches == launches
    with pytest.raises(ValueError, match="no implementation"):
        fused_kernels.warp_fused_partials(args[0].to("meta"), *args[1:])


def test_cuda_wrapper_refuses_cpu_tensors_and_wrong_shapes(scenes):
    refpack, quad, shape, K = scenes["60x80"]
    k = TIntrinsics(*K)
    T, P = torch.from_numpy(_exp(WARP)), torch.from_numpy(P_PREV)
    refpack, quad = torch.from_numpy(refpack), torch.from_numpy(quad)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_kernels.warp_fused_partials_cuda(refpack, quad, shape, k, T, P, False)
    with pytest.raises(ValueError, match=r"\[8, N_local\]"):
        fused_kernels.warp_fused_partials_cuda(refpack[None], quad, shape, k, T, P, False)
    with pytest.raises(ValueError, match="a shard of"):
        fused_kernels.warp_fused_partials_cuda(refpack, quad, (shape[0], shape[1] - 1), k, T, P, False)


def test_sharded_checks_fail_when_they_should(scenes):
    """The card's comparisons pass on the plain version against itself and
    fail on a flipped gate, a moved residual, a moved sum and a wrong count."""
    refpack, quad, shape, K = scenes["60x80"]
    block = torch.from_numpy(np.ascontiguousarray(_blocks(refpack, 2)[0]))
    args = (block, torch.from_numpy(quad), shape, TIntrinsics(*K), torch.from_numpy(_exp(WARP)),
            torch.from_numpy(P_PREV), False, DOF)
    stash = fused_check.twin_sharded_stash(*args)
    ev = fused_kernels.warp_fused_partials_plain(*args)
    assert torch.equal(stash[:2], ev.state[0].residuals)
    assert torch.equal(stash[2] > 0.5, ev.state[0].weights > 0)
    assert fused_check.compare_stash(stash, stash.clone(), gate="gate") == (0.0, 0)
    bad = stash.clone()
    bad[2, 0] = 1.0 - bad[2, 0]
    with pytest.raises(RuntimeError, match="gate"):
        fused_check.compare_stash(bad, stash, gate="gate")
    bad = stash.clone()
    bad[0, int(torch.nonzero(stash[2])[0])] += 2e-6
    with pytest.raises(RuntimeError, match="residuals"):
        fused_check.compare_stash(bad, stash, gate="gate")
    exact = fused_check.warp_exact_gram(*args)
    exact_sums = torch.tensor([exact[a, b] if max(a, b) < 14 else float(ev.sums[135])
                               for a, b in map(fused_check.packed_entry, range(136))],
                              dtype=torch.float32)
    n = float(ev.sums[135])
    assert fused_check.compare_packed_sums(exact_sums, exact, n) < 1e-7
    moved = exact_sums.clone()
    moved[3] *= 1.0 + 3e-6
    with pytest.raises(RuntimeError, match="Gram entry"):
        fused_check.compare_packed_sums(moved, exact, n)
    with pytest.raises(RuntimeError, match="num_valid"):
        fused_check.compare_packed_sums(exact_sums, exact, n + 1)


# ------------------------------------------------ entry points ask for the card


@pytest.mark.parametrize("entry", ["levels_from_numpy", "prepared_from_numpy", "as_frames",
                                   "make_inputs", "multistream", "temporal"])
def test_converters_default_to_the_card(monkeypatch, scenes, entry):
    """Without a card each raises unless ``device="cpu"`` is named."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    iu, du = np.zeros((1, 2, 6, 8), np.uint8), np.zeros((1, 2, 6, 8), np.uint16)
    level = tuple(np.zeros((6, 8), np.float32) for _ in range(8))
    prepared = j_dt.PreparedFrame(*([(np.zeros((8, 48), np.float32),)] * len(j_dt.PreparedFrame._fields)))
    cfg = dvo_slam_tpu_torch.TrackerConfig(first_level=1, last_level=0)
    K = TIntrinsics(8.0, 8.0, 3.5, 2.5)
    calls = {
        "levels_from_numpy": lambda **kw: convert.levels_from_numpy([level, None], **kw),
        "prepared_from_numpy": lambda **kw: convert.prepared_from_numpy(prepared, **kw),
        "as_frames": lambda **kw: t_ms.as_frames(iu, du, **kw),
        "make_inputs": lambda **kw: gather_probe.make_inputs(1, 4, 4, **kw),
        "multistream": lambda **kw: t_ms.make_multistream_tracker(cfg, K, **kw)(iu, du),
    }
    if entry == "temporal":
        from dvo_slam_tpu_torch.parallel import temporal

        calls["temporal"] = lambda **kw: temporal.make_temporal_tracker(cfg, K, **kw)(iu[0], du[0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
    if entry in ("levels_from_numpy", "prepared_from_numpy", "as_frames", "make_inputs"):
        out = calls[entry](device="cpu")
        leaf = out[0]
        while not isinstance(leaf, torch.Tensor):
            leaf = leaf[0]
        assert leaf.device == torch.device("cpu")


def test_as_frames_leaves_tensors_where_they_are():
    i, d = torch.zeros((1, 2, 3, 4), dtype=torch.uint8), torch.zeros((1, 2, 3, 4), dtype=torch.int32)
    out_i, out_d = t_ms.as_frames(i, d)
    assert out_i is i and out_d is d
