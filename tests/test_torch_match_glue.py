"""The glue of a match, the same pure functions in both of its forms (the
match graph on the card captures them; level by level the host issues
them), against the reference's glue in ``dvo_slam_tpu/models/
dense_tracker.py:match_prepared`` (``dvo_slam_tpu.ops.se3`` run op by op)
and ``models/frames._flatten_result`` (under ``jax.vmap`` for B streams),
at one stream and B = 3, on the CPU:

- ``match_start``: the first level's start values from a warm start or the
  identity;
- ``next_start``: the next level's from a level's final carry;
- ``level_stats``: the selected pixels counted from the refpack's
  selection row equal the selection mask's count;
- ``match_result`` and ``flatten_result``: the result and its flat row,
  with and without smoothing; ``result_from_row`` gives the result back bit
  for bit;
- the form (``irls_graph.loop_form``): a match runs level by level on the
  CPU, with ``WHILE_GRAPHS`` or ``CUDA_GRAPHS`` off, and with a process
  group; ``match_prepared_flat``
  gives the level-by-level result's row.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvo_slam_tpu.models import dense_tracker as j_dt
from dvo_slam_tpu.models import frames as j_frames
from dvo_slam_tpu.ops import se3 as j_se3

from dvo_slam_tpu_torch.config import TrackerConfig
from dvo_slam_tpu_torch.models import dense_tracker as t_dt
from dvo_slam_tpu_torch.models import irls_graph
from dvo_slam_tpu_torch.ops import se3 as t_se3
from dvo_slam_tpu_torch.ops.camera import Intrinsics
from dvo_slam_tpu_torch.ops.pyramid import build_pyramid

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

ATOL = 1e-6
BATCHES = [(), (3,)]


def _poses(seed, batch):
    """Seeded rigid transforms [*batch, 4, 4], float32, small and large
    rotations both."""
    rng = np.random.default_rng(seed)
    xi = rng.normal(0.0, 0.4, batch + (6,))
    xi[..., 3:] *= rng.choice([0.02, 1.0], batch + (1,))
    return t_se3.exp_se3(torch.from_numpy(xi.astype(np.float32)))


def _carry(seed, batch):
    """A level's final carry with seeded poses, precision and statistics."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    A = rng.normal(0.0, 1.0, batch + (6, 6))
    return t_dt._Carry(
        x=f32(rng.normal(0.0, 1e-3, batch + (6,))),
        T=_poses(seed + 1, batch),
        initial=_poses(seed + 2, batch),
        inc_applied=_poses(seed + 3, batch),
        precision=f32(np.eye(2) * rng.uniform(50.0, 500.0, batch + (1, 1))),
        error=f32(rng.uniform(1.0, 2.0, batch)),
        A=f32(A @ np.swapaxes(A, -1, -2) * 1e4),
        ll=f32(rng.uniform(-2e4, -1e4, batch)),
        n=torch.from_numpy(rng.integers(100, 5000, batch).astype(np.int32)),
        iteration=torch.from_numpy(rng.integers(1, 50, batch).astype(np.int32)),
        termination=torch.from_numpy(rng.integers(0, 5, batch).astype(np.int32)),
        done=torch.ones(batch, dtype=torch.bool),
    )


def _np(t):
    return np.asarray(t)


def _ref(fn, *args, batch=()):
    """The reference's glue ``fn`` on NumPy arguments, op by op, vmapped
    over the streams."""
    with jax.disable_jit():
        f = jax.vmap(fn) if batch else fn
        return jax.tree_util.tree_map(np.asarray, f(*(jnp.asarray(_np(a)) for a in args)))


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("warm", [True, False])
def test_match_start_against_the_reference(batch, warm):
    init = _poses(7, batch) if warm else None
    got = t_dt.match_start(init, batch, torch.float32, torch.device("cpu"))

    def ref(initial):
        # dvo_slam_tpu/models/dense_tracker.py:573-582
        guess = j_se3.inverse(initial) if warm else jnp.eye(4, dtype=jnp.float32)
        return (j_se3.log_se3(guess), j_se3.identity(jnp.float32), guess,
                jnp.eye(2, dtype=jnp.float32))

    want = _ref(ref, init if warm else torch.zeros(batch + (4, 4)), batch=batch)
    for name, a, b in zip(("x", "T", "initial", "precision"), got, want):
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("batch", BATCHES)
def test_next_start_against_the_reference(batch):
    final = _carry(11, batch)
    got = t_dt.next_start(final)

    def ref(inc_applied, T, initial, precision):
        # dvo_slam_tpu/models/dense_tracker.py:610-613
        return j_se3.log_se3(inc_applied), T, initial, precision

    want = _ref(ref, final.inc_applied, final.T, final.initial, final.precision, batch=batch)
    for name, a, b in zip(("x", "T", "initial", "precision"), got, want):
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL, rtol=0, err_msg=name)
    assert all(a is b for a, b in zip(got[1:], (final.T, final.initial, final.precision)))


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("smoothing", [True, False])
def test_result_and_row_against_the_reference(batch, smoothing):
    cfg = TrackerConfig(mu=0.05 if smoothing else 0.0)
    finals = [_carry(20 + level, batch) for level in range(3)]
    refpack = torch.zeros(batch + (8, 300))
    refpack[..., t_dt._SELECTED, ::3] = 1.0
    stats = [t_dt.level_stats(refpack, final) for final in finals]
    result = t_dt.match_result(cfg, finals[-1], stats)
    row = t_dt.flatten_result(result)

    def ref(T, A, ll, initial, counts):
        # dvo_slam_tpu/models/dense_tracker.py:615-625, models/frames.py:194
        if cfg.use_estimate_smoothing:
            prior = cfg.mu * jnp.sum(j_se3.log_se3(initial) ** 2)
        else:
            prior = jnp.zeros((), jnp.float32)
        r = j_dt.TrackingResult(
            transformation=j_se3.inverse(T), information=A * j_dt.INFORMATION_SCALE,
            neg_log_likelihood=-ll + prior,
            level_stats=tuple(j_dt.LevelStats(*c) for c in counts))
        return r, j_frames._flatten_result(r)

    counts = tuple(tuple(s) for s in stats)
    want, want_row = _ref_result(ref, finals[-1], counts, batch)
    np.testing.assert_allclose(result.transformation.numpy(), want.transformation, atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(result.information.numpy(), want.information, rtol=1e-6)
    np.testing.assert_allclose(result.neg_log_likelihood.numpy(), want.neg_log_likelihood,
                               rtol=1e-6)
    assert row.dtype == torch.float32 and tuple(row.shape) == want_row.shape == batch + (65,)
    np.testing.assert_allclose(row.numpy(), want_row, rtol=1e-6, atol=ATOL)
    np.testing.assert_array_equal(row[..., t_dt.FLAT_BASE:].numpy(),
                                  want_row[..., j_frames._FLAT_BASE:])
    assert (row[..., t_dt.FLAT_BASE::4] == 100).all()  # every third of 300 pixels selected
    back = t_dt.result_from_row(row)
    for a, b in zip((back.transformation, back.information, back.neg_log_likelihood),
                    (result.transformation, result.information, result.neg_log_likelihood)):
        assert torch.equal(a, b)
    for a, b in zip(back.level_stats, result.level_stats):
        for f, g in zip(a, b):
            assert f.dtype == g.dtype == torch.int32 and torch.equal(f, g)


def _ref_result(ref, final, counts, batch):
    """The reference's result and row for the port's final carry and level
    statistics (int32 counts, as the reference's carry holds them)."""
    with jax.disable_jit():
        args = (jnp.asarray(final.T.numpy()), jnp.asarray(final.A.numpy()),
                jnp.asarray(final.ll.numpy()), jnp.asarray(final.initial.numpy()),
                tuple(tuple(jnp.asarray(f.numpy()) for f in c) for c in counts))
        out = jax.vmap(ref)(*args) if batch else ref(*args)
    return jax.tree_util.tree_map(np.asarray, out)


def test_level_stats_count_the_selection():
    rng = np.random.default_rng(5)
    cfg = TrackerConfig(first_level=1, last_level=0)
    K = Intrinsics(80.0, 80.0, 39.5, 29.5)
    intensity = torch.from_numpy(rng.uniform(0, 255, (2, 60, 80)).astype(np.float32))
    depth = torch.from_numpy(rng.uniform(0.5, 3.0, (2, 60, 80)).astype(np.float32))
    valid = torch.from_numpy(rng.uniform(0, 1, (2, 60, 80)) > 0.2)
    prepared = t_dt.prepare_frame(cfg, K, build_pyramid(intensity, depth, valid, cfg.num_levels))
    final = _carry(3, (2,))
    for level in (0, 1):
        got = t_dt.level_stats(prepared.refpack[level], final).valid_pixels
        want = prepared.sel[level].sum(dim=(-2, -1), dtype=torch.int32)
        assert got.dtype == torch.int32 and torch.equal(got, want) and int(want.min()) > 0


def test_the_form_is_level_by_level_off_the_card(monkeypatch):
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    # the card with graphs and while graphs on
    assert irls_graph.loop_form(cuda) == ("while", ()) and t_dt.match_graph_form(cuda)
    assert irls_graph.loop_form(cpu) == ("eager", None) and not t_dt.match_graph_form(cpu)
    assert not t_dt.match_graph_form(cuda, ("group", "nccl", 2, 0, 1))
    monkeypatch.setattr(irls_graph, "WHILE_GRAPHS", False)
    assert irls_graph.loop_form(cuda) == ("polled", ()) and not t_dt.match_graph_form(cuda)
    monkeypatch.setattr(irls_graph, "WHILE_GRAPHS", True)
    monkeypatch.setattr(irls_graph, "CUDA_GRAPHS", False)
    assert irls_graph.loop_form(cuda) == ("eager", None) and not t_dt.match_graph_form(cuda)


def test_a_cpu_match_runs_level_by_level(monkeypatch):
    """On the CPU ``match_prepared`` never reaches the match graph, counts no
    match on the card, and ``match_prepared_flat`` gives its row."""
    def no_graph(*args, **kwargs):
        raise AssertionError("the match graph ran on the CPU")

    monkeypatch.setattr(t_dt, "_match_graph", no_graph)
    cfg = TrackerConfig(first_level=1, last_level=0)
    K = Intrinsics(80.0, 80.0, 39.5, 29.5)
    rng = np.random.default_rng(9)
    frames = []
    for k in range(2):
        intensity = torch.from_numpy(
            (128 + 60 * np.sin(np.arange(80) / (6.0 + k)) + rng.normal(0, 1, (60, 80)))
            .astype(np.float32))
        depth = torch.full((60, 80), 1.5)
        frames.append(t_dt.prepare_frame(cfg, K, build_pyramid(
            intensity, depth, torch.ones(60, 80, dtype=torch.bool), cfg.num_levels)))
    per_level = irls_graph.match_counts.per_level
    init = np.eye(4, dtype=np.float32)
    result = t_dt.match_prepared(cfg, K, frames[0], frames[1], init)
    row = t_dt.match_prepared_flat(cfg, K, frames[0], frames[1], init, host=True)
    assert irls_graph.match_counts.per_level == per_level
    assert isinstance(row, np.ndarray)
    assert row.tobytes() == t_dt.flatten_result(result).numpy().tobytes()
    smooth = dataclasses.replace(cfg, mu=0.05)
    assert t_dt.match_prepared_flat(smooth, K, frames[0], frames[1]).shape == (53 + 4 * 2,)
