"""The glue kernels on the card (``ops/match_glue``: ``csrc/fused_stats.cu``'s
match setup, link and result), against the plain glue of
``models/dense_tracker`` (``match_start``, ``next_start``, ``level_stats``,
``match_result``, ``flatten_result``) run on the card.

  * each kernel at B = 1, 2 and 8, from a warm start and from the identity,
    with ``use_estimate_smoothing`` on and off, on rotations near zero, of
    half a radian and near pi (both of ``log_se3``'s branches): integers and
    flags equal, every float field within ``GAP_ULPS`` ulps of the field's
    largest magnitude (``tests_cuda/test_step_tail_cuda.py``'s gate); the
    result also on refpacks that are views with a wider stream stride;
  * a whole 640x480 match's row through the match graph, against the same
    match with the plain glue around its levels, within the same gate;
  * the match graph holds at most 8 nodes outside its levels' loops (each
    glue capture one kernel, and the row's copy), a level's head chunk no
    copy, and each launch counts one setup, a link between two levels and
    one result.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from dvo_slam_tpu_torch import benchmark_config, odometry
from dvo_slam_tpu_torch.models import dense_tracker as dt
from dvo_slam_tpu_torch.models import irls_graph
from dvo_slam_tpu_torch.ops import match_glue, se3
from dvo_slam_tpu_torch.ops.camera import TUM_FR1
from dvo_slam_tpu_torch.tools import graph_check
from dvo_slam_tpu_torch.utils import synthetic

pytestmark = pytest.mark.cuda

CFG = benchmark_config().tracker
STREAMS = (1, 2, 8)
# rotation angles of the hand-made poses: log_se3's small-angle branch, its
# closed form, and near pi
ANGLES = {"near_zero": 2e-3, "half": 0.5, "near_pi": math.pi - 2e-3}
# the step kernels' gate (tests_cuda/test_step_tail_cuda.py): ulps of a
# field's largest magnitude
GAP_ULPS = 32
GAPS = {}  # the largest gap seen of each field, printed at the end
CUDA = torch.device("cuda")


@pytest.fixture(scope="module", autouse=True)
def _report():
    yield
    print("\nglue kernels against the plain glue, largest gap (ulps of the field's scale):",
          {k: v for k, v in sorted(GAPS.items())})


def _gap_ulps(a, b) -> float:
    """The largest |a - b| in ulps of the larger of the two's largest
    finite magnitudes (0 where equal; NaNs and infinities must sit alike)."""
    a, b = a.double().cpu(), b.double().cpu()
    finite = torch.isfinite(a)
    assert torch.equal(finite, torch.isfinite(b)), "NaNs or infinities part"
    a, b = a[finite], b[finite]
    if torch.equal(a, b):
        return 0.0
    scale = max(float(a.abs().max()), float(b.abs().max()))
    return float((a - b).abs().max()) / float(np.spacing(np.float32(scale)))


def _close(name, got, want, what):
    assert got.shape == want.shape and got.dtype == want.dtype, (what, name)
    if not got.is_floating_point():
        assert torch.equal(got, want), (what, name, got, want)
        return
    gap = _gap_ulps(got, want)
    GAPS[name] = max(GAPS.get(name, 0.0), gap)
    assert gap <= GAP_ULPS, (what, name, gap)


def _poses(streams, angle, seed):
    """[B, 4, 4] float32 rigid transforms on the card: rotations of about
    ``angle`` (a little less for each later stream) about seeded axes, and
    seeded translations of a few centimetres."""
    gen = torch.Generator().manual_seed(seed)
    axis = torch.nn.functional.normalize(torch.randn(streams, 3, generator=gen,
                                                     dtype=torch.float64), dim=-1)
    angles = angle * (1.0 - 5e-4 * torch.arange(streams, dtype=torch.float64))
    w = axis * angles[:, None]
    v = 0.05 * torch.randn(streams, 3, generator=gen, dtype=torch.float64)
    return se3.exp_se3(torch.cat([v, w], dim=-1)).float().to(CUDA)


def _batch(streams):
    return () if streams == 1 else (streams,)


def _shaped(t, streams):
    return t[0] if streams == 1 else t


@pytest.mark.parametrize("angle", sorted(ANGLES) + ["identity"])
@pytest.mark.parametrize("streams", STREAMS)
def test_the_setup_against_the_plain_glue(streams, angle):
    batch = _batch(streams)
    init = None if angle == "identity" else _shaped(_poses(streams, ANGLES[angle], 1), streams)
    want = dt.match_start(init, batch, torch.float32, CUDA)
    got = match_glue.setup_cuda(init, batch, CUDA)
    for name, a, b in zip(("x", "T", "initial", "precision"), got, want):
        _close("setup." + name, a, b.expand(a.shape), (streams, angle))
    if angle == "identity":
        assert all(torch.equal(a, b.expand(a.shape)) for a, b in zip(got, want))


def _carry(streams, angle, seed):
    """A final carry with inc_applied, T and initial of ``angle`` and the
    rest seeded."""
    gen = torch.Generator().manual_seed(seed)
    batch = _batch(streams)
    fields = {}
    for k, name in enumerate(("inc_applied", "T", "initial")):
        fields[name] = _shaped(_poses(streams, ANGLES[angle] / (1 + k), seed + k), streams)
    m = torch.randn(streams, 6, 6, generator=gen)
    fields["A"] = _shaped((m @ m.transpose(-1, -2) * 1e4).to(CUDA), streams).contiguous()
    p = torch.randn(streams, 2, 2, generator=gen)
    fields["precision"] = _shaped((p @ p.transpose(-1, -2) * 1e3).to(CUDA), streams).contiguous()
    fields["ll"] = (1e4 * torch.rand(batch, generator=gen)).to(CUDA)
    for name in ("n", "iteration", "termination"):
        fields[name] = torch.randint(0, 5000 if name == "n" else 5, batch, generator=gen,
                                     dtype=torch.int32).to(CUDA)
    fields["x"] = torch.zeros(batch + (6,), device=CUDA)
    fields["error"] = -fields["ll"]
    fields["done"] = torch.ones(batch, dtype=torch.bool, device=CUDA)
    return dt._Carry(**fields)


@pytest.mark.parametrize("angle", sorted(ANGLES))
@pytest.mark.parametrize("streams", STREAMS)
def test_the_link_against_the_plain_glue(streams, angle):
    final = _carry(streams, angle, 7)
    want = dt.next_start(final)
    got = match_glue.link_cuda(final.inc_applied, final.T, final.initial, final.precision)
    for name, a, b in zip(("x", "T", "initial", "precision"), got, want):
        _close("link." + name, a, b, (streams, angle))
    assert all(torch.equal(a, b) for a, b in zip(got[1:], want[1:]))  # copies


def _refpack(streams, pixels, seed, view):
    """[*batch, 8, pixels] float32 with a seeded 0/1 selection row 6; with
    ``view`` a slice of a wider buffer (a stream stride of 9 rows)."""
    gen = torch.Generator().manual_seed(seed)
    rows = 9 if view else 8
    buf = torch.rand(streams, rows, pixels, generator=gen)
    buf[:, 6] = (torch.rand(streams, pixels, generator=gen) < 0.3).float()
    buf = buf.to(CUDA)
    out = buf[:, :8]
    return _shaped(out, streams)


@pytest.mark.parametrize("view", [False, True])
@pytest.mark.parametrize("smoothing", [True, False])
@pytest.mark.parametrize("angle", sorted(ANGLES))
@pytest.mark.parametrize("streams", STREAMS)
def test_the_result_against_the_plain_glue(streams, angle, smoothing, view):
    cfg = dataclasses.replace(CFG, mu=0.05 if smoothing else 0.0)
    pixels = (4800, 1200, 301)  # coarse to fine; the last not a multiple of 4
    finals = [_carry(streams, angle, 11 + 3 * level) for level in range(len(pixels))]
    refpacks = [_refpack(streams, n, 5 + level, view) for level, n in enumerate(pixels)]
    stats = [dt.level_stats(r, f) for r, f in zip(refpacks, finals)]
    want = dt.flatten_result(dt.match_result(cfg, finals[-1], stats))
    got = dt._glue_result(cfg, finals, refpacks)
    base = dt.FLAT_BASE
    for name, part in (("T", slice(0, 16)), ("information", slice(16, 52)),
                       ("nll", slice(52, 53))):
        _close("result." + name, got[..., part], want[..., part], (streams, angle, smoothing))
    assert torch.equal(got[..., base:], want[..., base:])  # the counts, exactly


@pytest.fixture(scope="module")
def frames():
    poses = synthetic.circular_trajectory(10, radius=0.05, rot_amplitude=0.02)
    intensity, depth = odometry.render_sequence(poses, (480, 640), TUM_FR1, workers=4)
    d_i, d_d = odometry.upload_sequence(intensity, depth, CUDA)
    prepared = [dt.prepare_frame(CFG, TUM_FR1, odometry.build_frame(CFG, d_i[k], d_d[k]))
                for k in range(9)]
    return prepared, poses


def _pair(frames, streams):
    prepared, poses = frames
    warm = torch.from_numpy(np.stack([np.linalg.inv(poses[k]) @ poses[k + 1]
                                      for k in range(streams)]).astype(np.float32)).to(CUDA)
    if streams == 1:
        return prepared[0], prepared[1], warm[0]

    def stack(frames_):
        return dt.PreparedFrame(*(tuple(None if level[0] is None else torch.stack(level)
                                        for level in zip(*field)) for field in zip(*frames_)))

    return (stack(prepared[:streams]), stack(prepared[1:streams + 1]), warm)


def _match_graph(cfg):
    """The one match graph of the process's cache (the cache emptied before)."""
    built = [m for m in irls_graph._matches.values() if m.exec is not None]
    assert len(built) == 1
    return built[0]


def _plain_glue_match(cfg, ref, cur, init):
    """A match on the card with the plain glue around its levels
    (``match_start``, ``next_start``, ``level_stats``, ``match_result``,
    ``flatten_result``), the levels as while graphs (``_match_level``,
    whose steps are the match graph's): its flat row, and the levels'
    final carries and refpacks."""
    batch = tuple(ref.refpack[cfg.first_level].shape[:-2])
    start = dt.match_start(init, batch, torch.float32, CUDA)
    finals, stats, refpacks = [], [], []
    for level in range(cfg.first_level, cfg.last_level - 1, -1):
        final, level_out, _ = dt._match_level(cfg, TUM_FR1.at_level(level), ref.sel[level],
                                              ref.refpack[level], cur.quad[level], *start,
                                              accel=cur.accel[level])
        finals.append(final)
        stats.append(level_out)
        refpacks.append(ref.refpack[level])
        start = dt.next_start(final)
    return dt.flatten_result(dt.match_result(cfg, finals[-1], stats)), finals, refpacks


@pytest.mark.parametrize("warm", [True, False])
@pytest.mark.parametrize("streams", [1, 8])
def test_a_whole_match_against_the_plain_glue(frames, streams, warm):
    ref, cur, init = _pair(frames, streams)
    init = init if warm else None
    with graph_check.loop_mode(True, 1, polled=False):
        got = dt.match_prepared_flat(CFG, TUM_FR1, ref, cur, init)
        want = _plain_glue_match(CFG, ref, cur, init)[0]
    base = dt.FLAT_BASE
    assert torch.equal(got[..., base:], want[..., base:]), (got[..., base:], want[..., base:])
    for name, part in (("T", slice(0, 16)), ("information", slice(16, 52)),
                       ("nll", slice(52, 53))):
        _close("match." + name, got[..., part], want[..., part], (streams, warm))


@pytest.mark.parametrize("streams", [1, 8])
def test_the_match_graph_holds_a_handful_of_glue_nodes(frames, streams):
    ref, cur, init = _pair(frames, streams)
    levels = CFG.first_level - CFG.last_level + 1
    irls_graph.release()
    with graph_check.loop_mode(True, 1, polled=False):
        dt.match_prepared(CFG, TUM_FR1, ref, cur, init)  # builds
        counters = [w.launches for w in (match_glue.setup_cuda, match_glue.link_cuda,
                                         match_glue.result_cuda)]
        dt.match_prepared(CFG, TUM_FR1, ref, cur, init)
        dt.match_prepared(CFG, TUM_FR1, ref, cur, init)
    moved = [w.launches - c for w, c in zip((match_glue.setup_cuda, match_glue.link_cuda,
                                             match_glue.result_cuda), counters)]
    assert moved == [2, 2 * (levels - 1), 2]
    census = _match_graph(CFG).census()
    print(f"\nB = {streams}, the match graph's glue nodes: {census}")
    assert sum(census["glue"].values()) <= 8, census
    assert census["glue"] == {"kernel": levels + 1, "memcpy": 1}, census
    for name, part in census.items():
        if name != "glue":
            assert part == {"kernel": 1}, (name, part)
    for graphs in (g for g in irls_graph._cache.values() if g.head is not None):
        head = graphs.census()["head"]
        print(f"B = {streams}, a level's head chunk: {head}")
        assert "memcpy" not in head and set(head) == {"kernel"}, head


def test_the_plain_glue_census_for_comparison(frames):
    """The plain glue of the same match, captured as a match graph held it
    (``graph_check.plain_glue_census``), takes hundreds of nodes; printed
    beside the kernels' count."""
    ref, cur, init = _pair(frames, 1)
    with graph_check.loop_mode(True, 1, polled=False):
        _, finals, refpacks = _plain_glue_match(CFG, ref, cur, init)
    glue = graph_check.plain_glue_census(CFG, init, finals, refpacks)
    print(f"\nthe plain glue's nodes: {glue}")
    assert sum(glue.values()) > 8
