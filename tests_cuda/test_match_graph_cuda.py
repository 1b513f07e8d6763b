"""A whole match as one launch of a match graph on the card
(``irls_graph.MatchGraph``, ``csrc/while_graph.cu``), against the two
level-by-level forms: each level one while-graph launch with the se3 glue
issued by the host (``dense_tracker.match_graph_form`` patched off), and
host-polled chunk replays (``WHILE_GRAPHS`` off).

At 120x160 and 640x480 and ``benchmark_config()``'s tracker, for one
stream and B = 2 and 8, with a warm start and from the identity, with
``use_estimate_smoothing`` and ``collect_iteration_stats``: every field of
the ``TrackingResult``, its ``LevelStats`` and iteration traces, the host
row of ``match_prepared_flat`` and the folded kernel launches are bit-equal
across the three forms; the match graph reads nothing back before its
result.  A level key dropped from the cache takes its match graphs with
it, and the next match rebuilds and agrees; a ``TwoStageMatcher`` wave
whose fine stage is seeded on the card by the coarse rows agrees too.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from dvo_slam_tpu_torch import benchmark_config, odometry
from dvo_slam_tpu_torch.models import dense_tracker, irls_graph
from dvo_slam_tpu_torch.models.constraints import (
    constraint_tracker_config,
    validation_tracker_config,
)
from dvo_slam_tpu_torch.models.dense_tracker import (
    PreparedFrame,
    match_prepared,
    match_prepared_flat,
    prepare_frame,
)
from dvo_slam_tpu_torch.models.frames import Frame, TwoStageMatcher
from dvo_slam_tpu_torch.ops.camera import TUM_FR1, Intrinsics
from dvo_slam_tpu_torch.tools import driver_launches, graph_check
from dvo_slam_tpu_torch.utils import synthetic

pytestmark = pytest.mark.cuda

CFG = benchmark_config().tracker
FRAMES = 10
SHAPES = {(120, 160): Intrinsics(130.0, 130.0, 79.5, 59.5), (480, 640): TUM_FR1}
FORMS = ("match", "level", "polled")


@pytest.fixture(scope="module")
def scenes():
    poses = synthetic.circular_trajectory(FRAMES, radius=0.05, rot_amplitude=0.02)
    out = {}
    for shape, K in SHAPES.items():
        intensity, depth = odometry.render_sequence(poses, shape, K, workers=4)
        out[shape] = (intensity, depth, poses)
    return out


def _batched(frames):
    """One PreparedFrame of B prepared frames (each field stacked per level)."""
    return PreparedFrame(*(
        tuple(None if level[0] is None else torch.stack(level) for level in zip(*field))
        for field in zip(*frames)))


def _pair(scene, shape, cfg, streams):
    """(reference, current, warm start): frame k against k + 1 for stream k,
    the warm start the pair's true relative pose (float32 on the card)."""
    intensity, depth, poses = scene
    K = SHAPES[shape]
    d_i, d_d = odometry.upload_sequence(intensity, depth, torch.device("cuda"))
    prepared = [prepare_frame(cfg, K, odometry.build_frame(cfg, d_i[k], d_d[k]))
                for k in range(min(streams + 1, FRAMES))]
    pairs = [k % (len(prepared) - 1) for k in range(streams)]
    warm = torch.from_numpy(np.stack([
        np.linalg.inv(poses[k]) @ poses[k + 1] for k in pairs]).astype(np.float32)).cuda()
    if streams == 1:
        return prepared[0], prepared[1], warm[0]
    return (_batched([prepared[k] for k in pairs]), _batched([prepared[k + 1] for k in pairs]),
            warm)


@contextlib.contextmanager
def _form(name, monkeypatch):
    """The match graph, level by level with while graphs, or host-polled."""
    if name == "level":
        monkeypatch.setattr(dense_tracker, "match_graph_form", lambda device, group=(): False)
    with graph_check.loop_mode(True, 1, polled=name == "polled"):
        yield
    monkeypatch.undo()


def _bits(result):
    """A result's fields, level statistics and traces, in one list."""
    out = [result.transformation, result.information, result.neg_log_likelihood]
    out += [f for s in result.level_stats for f in s]
    out += [f for t in result.iteration_stats for f in t]
    return out


def _solve(name, monkeypatch, cfg, K, pair, warm, collect):
    """(result bits, host row, launch counts, match-graph launches, level-by-
    level matches) of one form, its keys built before."""
    ref, cur, init = pair
    init = init if warm else None
    with _form(name, monkeypatch):
        match_prepared(cfg, K, ref, cur, init, collect_iteration_stats=collect)  # builds
        driver_launches.reset_counts()
        with graph_check.counting_reads() as reads:
            result = match_prepared(cfg, K, ref, cur, init, collect_iteration_stats=collect)
        counts = driver_launches.launches()
        stats = irls_graph.stats()
        row = match_prepared_flat(cfg, K, ref, cur, init, host=True)
    assert name != "match" or reads == [], reads
    return _bits(result), row, counts, stats["match_graph_launches"], stats["per_level_matches"]


def _agree(runs):
    bits, rows, counts = ([run[i] for run in runs.values()] for i in range(3))
    for name, got in zip(FORMS[1:], bits[1:]):
        assert len(got) == len(bits[0])
        assert all(graph_check._same(a, b) for a, b in zip(bits[0], got)), name
    for row in rows[1:]:
        assert rows[0].dtype == row.dtype and rows[0].tobytes() == row.tobytes()
    assert counts[0] == counts[1] == counts[2]
    assert runs["match"][3] == 1 and runs["match"][4] == 0
    assert runs["level"][3] == 0 and runs["level"][4] == 1
    assert runs["polled"][3] == 0 and runs["polled"][4] == 1


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("streams", [1, 2, 8])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_match_graph_bit_equal_to_the_level_forms(scenes, monkeypatch, shape, streams, warm):
    pair = _pair(scenes[shape], shape, CFG, streams)
    runs = {name: _solve(name, monkeypatch, CFG, SHAPES[shape], pair, warm, False)
            for name in FORMS}
    _agree(runs)


@pytest.mark.parametrize("streams", [1, 8])
def test_match_graph_with_smoothing_and_traces(scenes, monkeypatch, streams):
    cfg = dataclasses.replace(CFG, mu=0.05)  # use_estimate_smoothing: mu > 0
    shape = (480, 640)
    pair = _pair(scenes[shape], shape, cfg, streams)
    runs = {name: _solve(name, monkeypatch, cfg, SHAPES[shape], pair, True, True)
            for name in FORMS}
    _agree(runs)
    assert len(runs["match"][0]) > 3 + 4 * 3  # the traces were compared too


def test_a_dropped_level_key_rebuilds_the_match_graph(scenes, monkeypatch):
    shape = (480, 640)
    pair = _pair(scenes[shape], shape, CFG, 2)
    want = _solve("level", monkeypatch, CFG, TUM_FR1, pair, True, False)
    got = _solve("match", monkeypatch, CFG, TUM_FR1, pair, True, False)
    assert all(graph_check._same(a, b) for a, b in zip(got[0], want[0]))
    built = irls_graph.stats()["match_graphs"]
    irls_graph.release(where=lambda key: key[1] == (120, 160))  # level 2's key
    left = irls_graph.stats()["match_graphs"]
    assert left < built
    driver_launches.reset_counts()
    result = match_prepared(CFG, TUM_FR1, pair[0], pair[1], pair[2])  # rebuilds
    assert all(graph_check._same(a, b) for a, b in zip(_bits(result), want[0]))
    assert irls_graph.stats()["match_graphs"] == left + 1
    assert driver_launches.launches() == want[2]
    assert irls_graph.stats()["match_graph_launches"] == 1


def test_two_stage_wave_seeded_on_the_card(scenes, monkeypatch):
    intensity, depth, poses = scenes[(480, 640)]
    frames = {k: Frame.from_raw(intensity[k], depth[k], k / 30.0, CFG.num_levels, device="cuda")
              for k in (0, 3, 6, 9)}
    requests = []
    for a, b in ((0, 3), (3, 6), (6, 9)):
        requests.append((frames[a], frames[b], None))
        requests.append((frames[a], frames[b], np.linalg.inv(poses[a]) @ poses[b]))
    matcher = TwoStageMatcher(validation_tracker_config(CFG), constraint_tracker_config(CFG),
                              TUM_FR1)
    out = {}
    for name in FORMS:
        with _form(name, monkeypatch):
            matcher.match_pairs(requests)  # builds
            driver_launches.reset_counts()
            out[name] = (matcher.match_pairs(requests), driver_launches.launches(),
                         irls_graph.stats()["match_graph_launches"])
    for name in FORMS[1:]:
        assert out[name][1] == out["match"][1]
        for quad, other in zip(out["match"][0], out[name][0]):
            for r, s in zip(quad, other):
                assert r.transformation.tobytes() == s.transformation.tobytes(), name
                assert r.information.tobytes() == s.information.tobytes(), name
                assert r.neg_log_likelihood == s.neg_log_likelihood and \
                    r.level_stats == s.level_stats, name
    assert out["match"][2] == 2 and out["level"][2] == out["polled"][2] == 0


def test_match_graph_reads_and_syncs_nothing(scenes):
    """Once built, a match with its result kept on the card raises nothing
    under CUDA's sync-debug mode "error"."""
    shape = (480, 640)
    pair = _pair(scenes[shape], shape, CFG, 8)
    match_prepared(CFG, TUM_FR1, *pair)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        result = match_prepared(CFG, TUM_FR1, *pair)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(result.transformation).all())
