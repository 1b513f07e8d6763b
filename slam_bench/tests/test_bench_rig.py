"""The rig cell (``rig8_lockstep.recorded``) driven without the chip at a
tiny size (``tiny.py``): it assembles from ``BENCHMARK.json``, a traced run
reads its new per-layer metrics and the accepted readers it shares with the
one-camera cells (those from the device trace or the card's events None on
the CPU), one seed gives one rig in ``warm_up`` and in ``judge``, and the check
passes a sound run and fails one stream's poses moved by 1 mm a frame."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from slam_bench import harness, manifest, traffic
from slam_bench.tests.tiny import tiny_cell

CPU = torch.device("cpu")
CELL = "rig8_lockstep.recorded"
NEW = ("rig_update_ms_per_frame.recorded", "lockstep_idle_step_share.recorded",
       "rig_ingest_roofline_pct.recorded", "fused_stats_rig_roofline_pct.recorded")
# the accepted readers that the rig's spans and trace serve as they serve the
# one-camera cells, in BENCHMARK.json's order
SHARED = ("device_idle_pct.recorded", "ingest_host_ms_per_frame.recorded",
          "irls_graph_ms_per_iteration.recorded", "ingest_kernel_share.recorded",
          "step_tail_share.recorded")
FAULTY_STREAM = 3


def _drive(monkeypatch, broken=None, tracing=False, seconds=3.0):
    cell = tiny_cell(CELL, frames=10, factor=4)
    if broken is not None:
        load = manifest.entry

        def patched(name):
            module = load(name)
            module.Entry.update = broken(module.Entry.update)
            return module

        monkeypatch.setattr(manifest, "entry", patched)
    torch.set_num_threads(2)
    return harness.run_cell(cell, 2**31 + 4099, seconds, tracing, CPU, time.time())


def test_the_cell_assembles():
    cell = manifest.cell(CELL)
    assert cell.workload["chips"] == 1 and cell.config["entry"] == "rig_tracker"
    assert len(cell.config["streams"]) == 8 and cell.config["reduced"] == ["frames"]
    assert cell.traffic["arrivals"] == "closed" and cell.traffic["check_pairs"] == 32
    assert [m["name"] for m in cell.end_to_end] == ["frames_per_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == list(SHARED + NEW)
    assert set(cell.limits) >= {"pose_gap_t_p90_m", "pose_gap_r_p90_rad"}
    for name in NEW:
        assert hasattr(manifest.metric(name), "read")


def test_one_seed_gives_one_rig():
    """The other streams' noise comes from stream 0's recording: rendered
    again from the same seed (as ``judge`` does after ``release``) they are
    the same bytes; another seed gives other ones; every stream differs."""
    cell = tiny_cell(CELL, frames=4, factor=8)
    entry = manifest.entry("rig_tracker")
    rec = traffic.make_recording(cell.config, 4, 77, CPU)
    first = entry.rig(cell.config, rec, CPU)
    entry._rigs.clear()
    again = entry.rig(cell.config, traffic.make_recording(cell.config, 4, 77, CPU), CPU)
    for a, b in zip(first, again):
        assert np.array_equal(a.intensity, b.intensity) and np.array_equal(a.depth, b.depth)
    other = entry.rig(cell.config, traffic.make_recording(cell.config, 4, 78, CPU), CPU)
    assert not np.array_equal(first[1].intensity, other[1].intensity)
    seeds = {entry.stream_seed(rec, b) for b in range(8)}
    assert len(seeds) == 8
    assert all(not np.array_equal(first[0].intensity, r.intensity) for r in first[1:])


def test_a_sound_run_is_correct(monkeypatch):
    result, checks = _drive(monkeypatch)
    assert result["correct"], checks
    assert result["failed"] == 0 and result["attempted"] >= 5
    assert set(result["metrics"]) == {"frames_per_s", "setup_s"}
    assert [c["name"] for c in checks] == ["pose_gap_t_p90_m", "pose_gap_r_p90_rad"]


def test_a_traced_run_reads_its_layers(monkeypatch):
    result, _ = _drive(monkeypatch, tracing=True)
    assert result["correct"]
    metrics = result["metrics"]
    assert metrics["rig_update_ms_per_frame.recorded"]["value"] > 0
    assert 0.0 <= metrics["lockstep_idle_step_share.recorded"]["value"] < 1.0
    # no device trace on the CPU
    assert "rig_ingest_roofline_pct.recorded" not in metrics
    assert "fused_stats_rig_roofline_pct.recorded" not in metrics
    # the accepted readers: the rig's ingest spans on the CPU (the plain
    # chain, no kernel span), no level-graph events and no match graph
    assert metrics["ingest_host_ms_per_frame.recorded"]["value"] > 0
    assert metrics["ingest_kernel_share.recorded"]["value"] == 0.0
    assert "device_idle_pct.recorded" in metrics
    assert "irls_graph_ms_per_iteration.recorded" not in metrics
    assert "step_tail_share.recorded" not in metrics


def _one_stream_moved(update):
    """Stream FAULTY_STREAM's pose moved by 1 mm more each frame: its
    relative poses part from the reference by 1 mm."""
    def step(self, frame):
        poses = np.array(update(self, frame))
        self._moved = getattr(self, "_moved", 0) + 1
        poses[FAULTY_STREAM, 0, 3] += 1e-3 * self._moved
        return poses
    return step


def test_one_stream_moved_by_1_mm_is_not_correct(monkeypatch):
    result, checks = _drive(monkeypatch, broken=_one_stream_moved)
    assert not result["correct"], checks
    assert checks[0]["value"] > checks[0]["limit"]


@pytest.fixture(autouse=True)
def _forget_rigs():
    yield
    manifest.entry("rig_tracker")._rigs.clear()


@pytest.mark.parametrize("streams,skip", [(1, 0), (8, 1)])
def test_the_ingest_bound_counts_what_the_kernels_write(streams, skip):
    """``roofline_ingest``'s bytes are the raw frames (u8 + u16) and every
    byte of the program's arenas' views, at the rig cell's shape, levels and
    solve range: 47.2 us at B = 8 on the card's 3.35 TB/s."""
    from dvo_slam_tpu_torch.ops import ingest

    from slam_bench import roofline_ingest

    layout = ingest.arena_layout((480, 640), 4, (1, 3), True, streams if streams > 1 else None,
                                 skip)
    written = sum(v.nbytes for v in layout.views.values())
    assert roofline_ingest.ingest_bytes((480, 640), 4, (1, 3), streams, skip) == \
        written + streams * 3 * 480 * 640
    if streams == 8:
        assert abs(roofline_ingest.ingest_bound_s((480, 640), 4, (1, 3), 8, 1) - 47.21e-6) < 0.01e-6
