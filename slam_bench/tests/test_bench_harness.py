"""A run driven without the chip at a tiny size: the window, the metric
readers and the check.  With the timed path broken underneath (a step that
returns its state unchanged, an answer altered where it is produced),
``correct`` comes out false."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from slam_bench import harness, manifest
from slam_bench.tests.tiny import tiny_cell

CPU = torch.device("cpu")


def _drive(monkeypatch, broken=None, tracing=False, seconds=4.0):
    cell = tiny_cell("fr1_desk_odometry.recorded", frames=20, factor=2)
    if broken is not None:
        load = manifest.entry

        def patched(name):
            module = load(name)
            module.Entry.update = broken(module.Entry.update)
            return module

        monkeypatch.setattr(manifest, "entry", patched)
    torch.set_num_threads(2)
    result, checks = harness.run_cell(cell, 2**31 + 99, seconds, tracing, CPU, time.time())
    return result, checks


def test_a_sound_run_is_correct(monkeypatch):
    result, checks = _drive(monkeypatch)
    assert result["correct"], checks
    assert result["failed"] == 0 and result["attempted"] >= 4
    assert set(result["metrics"]) == {"frames_per_s", "setup_s"}
    assert list(result)[-1] == "checks"
    assert [c["name"] for c in checks] == ["pose_gap_t_p90_m", "pose_gap_r_p90_rad"]


def test_a_traced_run_reads_its_layers(monkeypatch):
    result, _ = _drive(monkeypatch, tracing=True, seconds=3.0)
    assert result["correct"]
    for name in ("ingest_ms_per_frame.recorded", "irls_iterations_per_frame.recorded",
                 "tracker_ms_per_iteration.recorded", "device_idle_pct.recorded"):
        assert name in result["metrics"], result["metrics"]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert result["device"]["window_s"] > 0


def _unchanged(update):
    """A step that returns its state unchanged: the pose of the frame before."""
    def step(self, frame):
        before = np.array(getattr(self, "_last", np.eye(4)))
        self._last = update(self, frame)
        return before
    return step


def _altered(update):
    """Every answer altered where it is produced: 1 mm along x."""
    def step(self, frame):
        pose = np.array(update(self, frame))
        pose[0, 3] += 1e-3 * (len(getattr(self, "_seen", [])) + 1)
        self._seen = getattr(self, "_seen", []) + [0]
        return pose
    return step


@pytest.mark.parametrize("fault", [_unchanged, _altered], ids=["state_unchanged", "answer_altered"])
def test_a_broken_path_is_not_correct(monkeypatch, fault):
    result, checks = _drive(monkeypatch, broken=fault)
    assert not result["correct"], checks
