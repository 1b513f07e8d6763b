"""The driver's per-section launch count (``tools/driver_launches.py``) on
the CPU.

Every section of ``dvo_slam_tpu_torch/bench.py`` runs once at
``test_torch_bench.py``'s tiny size, one at a time through
``count_sections``.  On the CPU no kernel launches: each executed step of
the IRLS loop runs the plain evaluation, which calls ``warp_and_sample_cm``
once (for one stream or for B in lockstep).  So in every section those
calls equal the steps counted for kernel 1 plus those for kernel 1b, which
holds the counting of each solve the card's check relies on:
``track_sequence``'s, the multi-stream runs' and every ``match_prepared``
call's.  At the CPU's K = 1 the steps are the iterations; at K = 2 (three
sections) they are per level 2 * ceil(iterations / 2), and the iterations
stay those of K = 1.  Also: the record equals what ``run_sections``
writes, the non-depth-buffered steps come from the ``lockstep_nobuf`` runs only,
``mismatches`` names what differs, and ``counting`` puts back what it
patched.
"""

import numpy as np
import pytest
import torch

from dvo_slam_tpu_torch import bench
from dvo_slam_tpu_torch.models import dense_tracker
from dvo_slam_tpu_torch.models import frames as frames_mod
from dvo_slam_tpu_torch.models import streaming
from dvo_slam_tpu_torch.parallel import multistream
from dvo_slam_tpu_torch.tools import driver_launches
from test_torch_bench import BSWEEP_KEY, CFG, FRAMES, K, REFERENCE_KEYS, SECTION_KWARGS, SHAPE

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

SECTIONS = list(bench.SECTION_FUNCTIONS)


@pytest.fixture(scope="module")
def counted(tmp_path_factory):
    setup = bench.make_setup(FRAMES, SHAPE, CFG, K, device="cpu")
    path = tmp_path_factory.mktemp("counted") / "partial.json"
    return driver_launches.count_sections(setup, SECTIONS, rep=bench.Report(str(path)),
                                          **SECTION_KWARGS)


@pytest.mark.parametrize("section", SECTIONS)
def test_iterations_equal_plain_evaluations(counted, section):
    _, _, per_section = counted
    s = per_section[section]
    # no kernel launches on the CPU: only the plain evaluation's calls
    assert set(s["launches"]) == {"warp_and_sample_cm_calls"}, s
    assert s["kernel_1_iterations"] + s["kernel_1b_iterations"] > 0
    # K = 1: one step per iteration
    assert (s["kernel_1_steps"], s["kernel_1b_steps"]) == (
        s["kernel_1_iterations"], s["kernel_1b_iterations"]), s
    assert s["launches"]["warp_and_sample_cm_calls"] == (
        s["kernel_1_steps"] + s["kernel_1b_steps"]), s
    if section == "multistream":  # the lockstep_nobuf runs
        assert 0 < s["nobuf_steps"] < s["kernel_1b_steps"]
    else:
        assert s["nobuf_steps"] == 0
    assert s["nobuf_launches"] == 0


CHUNKED = ["tracker", "multistream", "frontend"]


@pytest.fixture(scope="module")
def counted_in_chunks(tmp_path_factory):
    setup = bench.make_setup(FRAMES, SHAPE, CFG, K, device="cpu")
    path = tmp_path_factory.mktemp("chunks") / "partial.json"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dense_tracker, "CHUNK_STEPS", 2)
        return driver_launches.count_sections(setup, CHUNKED, rep=bench.Report(str(path)),
                                              **SECTION_KWARGS)


@pytest.mark.parametrize("section", CHUNKED)
def test_steps_in_chunks_equal_plain_evaluations(counted, counted_in_chunks, section):
    s = counted_in_chunks[2][section]
    assert set(s["launches"]) == {"warp_and_sample_cm_calls"}, s
    assert s["launches"]["warp_and_sample_cm_calls"] == (
        s["kernel_1_steps"] + s["kernel_1b_steps"]), s
    one = counted[2][section]
    assert (s["kernel_1_iterations"], s["kernel_1b_iterations"]) == (
        one["kernel_1_iterations"], one["kernel_1b_iterations"])
    assert s["kernel_1_steps"] + s["kernel_1b_steps"] > (
        s["kernel_1_iterations"] + s["kernel_1b_iterations"])  # inert steps ran
    assert s["kernel_1_steps"] % 2 == s["kernel_1b_steps"] % 2 == 0


def test_record_is_the_drivers(counted):
    rep, ok, per_section = counted
    assert list(per_section) == SECTIONS
    assert not rep.failed, rep.result
    assert set(rep.result) == REFERENCE_KEYS | {BSWEEP_KEY}
    numbers = [v for v in rep.result.values() if isinstance(v, float)]
    assert all(np.isfinite(v) for v in numbers)
    assert not ok  # e2e_fps_ge_30 fails on the CPU, as in the driver's own run


def test_mismatches_name_what_differs():
    even = {"launches": {"warp_fused_stats": 6, "warp_fused_stats_batched": 8, "table_copy": 2},
            "kernel_1_steps": 6, "kernel_1b_steps": 8, "kernel_1_iterations": 5,
            "kernel_1b_iterations": 7, "nobuf_steps": 4, "nobuf_launches": 4}
    assert driver_launches.mismatches({"e2e": even}) == []
    odd = dict(even, kernel_1b_steps=10, nobuf_launches=2,
               launches=dict(even["launches"], fused_stats=1))
    wrong = driver_launches.mismatches({"e2e": odd})
    assert len(wrong) == 3
    assert "warp_fused_stats_batched launched 8 times for 10 executed steps" in wrong[0]
    assert "nobuf launched 2 times for 4 executed steps" in wrong[1]
    assert "fused_stats" in wrong[2]


def test_counting_puts_back_what_it_patched():
    before = (bench.track_sequence, multistream.make_multistream_tracker,
              streaming.match_prepared, frames_mod.match_prepared_flat)
    with pytest.raises(RuntimeError):
        with driver_launches.counting():
            assert bench.track_sequence is not before[0]
            raise RuntimeError("section broke")
    assert (bench.track_sequence, multistream.make_multistream_tracker,
            streaming.match_prepared, frames_mod.match_prepared_flat) == before
