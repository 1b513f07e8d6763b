"""The port's benchmark driver (``dvo_slam_tpu_torch/bench.py``) on the CPU.

Every section runs once at a tiny size (8 frames at 30x40 with
``tests/test_torch_streaming.py``'s config; e2e on 8 frames in chunks of
4, one timed run; 8 streams x 3 frames; a bsweep of 3 x 3) on
``device="cpu"``, through ``run_sections`` as ``main`` drives them:

- the record's keys are ``bench.py``'s, listed below from its lines (the
  sequences are far too short for the accuracy gates at this size: the
  card's run holds those);
- the partial record on disk equals the final one;
- ``tracker``'s trajectory equals ``odometry.track_sequence``'s on the
  frames of its last timed run, bit for bit;
- ``frontend``'s records equal ``StreamingSLAM.track_frontend``'s;
- a section that raises leaves ``error_<section>`` and the others run;
- the gates and the exit rule (``bench.py:576-594``);
- ``render_sequence`` is bit-equal to the reference's
  ``bench.render_sequence`` (loaded from the repository root's file);
- ``--mesh`` asks for one card per rank and names the count; the mesh
  path at 2 gloo ranks in child processes (``jax`` blocked) prints the
  reference's ``--mesh`` keys, the same on both ranks (the streams'
  accuracy is held in ``test_torch_dp_slam.py``).
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dvo_slam_tpu_torch import bench, convert, odometry
from dvo_slam_tpu_torch.models.streaming import StreamingSLAM, _decode
from dvo_slam_tpu_torch.ops.camera import Intrinsics
from dvo_slam_tpu_torch.utils import synthetic
from test_torch_streaming import TINY_CFG

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 120
K = Intrinsics(40.0, 40.0, 19.5, 14.5)
SHAPE = (30, 40)
FRAMES = 8
CFG = convert.config_from_reference(TINY_CFG)
SECTION_KWARGS = {
    "e2e": dict(frames=8, pipeline_chunk=4, reps=1),
    "multistream": dict(streams=8, frames=3),
    "bsweep": dict(sweep=((3, 3),)),
}
# bench.py's keys: :264-267 (metric, unit, device), :332-336 (e2e),
# :379-386 (latency), :428-432 (tracker), :446 (hard), :494-497
# (multistream), :533-536 (frontend), :570-573 (bsweep), :587 (gates)
REFERENCE_KEYS = {
    "metric", "unit", "device", "slam_e2e_fps", "slam_e2e_ate_rmse_m",
    "backend_phase_ms_per_frame", "online_latency_ms", "value", "vs_baseline", "ate_rmse_m",
    "ate_rmse_hard_m", "aggregate_fps_8stream_lockstep", "aggregate_fps_8stream_sequential",
    "aggregate_fps_8stream_lockstep_nobuf", "slam_frontend_fps", "slam_ate_rmse_m", "gates",
}
BSWEEP_KEY = "aggregate_fps_3stream_sequential"  # :571, at this test's B = 3
LATENCY_KEYS = {"p50", "p90", "p99", "mean", "max", "meets_30hz_p99"}  # :379-386
GATE_KEYS = {"hard_ate_lt_10mm", "e2e_ate_lt_5mm", "e2e_fps_ge_30"}  # :583-588
MESH_KEYS = {  # :207-215, :251-256
    "metric", "value", "unit", "vs_baseline", "mesh_devices", "streams", "device",
    "e2e_mesh_aggregate_fps", "e2e_mesh_ate_rmse_m_max", "e2e_mesh_ate_rmse_m",
    "e2e_mesh_gate_ate_lt_5mm",
}

# One rank of the --mesh path.  argv: work directory, world size, rank.
_CHILD = r"""
import json, sys
sys.modules["jax"] = None
import numpy as np
import torch
torch.set_num_threads(1)
from dvo_slam_tpu_torch import bench
from dvo_slam_tpu_torch.ops.camera import Intrinsics
from dvo_slam_tpu_torch.parallel import distributed, mesh as mesh_lib

work, world, rank = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
cfg = np.load(f"{work}/cfg.npy", allow_pickle=True).item()
distributed.initialize(init_method=f"file://{work}/store", world_size=world, rank=rank,
                       backend="gloo", device="cpu")
mesh = mesh_lib.make_mesh(world, device="cpu")
setup = bench.make_setup(8, (30, 40), cfg, Intrinsics(40.0, 40.0, 19.5, 14.5), device="cpu")
result = bench.mesh_run(mesh, setup, e2e_frames=8)
distributed.shutdown()
with open(f"{work}/rank{rank}.json", "w") as f:
    json.dump(result, f)
"""


@pytest.fixture(scope="module")
def setup():
    return bench.make_setup(FRAMES, SHAPE, CFG, K, device="cpu")


@pytest.fixture(scope="module")
def mesh_ranks(tmp_path_factory):
    """The --mesh path on 2 gloo ranks, started first so that it runs
    beside the sections."""
    work = tmp_path_factory.mktemp("mesh")
    np.save(work / "cfg.npy", np.array(CFG, dtype=object))
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, str(work), "2", str(r)], cwd=REPO,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    yield work, procs
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def record(setup, mesh_ranks, tmp_path_factory):
    path = tmp_path_factory.mktemp("bench") / "BENCH_PARTIAL.json"
    rep, ok = bench.run_sections(setup, list(bench.SECTION_FUNCTIONS), rep=bench.Report(str(path)),
                                 **SECTION_KWARGS)
    return rep, ok, path


def test_every_section_runs_and_keys_equal_the_reference(record):
    rep, ok, path = record
    assert not rep.failed, rep.result
    assert set(rep.result) == REFERENCE_KEYS | {BSWEEP_KEY}
    assert set(rep.result["online_latency_ms"]) == LATENCY_KEYS
    assert set(rep.result["gates"]) == GATE_KEYS
    assert rep.result["device"] == "cpu" and rep.result["unit"] == "frames/s"
    assert rep.result["metric"] == "tracked_frames_per_second_per_chip"
    numbers = {k: v for k, v in rep.result.items() if isinstance(v, float)}
    assert all(np.isfinite(v) and v >= 0 for v in numbers.values()), numbers
    assert rep.result["gates"]["hard_ate_lt_10mm"] == (rep.result["ate_rmse_hard_m"] < 0.01)
    # the CPU is far from camera rate end to end: the exit rule says 1
    assert not rep.result["gates"]["e2e_fps_ge_30"] and not ok
    with open(path) as f:
        assert json.load(f) == json.loads(json.dumps(rep.result))


def test_tracker_equals_odometry(setup, tmp_path):
    rep = bench.Report(str(tmp_path / "partial.json"))
    est = bench.tracker(rep, setup, reps=2)
    iu = setup.intensity_u8.copy()
    iu[:, 0, 1] += 2  # the last timed run's copy
    d_i, d_d = odometry.upload_sequence(iu, setup.depth_u16, "cpu")
    want, _, _ = odometry.track_sequence(CFG.tracker, K, d_i, d_d)
    np.testing.assert_array_equal(est, want)
    assert set(rep.result) == {"value", "vs_baseline", "ate_rmse_m"}


def test_frontend_records_equal_streaming(setup, tmp_path):
    rep = bench.Report(str(tmp_path / "partial.json"))
    rec = bench.frontend(rep, setup)
    slam = StreamingSLAM(K, CFG, device="cpu")
    records, poses = slam.track_frontend(setup.intensity_u8, setup.depth_u16, force_last=False)
    slam.graph.shutdown()
    assert len(rec) == len(records) == FRAMES
    for row, want in zip(rec, records):
        assert all(np.array_equal(x, y) for x, y in zip(_decode(row), want))


def test_failing_section_records_its_error(setup, monkeypatch, tmp_path):
    def broken(rep, setup):
        raise RuntimeError("section broke")

    monkeypatch.setitem(bench.SECTION_FUNCTIONS, "hard", broken)
    rep = bench.Report(str(tmp_path / "partial.json"))
    rep, ok = bench.run_sections(setup, ["hard", "tracker"], rep=rep)
    assert rep.failed == ["hard"] and not ok
    assert rep.result["error_hard"] == "RuntimeError: section broke"
    assert "value" in rep.result and "ate_rmse_hard_m" not in rep.result
    assert rep.result["gates"] == {}


@pytest.mark.parametrize("values,failed,expected", [
    ({"ate_rmse_hard_m": 0.002, "slam_e2e_ate_rmse_m": 0.001, "slam_e2e_fps": 31.0}, [], True),
    ({"ate_rmse_hard_m": 0.002, "slam_e2e_ate_rmse_m": 0.001, "slam_e2e_fps": 9.8}, [], False),
    ({"ate_rmse_hard_m": 0.012}, [], False),
    ({"slam_e2e_ate_rmse_m": 0.005, "slam_e2e_fps": 30.0}, [], False),
    ({}, [], True),
    ({"ate_rmse_hard_m": 0.002}, ["e2e"], False),
])
def test_gates_and_exit_rule(values, failed, expected, tmp_path):
    rep = bench.Report(str(tmp_path / "partial.json"))
    rep.result.update(values)
    rep.failed = list(failed)
    assert bench.gates(rep) is expected
    assert set(rep.result["gates"]) <= GATE_KEYS


@pytest.mark.parametrize("scene", [None, "occluded"])
def test_render_sequence_bit_equal_to_reference(scene):
    spec = importlib.util.spec_from_file_location("reference_bench", os.path.join(REPO, "bench.py"))
    ref_bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref_bench)
    from dvo_slam_tpu.utils import synthetic as j_synthetic

    poses = synthetic.circular_trajectory(3, radius=0.15, rot_amplitude=0.12, z_amplitude=0.05)
    ours = bench.render_sequence(poses, SHAPE, scene=scene and synthetic.occluded_scene(),
                                 seed0=7)
    ref = ref_bench.render_sequence(poses, SHAPE, scene=scene and j_synthetic.occluded_scene(),
                                    seed0=7)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_mesh_asks_for_a_card_per_rank(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="but 1 card"):
        bench.main(["--mesh", "2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--sections", "tracker"])


def test_mesh_path_on_two_gloo_ranks(mesh_ranks):
    work, procs = mesh_ranks
    for proc in procs:
        try:
            log, _ = proc.communicate(timeout=CHILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            pytest.fail(f"a rank did not finish within {CHILD_TIMEOUT_S} s")
        assert proc.returncode == 0, log
    results = [json.loads((work / f"rank{r}.json").read_text()) for r in range(2)]
    assert set(results[0]) == MESH_KEYS
    assert results[0]["mesh_devices"] == results[0]["streams"] == 2
    assert results[0]["metric"] == "aggregate_tracked_frames_per_second"
    ates = results[0]["e2e_mesh_ate_rmse_m"]
    assert len(ates) == 2 and results[0]["e2e_mesh_ate_rmse_m_max"] == max(ates)
    assert results[0]["e2e_mesh_gate_ate_lt_5mm"] == (max(ates) < 0.005)
    assert results[0]["e2e_mesh_ate_rmse_m"] == results[1]["e2e_mesh_ate_rmse_m"]
