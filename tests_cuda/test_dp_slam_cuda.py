"""Data-parallel SLAM, the lockstep streaming front end, the distributed
pose-graph solvers and the benchmark driver on the card.

- The B-stream front end (B = 3 streams of 10 noisy 120x160 frames,
  ``tests/test_streaming.py``'s intrinsics and config) on the card: each
  stream's records bit-equal to that stream run alone on the card.
- One NCCL rank in a child process (``file://`` rendezvous in a temporary
  directory): ``DataParallelSLAM`` on two streams, each stream's online
  poses bit-equal to ``StreamingSLAM.track_frontend`` of that stream, every
  online and optimized ATE < 10 mm; the distributed Gauss-Newton, CG and
  Schur solvers on ``tests/test_parallel.py``'s graphs in float64 on the
  card against the single solvers on the host (float64): history within
  rtol 1e-9, poses within 1e-9.
- The driver's sections at 6 frames of 120x160 on the card, one at a time
  through ``tools/driver_launches.count_sections``: every section runs and
  writes its keys, and each section's launches of kernels 1 and 1b (and of
  1b's non-depth-buffered template) equal its solves' iterations.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dvo_slam_tpu_torch import bench
from dvo_slam_tpu_torch.config import GraphConfig, KeyframeConfig, SlamConfig, TrackerConfig
from dvo_slam_tpu_torch.models.streaming import make_streaming_frontend
from dvo_slam_tpu_torch.ops import fused_kernels
from dvo_slam_tpu_torch.ops.camera import Intrinsics
from dvo_slam_tpu_torch.tools import driver_launches
from dvo_slam_tpu_torch.utils import synthetic

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = Intrinsics(160.0, 160.0, 79.5, 59.5)
SHAPE = (120, 160)
CFG = SlamConfig(
    tracker=TrackerConfig(first_level=2, last_level=0, max_iterations_per_level=30,
                          precision=1e-4, use_initial_estimate=True),
    keyframe=KeyframeConfig(max_translational_distance=0.08, min_entropy_ratio=0.6,
                            min_equation_system_constraint_ratio=0.3),
    graph=GraphConfig(new_constraint_search_radius=5.0,
                      new_constraint_min_entropy_ratio_coarse=0.03,
                      new_constraint_min_entropy_ratio_fine=0.3,
                      min_equation_system_constraint_ratio=0.3),
)
SOLVE_TOL = 1e-9
ATE_GATE_M = 0.01

_CHILD = r"""
import json, sys
import numpy as np
import torch
from dvo_slam_tpu_torch.models import pose_graph as pg
from dvo_slam_tpu_torch.models.streaming import StreamingSLAM
from dvo_slam_tpu_torch.parallel import distributed, distributed_ba as dba, mesh as mesh_lib
from dvo_slam_tpu_torch.parallel.dp_slam import DataParallelSLAM
from dvo_slam_tpu_torch.ops import se3
from dvo_slam_tpu_torch.utils import trajectory
sys.path.insert(0, sys.argv[2])
from test_dp_slam_cuda import CFG, K, _streams, _graphs

work = sys.argv[1]
distributed.initialize(init_method=f"file://{work}/store", world_size=1, rank=0)
mesh = mesh_lib.make_mesh(1)
out = {}
iu, du, gt = _streams(2)
stamps = np.arange(iu.shape[1]) / 30.0
dp = DataParallelSLAM(K, CFG, mesh=mesh)
online = dp.track_sequences(iu, du, stamps)
for s, (st, poses) in enumerate(dp.trajectories()):
    solo = StreamingSLAM(K, CFG)
    want = solo.track_frontend(iu[s], du[s])[1]
    solo.graph.shutdown()
    out[f"stream{s}"] = {
        "bit_equal": bool(np.array_equal(online[s], want)),
        "max_diff": float(np.abs(online[s] - want).max()),
        "ate_online": float(trajectory.ate_rmse(stamps, online[s], stamps, gt[s])),
        "ate_optimized": float(trajectory.ate_rmse(st, poses, stamps, gt[s])),
    }
dp.shutdown()
(chain, ring), struct = _graphs()
runs = {
    "gn": (dba.distributed_gauss_newton(chain, mesh, iterations=10),
           pg.optimize(chain, 10, solver="dense")),
    "cg": (dba.distributed_gauss_newton_cg(chain, mesh, iterations=8, cg_iterations=128),
           pg.optimize(chain, 8, solver="cg", cg_iterations=128)),
    "schur": (dba.distributed_gauss_newton_schur(ring, struct, mesh, iterations=10),
              pg.optimize(ring, 10, solver="schur", struct=struct)),
}
for name, ((g, h), (g1, h1)) in runs.items():
    assert g.poses.device.type == "cuda" and g.poses.dtype == torch.float64
    out[name] = {"history_rel": float(((h.cpu() - h1).abs() / h1.abs()).max()),
                 "poses": float((g.poses.cpu() - g1.poses).abs().max())}
distributed.shutdown()
print("RESULT", json.dumps(out))
"""


def _streams(count, frames=10):
    iu = np.zeros((count, frames) + SHAPE, np.uint8)
    du = np.zeros((count, frames) + SHAPE, np.uint16)
    gt = np.zeros((count, frames, 4, 4))
    for s in range(count):
        gt[s] = synthetic.circular_trajectory(frames, radius=0.05 + 0.005 * s, rot_amplitude=0.03)
        for i, pose in enumerate(gt[s]):
            intensity, depth, valid = synthetic.render_frame(
                pose, K, SHAPE, seed=31 * s + i, depth_noise=0.002, intensity_noise=1.0)
            iu[s, i] = np.clip(intensity, 0, 255).astype(np.uint8)
            du[s, i] = np.where(valid, depth * 5000.0, 0).astype(np.uint16)
    return iu, du, gt


def _graphs():
    """tests/test_parallel.py's chain (12 vertices, capacity 16) and ring
    (48 vertices, a loop every 8, capacity 64), float64 on the host, and
    the ring's chain structure."""
    from dvo_slam_tpu_torch.models import pose_graph as pg
    from dvo_slam_tpu_torch.ops import se3

    def exp(xi):
        return se3.exp_se3(torch.tensor(np.asarray(xi, np.float32))).double().numpy()

    def build(n, cap, loops, seed):
        rng = np.random.default_rng(seed)
        true = [np.eye(4)]
        for _ in range(n):
            true.append(true[-1] @ exp([0.3, 0.0, 0.0, 0.0, 0.0, 2 * np.pi / n]))
        g = pg.PoseGraph(vertex_capacity=cap, edge_capacity=cap)
        g.add_vertex(0, np.eye(4), fixed=True)
        pose = np.eye(4)
        for i in range(n):
            meas = np.linalg.inv(true[i]) @ true[i + 1] @ exp(rng.normal(0, 0.01, 6))
            pose = pose @ meas
            g.add_vertex(i + 1, pose)
            g.add_edge(i, i + 1, meas, np.eye(6))
        for i, j, w in loops:
            g.add_edge(i, j, np.linalg.inv(true[i]) @ true[j], w * np.eye(6), robust=True)
        return g

    chain = build(12, 16, [(0, 12, 100.0)], 0)
    ring = build(48, 64, [(i, i + 8, 50.0) for i in range(0, 40, 8)], 7)

    def f64(g):
        return pg.GraphArrays(*(x.double() if x.is_floating_point() else x for x in g.to_arrays()))

    return (f64(chain), f64(ring)), ring._chain_structure(max_level=0)


def test_stream_axis_on_the_card_bit_equal_to_solo():
    iu, du, _ = _streams(3)
    run = make_streaming_frontend(CFG, K)
    dev = torch.device("cuda")
    force = torch.zeros(iu.shape[:2], dtype=torch.bool, device=dev)
    init = torch.eye(4, device=dev).expand(3, 4, 4).contiguous()
    d_i = torch.from_numpy(iu).to(dev)
    d_d = torch.from_numpy(du.astype(np.int32)).to(dev)
    fused_kernels.warp_fused_stats_batched_cuda.launches = 0
    records = run(d_i, d_d, force, init).cpu().numpy()
    assert fused_kernels.warp_fused_stats_batched_cuda.launches > 0
    for b in range(3):
        solo = run(d_i[b], d_d[b], force[b], init[b]).cpu().numpy()
        np.testing.assert_array_equal(records[b], solo)


def test_dp_slam_and_distributed_solvers_on_one_nccl_rank(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _CHILD, str(tmp_path),
                           os.path.dirname(os.path.abspath(__file__))],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = json.loads(proc.stdout.split("RESULT", 1)[1])
    for s in range(2):
        stream = out[f"stream{s}"]
        assert stream["bit_equal"], stream
        assert stream["ate_online"] < ATE_GATE_M and stream["ate_optimized"] < ATE_GATE_M, stream
    for name in ("gn", "cg", "schur"):
        assert out[name]["history_rel"] < SOLVE_TOL and out[name]["poses"] < SOLVE_TOL, out


def test_bench_sections_on_the_card(tmp_path):
    setup = bench.make_setup(6, SHAPE, CFG, K)
    assert setup.device.type == "cuda"
    kwargs = {"e2e": dict(frames=12, pipeline_chunk=6, reps=1),
              "multistream": dict(streams=8, frames=3), "bsweep": dict(sweep=((3, 3),))}
    rep, _, sections = driver_launches.count_sections(
        setup, list(bench.SECTION_FUNCTIONS), rep=bench.Report(str(tmp_path / "partial.json")),
        **kwargs)
    assert not rep.failed, rep.result
    assert not driver_launches.mismatches(sections), sections
    assert sections["multistream"]["nobuf_launches"] > 0
    for key in ("value", "ate_rmse_hard_m", "slam_e2e_fps", "online_latency_ms",
                "aggregate_fps_8stream_lockstep_nobuf", "slam_frontend_fps",
                "aggregate_fps_3stream_sequential", "gates"):
        assert key in rep.result, key
    assert "W" in rep.result["device"]  # nvidia-smi's name and power limit
