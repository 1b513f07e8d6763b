"""The port's data-parallel SLAM (``parallel/dp_slam``) on the CPU.

Three streams of ``tests/test_torch_streaming.py``'s tiny 30x40 setting
(its config, 10 frames each, on circles of 35, 39 and 43 mm with the
benchmark's sensor noise, seeds 31 s + i as in
``tests/test_parallel.py::test_dp_e2e_slam_on_mesh``):

- Against the reference's ``DataParallelSLAM`` at ``mesh=None``: its
  vmapped front-end program (``_front_b``, compiled once) on the same
  frames.  The reference's back ends are not replayed here (their
  validation waves compile for about 50 s); the port's back ends are held
  to the reference's in ``test_torch_keyframe_graph.py`` and
  ``test_torch_slam.py``.  Per stream and frame the accept, divergence and
  force flags and the constraint and pixel counts equal, the port's
  keyframes as many as the reference's switches + 1, the keyframe results
  within ``test_torch_streaming.py``'s 1e-4 and the odometry results
  within its 1e-3.  The online poses: within 1e-4 until a stream switches
  keyframes on a frame whose odometry result parted (identity-seeded ties,
  ROADMAP queue C), within 1e-3 after; the parted results are pinned.
- Two gloo ranks in child processes (``file://`` rendezvous, ``jax``
  blocked), one stream each: every rank returns both streams' online poses
  and optimized trajectories; each stream's online poses bit-equal to
  ``StreamingSLAM.track_frontend`` of that stream alone (the reference's
  own assertion, ``tests/test_parallel.py:399-403``); every stream's online
  and optimized ATE < 10 mm (``:394-397``); ``slams`` holds the rank's own
  stream only.
- B not divisible by the world size raises; the device rule.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dvo_slam_tpu.models import streaming as j_streaming
from dvo_slam_tpu.parallel import dp_slam as j_dp_slam

from dvo_slam_tpu_torch import convert
from dvo_slam_tpu_torch.parallel.dp_slam import DataParallelSLAM
from dvo_slam_tpu_torch.parallel.mesh import BATCH_AXIS, Mesh
from dvo_slam_tpu_torch.utils import synthetic, trajectory
from test_torch_streaming import K_TINY, KF_ATOL, NOISE, ODO_ATOL, POSE_ATOL, SHAPE_TINY, TINY_CFG

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 120
STREAMS, FRAMES = 3, 10
ATE_GATE_M = 0.01  # tests/test_parallel.py:394-397
# (stream, frame) whose odometry result parts from the reference's beyond
# KF_ATOL: the identity-seeded ties of ROADMAP queue C
ODO_PARTED = [(2, 3)]
CFG = convert.config_from_reference(TINY_CFG)

# One rank of the port.  argv: work directory, world size, rank.
_CHILD = r"""
import sys
sys.modules["jax"] = None  # the port's multi-rank path needs no JAX
import numpy as np
import torch
torch.set_num_threads(1)
from dvo_slam_tpu_torch.models.streaming import StreamingSLAM
from dvo_slam_tpu_torch.ops.camera import Intrinsics
from dvo_slam_tpu_torch.parallel import distributed, mesh as mesh_lib
from dvo_slam_tpu_torch.parallel.dp_slam import DataParallelSLAM

work, world, rank = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
data = np.load(f"{work}/inputs.npz", allow_pickle=True)
cfg = data["cfg"].item()
K = Intrinsics(*data["K"])
iu, du, stamps = data["iu"], data["du"], data["stamps"]
distributed.initialize(init_method=f"file://{work}/store{world}", world_size=world,
                       rank=rank, backend="gloo", device="cpu")
mesh = mesh_lib.make_mesh(world, device="cpu")
dp = DataParallelSLAM(K, cfg, mesh=mesh)
online = dp.track_sequences(iu, du, stamps)
out = {"online": online, "own_slams": np.array(len(dp.slams)),
       "own_keyframes": np.array([len(s.graph.keyframes) for s in dp.slams])}
for s, (st, poses) in enumerate(dp.trajectories()):
    out[f"traj{s}/stamps"], out[f"traj{s}/poses"] = st, poses
dp.shutdown()
solo = StreamingSLAM(K, cfg, device="cpu")
out["solo"] = solo.track_frontend(iu[rank], du[rank])[1]
solo.graph.shutdown()
np.savez(f"{work}/out_w{world}_r{rank}.npz", **out)
distributed.shutdown()
"""


def _streams():
    iu = np.zeros((STREAMS, FRAMES) + SHAPE_TINY, np.uint8)
    du = np.zeros((STREAMS, FRAMES) + SHAPE_TINY, np.uint16)
    gt = np.zeros((STREAMS, FRAMES, 4, 4))
    for s in range(STREAMS):
        gt[s] = synthetic.circular_trajectory(FRAMES, radius=0.035 + 0.004 * s, rot_amplitude=0.02)
        for i, pose in enumerate(gt[s]):
            intensity, depth, valid = synthetic.render_frame(pose, K_TINY, SHAPE_TINY,
                                                             seed=31 * s + i, **NOISE)
            iu[s, i] = np.clip(intensity, 0, 255).astype(np.uint8)
            du[s, i] = np.where(valid, depth * 5000.0, 0).astype(np.uint16)
    return iu, du, gt


class _Runs:
    def __init__(self, work):
        self.work = work
        self.iu, self.du, self.gt = _streams()
        self.stamps = np.arange(FRAMES) / 30.0
        np.savez(work / "inputs.npz", iu=self.iu[:2], du=self.du[:2], stamps=self.stamps,
                 K=np.array(tuple(K_TINY)), cfg=np.array(CFG, dtype=object))
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        self.procs = [subprocess.Popen([sys.executable, "-c", _CHILD, str(work), "2", str(r)],
                                       cwd=REPO, env=env, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True) for r in range(2)]
        self.joined = False

    def out(self, rank):
        if not self.joined:
            for proc in self.procs:
                try:
                    log, _ = proc.communicate(timeout=CHILD_TIMEOUT_S)
                except subprocess.TimeoutExpired:
                    self.kill()
                    pytest.fail(f"a rank did not finish within {CHILD_TIMEOUT_S} s")
                assert proc.returncode == 0, log
            self.joined = True
        return np.load(self.work / f"out_w2_r{rank}.npz")

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    r = _Runs(tmp_path_factory.mktemp("dp"))
    yield r
    r.kill()


def test_matches_reference_at_no_mesh(runs):
    ref = j_dp_slam.DataParallelSLAM(K_TINY, TINY_CFG)
    force = np.zeros((STREAMS, FRAMES), bool)
    force[:, -1] = True
    raw = np.asarray(ref._front_b(runs.iu, runs.du, force,
                                  np.broadcast_to(np.eye(4, dtype=np.float32), (STREAMS, 4, 4))))
    dp = DataParallelSLAM(K_TINY, CFG, device="cpu")
    online = dp.track_sequences(runs.iu, runs.du, runs.stamps)
    assert online.shape == (STREAMS, FRAMES, 4, 4) and len(dp.slams) == STREAMS
    parted = []
    for s in range(STREAMS):
        ref_records = [j_streaming._decode(raw[s, i]) for i in range(FRAMES)]
        switched_on_parted = False
        for i, (a, b) in enumerate(zip(dp.slams[s].records, ref_records)):
            assert (a.accept, a.diverged, a.forced) == (b.accept, b.diverged, b.forced), (s, i)
            assert (a.kf_n, a.kf_pixels, a.odo_n, a.odo_pixels) == (
                b.kf_n, b.kf_pixels, b.odo_n, b.odo_pixels), (s, i)
            np.testing.assert_allclose(a.kf_T, b.kf_T, atol=KF_ATOL, rtol=0)
            np.testing.assert_allclose(a.odo_T, b.odo_T, atol=ODO_ATOL, rtol=0)
            if np.abs(a.odo_T - b.odo_T).max() > KF_ATOL:
                parted.append((s, i))
                switched_on_parted |= not a.accept
            gate = ODO_ATOL if switched_on_parted else POSE_ATOL
            np.testing.assert_allclose(online[s, i], b.pose, atol=gate, rtol=0)
        switches = sum(not r.accept for r in ref_records[2:])
        assert len(dp.slams[s].graph.keyframes) == switches + 1, s
    assert parted == ODO_PARTED
    dp.shutdown()
    ref.shutdown()


def test_two_ranks_bit_equal_to_solo(runs):
    r0, r1 = runs.out(0), runs.out(1)
    np.testing.assert_array_equal(r0["online"], r1["online"])
    for rank, out in enumerate((r0, r1)):
        np.testing.assert_array_equal(out["online"][rank], out["solo"])
        assert int(out["own_slams"]) == 1 and int(out["own_keyframes"][0]) >= 1
    for s in range(2):
        np.testing.assert_array_equal(r0[f"traj{s}/poses"], r1[f"traj{s}/poses"])
        ate_online = trajectory.ate_rmse(runs.stamps, r0["online"][s], runs.stamps, runs.gt[s])
        ate_opt = trajectory.ate_rmse(r0[f"traj{s}/stamps"], r0[f"traj{s}/poses"], runs.stamps,
                                      runs.gt[s])
        assert ate_online < ATE_GATE_M and ate_opt < ATE_GATE_M, (s, ate_online, ate_opt)


def test_batch_must_divide_over_the_ranks(runs):
    """3 streams over 2 ranks (the check comes before any collective, so a
    stand-in mesh is enough)."""
    dp = DataParallelSLAM(K_TINY, CFG, mesh=Mesh(None, BATCH_AXIS, 0, 2, torch.device("cpu")))
    with pytest.raises(ValueError, match="multiple of the mesh size 2"):
        dp.track_sequences(runs.iu, runs.du, runs.stamps)


def test_dp_slam_asks_for_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DataParallelSLAM(K_TINY, CFG)
    assert DataParallelSLAM(K_TINY, CFG, device="cpu").device == torch.device("cpu")
