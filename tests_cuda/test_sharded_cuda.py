"""The pixel-sharded matcher with two ranks on one card: two gloo ranks
share ``cuda:0`` (NCCL refuses two ranks on one device), each runs the
sharded evaluation's three kernels on its pixel shard, and the two
all-reduces go through gloo.  Held against the same matcher at one rank on the card: per-level
iterations and terminations equal, the estimate within 1e-5.

The ranks are child processes that rendezvous on a ``file://`` store in
``tmp_path``; each is joined with its own timeout and killed on expiry.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 300

_CHILD = r"""
import sys
import numpy as np
import torch
from dvo_slam_tpu_torch import benchmark_config
from dvo_slam_tpu_torch.odometry import build_frame, render_sequence, upload_sequence
from dvo_slam_tpu_torch.ops import fused_kernels
from dvo_slam_tpu_torch.ops.camera import TUM_FR1
from dvo_slam_tpu_torch.parallel import distributed, mesh as mesh_lib, sharded_alignment
from dvo_slam_tpu_torch.utils import synthetic

work, world, rank = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
cfg = benchmark_config().tracker
poses = synthetic.circular_trajectory(100, radius=0.05, rot_amplitude=0.02)
d_i, d_d = upload_sequence(*render_sequence(poses[:2], (480, 640), TUM_FR1), "cuda")
frames = [build_frame(cfg, d_i[k], d_d[k]) for k in (0, 1)]
distributed.initialize(init_method=f"file://{work}/store{world}", world_size=world,
                       rank=rank, backend="gloo")
mesh = mesh_lib.make_mesh(world)
assert mesh.device == torch.device("cuda", 0), mesh.device
run = sharded_alignment.make_pixel_sharded_matcher(cfg, TUM_FR1, mesh)
result = run(frames[0], frames[1], torch.eye(4, device="cuda"))
iterations = sum(int(s.iterations) for s in result.level_stats)
launches = [w.launches for w in (fused_kernels.warp_fused_partials_cuda,
                                 fused_kernels.sharded_loglik_cuda,
                                 fused_kernels.sharded_tail_cuda)]
assert launches == [iterations] * 3, (launches, iterations)
assert fused_kernels.fused_partials_cuda.launches == 0
np.savez(f"{work}/out_w{world}_r{rank}.npz", T=result.transformation.cpu().numpy(),
         counts=np.array([[int(s.iterations), int(s.termination)] for s in result.level_stats]))
distributed.shutdown()
"""


def _run_ranks(work, world):
    from dvo_slam_tpu_torch import _build

    _build.load_library("fused_stats")  # build once, before the ranks load it
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _CHILD, str(work), str(world), str(rank)],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for rank in range(world)
    ]
    for proc in procs:
        try:
            log, _ = proc.communicate(timeout=CHILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
                p.communicate()
            pytest.fail(f"a rank did not finish within {CHILD_TIMEOUT_S} s")
        assert proc.returncode == 0, log
    return [np.load(work / f"out_w{world}_r{rank}.npz") for rank in range(world)]


def test_two_gloo_ranks_on_one_card_match_one_rank(tmp_path):
    two = _run_ranks(tmp_path, 2)
    one = _run_ranks(tmp_path, 1)[0]
    np.testing.assert_array_equal(two[0]["T"], two[1]["T"])
    np.testing.assert_array_equal(two[0]["counts"], one["counts"])
    np.testing.assert_allclose(two[0]["T"], one["T"], atol=1e-5)
