"""The streaming SLAM front end and the benchmark CLI on the card.

``StreamingSLAM.track_frontend`` at 120x160 (``tests/test_streaming.py``'s
intrinsics and config, 10 noisy frames) on the card against the same call
on the CPU (the plain version): accept, divergence and force flags equal on
every frame, poses within 1e-4; the dual matches run the batched kernel and
the bootstrap the one-stream kernel, the plain version never.  The native
ingest extension builds into the package's ``build/`` directory (or its
build error is recorded).  The CLI runs the streaming engine with the
default device, the card.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from dvo_slam_tpu_torch import native
from dvo_slam_tpu_torch.cli import benchmark
from dvo_slam_tpu_torch.config import GraphConfig, KeyframeConfig, SlamConfig, TrackerConfig
from dvo_slam_tpu_torch.models.streaming import StreamingSLAM
from dvo_slam_tpu_torch.ops import fused_kernels
from dvo_slam_tpu_torch.ops.camera import Intrinsics
from dvo_slam_tpu_torch.utils import synthetic

pytestmark = pytest.mark.cuda

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
POSE_ATOL = 1e-4


def _raw(n):
    poses = synthetic.circular_trajectory(n, radius=0.06, rot_amplitude=0.03)
    iu8 = np.zeros((n,) + SHAPE, np.uint8)
    du16 = np.zeros((n,) + SHAPE, np.uint16)
    for i, pose in enumerate(poses):
        intensity, depth, valid = synthetic.render_frame(pose, K, SHAPE, seed=i, depth_noise=0.002,
                                                         intensity_noise=1.0)
        iu8[i] = np.clip(intensity, 0, 255).astype(np.uint8)
        du16[i] = np.where(valid, depth * 5000.0, 0).astype(np.uint16)
    return iu8, du16


def test_frontend_on_the_card_matches_the_cpu():
    iu8, du16 = _raw(10)
    kernels = (fused_kernels.warp_fused_stats_cuda, fused_kernels.warp_fused_stats_batched_cuda)
    for k in kernels:
        k.launches = 0
    card = StreamingSLAM(K, CFG)
    assert card.device.type == "cuda"
    rec_card, poses_card = card.track_frontend(iu8, du16)
    assert kernels[0].launches > 0 and kernels[1].launches > 0
    cpu = StreamingSLAM(K, CFG, device="cpu")
    rec_cpu, poses_cpu = cpu.track_frontend(iu8, du16)
    for i, (a, b) in enumerate(zip(rec_card, rec_cpu)):
        assert (a.accept, a.diverged, a.forced) == (b.accept, b.diverged, b.forced), i
    np.testing.assert_allclose(poses_card, poses_cpu, atol=POSE_ATOL, rtol=0)
    card.graph.shutdown()
    cpu.graph.shutdown()


def test_native_build_lands_in_the_package_build_directory():
    build = os.path.join(os.path.dirname(os.path.dirname(native.__file__)), "build")
    if native.native_available():
        assert os.path.dirname(native.library_path()) == build
        assert os.path.exists(native.library_path())
    else:  # no g++/libpng here: the NumPy and cv2 fallbacks run, and say why
        assert native.build_error()


def test_cli_streaming_on_the_default_device(tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = benchmark.main(["--synthetic", "8", "--shape", "120x160", "--engine", "streaming",
                             "--timing", "--output-dir", str(tmp_path)])
    report = json.loads(out.getvalue())
    assert rc == 0 and report["frames"] == 8
    assert np.isfinite(report["ate_rmse_m"]) and np.isfinite(report["ate_rmse_optimized_m"])
    assert torch.cuda.is_available()
