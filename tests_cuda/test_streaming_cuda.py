"""The streaming SLAM front end and the benchmark CLI on the card.

``StreamingSLAM.track_frontend`` at 120x160 (``tests/test_streaming.py``'s
intrinsics and config, 10 noisy frames) on the card against the same call
on the CPU (the plain version): accept, divergence and force flags equal on
every frame, poses within 1e-4; the dual matches run the batched kernel and
the bootstrap the one-stream kernel, the plain version never.  The CLI
runs the streaming engine with the default device, the card.  The native
ingest extension builds into the package's ``build/`` directory (it needs
no libpng), the ingest reduction takes it, and the port's writer's files
decode through it with each scanline filter.
"""

import contextlib
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

from dvo_slam_tpu_torch import native
from dvo_slam_tpu_torch.cli import benchmark
from dvo_slam_tpu_torch.config import GraphConfig, KeyframeConfig, SlamConfig, TrackerConfig
from dvo_slam_tpu_torch.models import streaming
from dvo_slam_tpu_torch.models.streaming import StreamingSLAM
from dvo_slam_tpu_torch.ops.camera import Intrinsics
from dvo_slam_tpu_torch.tools import driver_launches
from dvo_slam_tpu_torch.utils import dataset, synthetic, synthetic_tum

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
    driver_launches.reset_counts()
    card = StreamingSLAM(K, CFG)
    assert card.device.type == "cuda"
    rec_card, poses_card = card.track_frontend(iu8, du16)
    counts = driver_launches.launches()  # the while graphs' launches folded in
    assert counts[driver_launches.ONE] > 0 and counts[driver_launches.BATCHED] > 0
    cpu = StreamingSLAM(K, CFG, device="cpu")
    rec_cpu, poses_cpu = cpu.track_frontend(iu8, du16)
    for i, (a, b) in enumerate(zip(rec_card, rec_cpu)):
        assert (a.accept, a.diverged, a.forced) == (b.accept, b.diverged, b.forced), i
    np.testing.assert_allclose(poses_card, poses_cpu, atol=POSE_ATOL, rtol=0)
    card.graph.shutdown()
    cpu.graph.shutdown()


def test_native_build_lands_in_the_package_build_directory():
    """The extension needs g++ and the Python headers alone, so it builds on
    the card's machine; the ingest reduction and the dataset loader take
    it, not their NumPy and cv2 fallbacks."""
    build = os.path.join(os.path.dirname(os.path.dirname(native.__file__)), "build")
    assert native.build_error() is None, native.build_error()
    assert os.path.dirname(native.library_path()) == build
    assert os.path.exists(native.library_path())
    iu8, du16 = _raw(2)
    i_out, d_out = streaming.host_reduce_ingest(iu8, du16, 1)
    assert streaming.host_reduce_ingest.last_path == "native", \
        streaming.host_reduce_ingest.last_reason
    i_ref, d_ref = streaming.reduce_ingest_numpy(iu8, du16, 1)
    assert np.array_equal(i_out, i_ref) and np.array_equal(d_out, d_ref)


def test_the_writers_five_filters_decode_on_the_card_host(tmp_path, monkeypatch):
    """Files of the port's writer, one per scanline filter and one cycling
    all five, decode bit-equal through ``load_tum_image_pair`` with the
    native decoder (``import cv2`` is made to fail)."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    iu8, du16 = _raw(1)
    for filters in (0, 1, 2, 3, 4, "cycle"):
        rgb, dep = str(tmp_path / f"rgb{filters}.png"), str(tmp_path / f"depth{filters}.png")
        synthetic_tum._write_png(rgb, np.repeat(iu8[0][..., None], 3, axis=-1), filters)
        synthetic_tum._write_png(dep, du16[0], filters)
        gray, depth, valid = dataset.load_tum_image_pair(rgb, dep)
        assert np.array_equal(gray, iu8[0].astype(np.float32)), filters
        assert np.array_equal(valid, du16[0] > 0), filters
        assert np.array_equal(depth, np.where(valid, du16[0].astype(np.float32) / 5000.0,
                                              0.0)), filters


def test_cli_streaming_on_the_default_device(tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = benchmark.main(["--synthetic", "8", "--shape", "120x160", "--engine", "streaming",
                             "--timing", "--output-dir", str(tmp_path)])
    report = json.loads(out.getvalue())
    assert rc == 0 and report["frames"] == 8
    assert np.isfinite(report["ate_rmse_m"]) and np.isfinite(report["ate_rmse_optimized_m"])
    assert torch.cuda.is_available()
