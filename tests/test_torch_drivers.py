"""The port's drivers and host utilities against the reference's, on the CPU.

- ``utils/trajectory`` (TUM I/O, quaternions, RPE), ``utils/metrics``,
  ``utils/dataset``, ``utils/synthetic_tum`` and ``native`` (PNG decode,
  raw formats, prefetcher, its build directory): the same inputs through
  both packages give equal outputs (``tests/test_trajectory.py``,
  ``test_native.py``, ``test_tum_roundtrip.py`` and ``test_aux.py``'s
  cases).
- ``utils/serialization``: ``test_aux.py``'s pose-graph round trip and
  ``test_keyframe_graph.py``'s two checkpoint cases on the port, and
  checkpoints that load in the other package.
- ``cli/benchmark``: ``main([..., "--device", "cpu"])`` in odometry, loop
  and streaming modes on an 8-frame 60x80 synthetic sequence against the
  reference's CLI on the same arguments (the same report keys, every
  number within 2e-5 but the rotational RPE, an arccos near 1, within 1e-4), and on a TUM directory written with the benchmark's sensor noise
  (odometry against the reference's, every mode within the reference
  test's 10 mm ATE gate); ``--interactive-html`` writes the viewer.
"""

import contextlib
import io
import json
import os
import re
import shutil

import numpy as np
import pytest
import torch

from dvo_slam_tpu import native as j_native
from dvo_slam_tpu.cli import benchmark as j_cli
from dvo_slam_tpu.config import GraphConfig, KeyframeConfig, SlamConfig, TrackerConfig
from dvo_slam_tpu.models import pose_graph as j_pg
from dvo_slam_tpu.ops.camera import Intrinsics
from dvo_slam_tpu.utils import dataset as j_dataset
from dvo_slam_tpu.utils import metrics as j_metrics
from dvo_slam_tpu.utils import serialization as j_serialization
from dvo_slam_tpu.utils import synthetic_tum as j_synthetic_tum
from dvo_slam_tpu.utils import trajectory as j_trajectory

from dvo_slam_tpu_torch import convert, native
from dvo_slam_tpu_torch.cli import benchmark as t_cli
from dvo_slam_tpu_torch.models import pose_graph as t_pg
from dvo_slam_tpu_torch.models.frames import Frame
from dvo_slam_tpu_torch.models.keyframe_graph import KeyframeGraph
from dvo_slam_tpu_torch.models.keyframe_tracker import KeyframeTracker
from dvo_slam_tpu_torch.ops import se3
from dvo_slam_tpu_torch.utils import dataset, metrics, serialization, synthetic, synthetic_tum
from dvo_slam_tpu_torch.utils import trajectory

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

cv2 = pytest.importorskip("cv2")

K = Intrinsics(80.0, 80.0, 39.5, 29.5)  # tests/test_keyframe_graph.py
SHAPE = (60, 80)
CFG = convert.config_from_reference(SlamConfig(
    tracker=TrackerConfig(first_level=1, last_level=0, max_iterations_per_level=25,
                          precision=1e-4, use_initial_estimate=True),
    keyframe=KeyframeConfig(max_translational_distance=0.05, min_entropy_ratio=0.6,
                            min_equation_system_constraint_ratio=0.3),
    graph=GraphConfig(new_constraint_min_entropy_ratio_coarse=0.03,
                      new_constraint_min_entropy_ratio_fine=0.3, optimization_iterations=16,
                      final_optimization_iterations=60),
))
NOISE = dict(depth_noise=0.002, intensity_noise=1.0)
CLI_ATOL = 2e-5  # the port's CLI report against the reference's, every number but:
# the rotational RPE, an arccos near 1: per-pair transforms 1e-7 apart move
# an angle of 4e-4 rad by 2.4e-5 (the TUM directory's odometry)
RPE_ROT_ATOL = 1e-4
TUM_ATE_GATE_M = 0.010  # tests/test_tum_roundtrip.py
CLI_KEYS = {"frames", "mode", "ate_rmse_m", "ate_rmse_optimized_m", "rpe_translational_m",
            "rpe_rotational_rad", "timing"}


def _random_poses(n, seed=0, scale=0.5):
    rng = np.random.default_rng(seed)
    return se3.exp_se3(torch.from_numpy(rng.normal(0, scale, (n, 6)))).numpy()


# -- utils/trajectory ------------------------------------------------------

def test_quaternions_match_reference():
    poses = _random_poses(40, seed=1, scale=1.5)  # traces of both signs
    for T in poses:
        q = trajectory.rotation_to_quaternion(T[:3, :3])
        np.testing.assert_array_equal(q, j_trajectory.rotation_to_quaternion(T[:3, :3]))
        R = trajectory.quaternion_to_rotation(q)
        np.testing.assert_array_equal(R, j_trajectory.quaternion_to_rotation(q))
        np.testing.assert_allclose(R, T[:3, :3], atol=1e-6)
    assert any(np.trace(T[:3, :3]) <= 0 for T in poses)


def test_tum_trajectory_io_matches_reference(tmp_path):
    poses = _random_poses(10, seed=2)
    stamps = np.arange(10)[::-1] * 0.1  # written sorted by timestamp
    trajectory.write_tum_trajectory(tmp_path / "port.txt", stamps, poses)
    j_trajectory.write_tum_trajectory(tmp_path / "ref.txt", stamps, poses)
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "ref.txt").read_text()
    assert trajectory.pose_to_tum_line(0.5, poses[0]) == j_trajectory.pose_to_tum_line(0.5, poses[0])
    rs, rp = trajectory.read_tum_trajectory(tmp_path / "port.txt")
    js, jp = j_trajectory.read_tum_trajectory(tmp_path / "port.txt")
    np.testing.assert_array_equal(rs, js)
    np.testing.assert_array_equal(rp, jp)
    np.testing.assert_allclose(rp, poses[::-1], atol=1e-6)


def test_rpe_matches_reference():
    gt = _random_poses(30, seed=3, scale=0.2)
    est = gt @ _random_poses(30, seed=4, scale=0.01)
    stamps = np.arange(30) / 30.0
    for delta in (1, 3):
        got = trajectory.rpe_rmse(stamps, est, stamps, gt, delta=delta)
        assert got == j_trajectory.rpe_rmse(stamps, est, stamps, gt, delta=delta)
        assert 0 < got[0] and 0 < got[1]
    assert trajectory.rpe_rmse(stamps, gt, stamps, gt)[0] < 1e-6
    assert np.isnan(trajectory.rpe_rmse(stamps[:1], gt[:1], stamps, gt)[0])


# -- utils/metrics ---------------------------------------------------------

def test_metrics_match_reference():
    far = np.eye(4)
    far[:3, 3] = [50.0, 0.0, 0.0]
    near = _random_poses(1, seed=5, scale=0.1)[0]
    for pose in (np.eye(4), far, near):
        got = metrics.frustum_overlap(np.eye(4), pose, K, SHAPE)
        assert got == j_metrics.frustum_overlap(np.eye(4), pose, K, SHAPE)
    assert metrics.frustum_overlap(np.eye(4), np.eye(4), K, SHAPE) > 0.95
    assert metrics.frustum_overlap(np.eye(4), far, K, SHAPE) < 0.05
    A = np.diag([1.0, 2.0, 3.0])
    B = np.diag([2.0, 2.0, 1.0])
    for a, b in ((A, B), (B, A), (A, A), (A, -A)):
        assert metrics.jensen_bregman_logdet(a, b) == j_metrics.jensen_bregman_logdet(a, b)


# -- native, synthetic_tum, dataset -----------------------------------------

@pytest.fixture(scope="module")
def png_pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("pngs")
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)
    depth = rng.integers(0, 20000, (48, 64), dtype=np.uint16)
    depth[0, :5] = 0
    cv2.imwrite(str(d / "rgb.png"), rgb[..., ::-1])
    cv2.imwrite(str(d / "depth.png"), depth)
    return str(d / "rgb.png"), str(d / "depth.png"), rgb, depth


def test_native_builds_into_the_package_build_directory():
    assert native.native_available(), native.build_error()
    assert native.build_error() is None
    build = os.path.join(os.path.dirname(os.path.dirname(native.__file__)), "build")
    path = native.library_path()
    assert os.path.dirname(path) == build and os.path.exists(path)
    assert not os.path.exists(os.path.join(os.path.dirname(native.__file__), "_dvo_ingest.so"))


def test_native_decode_matches_reference_and_cv2(png_pair):
    rgb_path, depth_path, rgb, depth = png_pair
    gray, dep, valid = native.load_rgbd_native(rgb_path, depth_path)
    ref_gray = cv2.cvtColor(rgb[..., ::-1], cv2.COLOR_BGR2GRAY).astype(np.float32)
    assert np.abs(gray - ref_gray).max() <= 1.0  # +-1 LSB rounding
    np.testing.assert_array_equal(valid, depth > 0)
    np.testing.assert_allclose(dep[valid], depth[valid] / 5000.0, rtol=1e-6)
    assert (dep[~valid] == 0).all()
    if j_native.native_available():
        for a, b in zip((gray, dep, valid), j_native.load_rgbd_native(rgb_path, depth_path)):
            np.testing.assert_array_equal(a, b)
    g8, d16 = native.load_rgbd_raw(rgb_path, depth_path)
    assert g8.dtype == np.uint8 and d16.dtype == np.uint16
    np.testing.assert_array_equal(d16, depth)
    np.testing.assert_array_equal(g8.astype(np.float32), gray)


def test_prefetcher_order_and_content(png_pair):
    rgb_path, depth_path, _, depth = png_pair
    pf = native.RgbdFramePrefetcher([(rgb_path, depth_path)] * 7, depth=3, workers=2, raw=True)
    frames = list(pf)
    pf.close()
    assert len(frames) == 7
    for _, d16 in frames:
        np.testing.assert_array_equal(d16, depth)


def test_native_rejects_garbage(tmp_path):
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not a png at all")
    with pytest.raises(ValueError):
        native.load_rgbd_native(str(bad), str(bad))


@pytest.fixture(scope="module")
def tum_dirs(tmp_path_factory):
    """The same sequence written by the port and by the reference, with
    the benchmark's sensor noise (streams started at the identity warp
    part from the compiled reference on noise-free scenes, ROADMAP queue C)."""
    base = tmp_path_factory.mktemp("tum")
    port = synthetic_tum.write_tum_sequence(str(base / "port" / "rgbd_dataset_synth"),
                                            num_frames=10, shape=SHAPE, seed=3, **NOISE)
    ref = j_synthetic_tum.write_tum_sequence(str(base / "ref" / "rgbd_dataset_synth"),
                                             num_frames=10, shape=SHAPE, seed=3, **NOISE)
    return port, ref


def test_synthetic_tum_matches_reference(tum_dirs):
    port, ref = tum_dirs
    for name in ("assoc.txt", "rgb.txt", "depth.txt", "groundtruth.txt", "intrinsics.txt"):
        with open(os.path.join(port, name)) as a, open(os.path.join(ref, name)) as b:
            assert a.read() == b.read(), name
    for sub in ("rgb", "depth"):
        names = sorted(os.listdir(os.path.join(port, sub)))
        assert names == sorted(os.listdir(os.path.join(ref, sub))) and len(names) == 10
        for n in names:
            a = cv2.imread(os.path.join(port, sub, n), cv2.IMREAD_UNCHANGED)
            b = cv2.imread(os.path.join(ref, sub, n), cv2.IMREAD_UNCHANGED)
            np.testing.assert_array_equal(a, b)


def test_tum_dataset_matches_reference(tum_dirs):
    """tests/test_tum_roundtrip.py's round trip through both loaders."""
    port_dir, _ = tum_dirs
    ds, ref = dataset.TumDataset(port_dir), j_dataset.TumDataset(port_dir)
    assert len(ds) == len(ref) == 10 and ds.pairs == ref.pairs
    assert tuple(ds.intrinsics) == tuple(ref.intrinsics)
    for i in (0, 4, 9):
        a, b = ds[i], ref[i]
        assert a.timestamp == b.timestamp
        for x, y in ((a.intensity, b.intensity), (a.depth, b.depth), (a.valid, b.valid)):
            np.testing.assert_array_equal(x, y)
    poses = synthetic.circular_trajectory(10, radius=0.05, rot_amplitude=0.02)
    intensity, depth, valid = synthetic.render_frame(poses[4], ds.intrinsics, SHAPE, seed=3 + 4,
                                                     **NOISE)
    f = ds[4]
    assert np.abs(f.intensity - np.clip(np.rint(intensity), 0, 255)).max() <= 1.0
    assert np.array_equal(f.valid, valid & (np.rint(depth * 5000) > 0))
    assert np.abs(f.depth[f.valid] - depth[f.valid]).max() <= 1.01 / 5000.0


def test_tum_association_fallback(tmp_path):
    root = synthetic_tum.write_tum_sequence(str(tmp_path / "noassoc"), num_frames=5, shape=SHAPE,
                                            write_assoc=False)
    ds = dataset.TumDataset(root)
    assert len(ds) == 5 and ds.pairs == j_dataset.TumDataset(root).pairs
    assert ds[0].intensity.shape == SHAPE


def test_tum_dataset_with_assoc_and_freiburg_intrinsics(tmp_path, png_pair):
    """tests/test_native.py::test_tum_dataset_with_assoc, and the
    per-freiburg presets of both packages."""
    rgb_path, depth_path, _, _ = png_pair
    root = tmp_path / "seq_freiburg1_test"
    (root / "rgb").mkdir(parents=True)
    (root / "depth").mkdir()
    shutil.copy(rgb_path, root / "rgb" / "0.png")
    shutil.copy(depth_path, root / "depth" / "0.png")
    (root / "assoc.txt").write_text("1.0 rgb/0.png 1.001 depth/0.png\n")
    ds = dataset.TumDataset(str(root))
    assert len(ds) == 1
    frame = ds[0]
    assert frame.intensity.shape == (48, 64) and frame.timestamp == 1.0
    assert (frame.depth[~frame.valid] == 0).all()
    for name in ("rgbd_dataset_freiburg1_desk", "fr2_xyz", "freiburg3_office", "other"):
        assert tuple(dataset.intrinsics_for_sequence(name)) == tuple(
            j_dataset.intrinsics_for_sequence(name))


def test_synthetic_dataset_matches_reference():
    kw = dict(num_frames=4, shape=SHAPE, intrinsics=K, depth_noise=0.002, intensity_noise=1.0)
    ds, ref = dataset.SyntheticDataset(**kw), j_dataset.SyntheticDataset(**kw)
    np.testing.assert_array_equal(ds.groundtruth(), ref.groundtruth())
    np.testing.assert_array_equal(ds.timestamps(), ref.timestamps())
    for a, b in zip(ds, ref):
        assert a.timestamp == b.timestamp
        for x, y in ((a.intensity, b.intensity), (a.depth, b.depth), (a.valid, b.valid)):
            np.testing.assert_array_equal(x, y)


# -- utils/serialization ---------------------------------------------------

def _small_graph(pg, T):
    g = pg.PoseGraph()
    g.add_vertex(("kf", 1), np.eye(4), fixed=True)
    g.add_vertex(("kf", 2), T)
    g.add_vertex(("f", 0), T)
    g.add_edge(("kf", 1), ("kf", 2), T, 2 * np.eye(6), robust=True, level=0)
    e1 = g.add_edge(("kf", 2), ("f", 0), np.eye(4), np.eye(6), level=2)
    g.deactivate_edges([e1])
    return g


def test_pose_graph_checkpoint_roundtrip_and_across_packages(tmp_path):
    """tests/test_aux.py::test_pose_graph_checkpoint_roundtrip on the port;
    then the port's checkpoint loads in the reference and the reference's
    in the port, every array equal."""
    T = se3.exp_se3(torch.tensor([0.1, 0.0, 0.0, 0.0, 0.0, 0.2], dtype=torch.float64)).numpy()
    path = str(tmp_path / "graph.npz")
    serialization.save_pose_graph(path, _small_graph(t_pg, T), extra={"note": "test"})
    g2 = serialization.load_pose_graph(path)
    assert g2.num_vertices == 3 and g2.num_edges == 2
    np.testing.assert_allclose(g2.vertex_pose(("kf", 2)), T, atol=1e-6)
    assert g2.fixed[g2.vertex_index(("kf", 1))]
    assert bool(g2.robust[0]) and int(g2.edge_level[1]) == 2
    assert not g2.edge_active[1]
    assert serialization.checkpoint_extra(path)["note"] == "test"
    g2.optimize(iterations=5)

    ref_path = str(tmp_path / "ref.npz")
    j_serialization.save_pose_graph(ref_path, _small_graph(j_pg, T), extra={"note": "test"})
    for saved in (path, ref_path):
        a, b = serialization.load_pose_graph(saved), j_serialization.load_pose_graph(saved)
        assert a._vertex_ids == b._vertex_ids
        for field in ("poses", "fixed"):
            np.testing.assert_array_equal(getattr(a, field)[:3], getattr(b, field)[:3])
        for field in ("edge_i", "edge_j", "measurements", "information", "edge_active",
                      "robust", "edge_level"):
            np.testing.assert_array_equal(getattr(a, field)[:2], getattr(b, field)[:2])
        assert serialization.checkpoint_extra(saved) == j_serialization.checkpoint_extra(saved)


def _frame(poses, ts):
    i = int(round(ts * 30.0))
    i_, d_, v_ = synthetic.render_frame(poses[i], K, SHAPE, seed=i)
    return Frame.from_arrays(i_, d_, v_, ts, CFG.tracker.num_levels, device="cpu")


def _run(poses, finish=True):
    """tests/test_keyframe_graph.py's run on the port."""
    kt = KeyframeTracker(K, CFG, use_threading=False, device="cpu")
    kt.init()
    for i in range(len(poses)):
        kt.update(_frame(poses, i / 30.0))
    if finish:
        kt.force_keyframe()
        kt.finish()
    return kt


def test_keyframe_graph_checkpoint_roundtrip(tmp_path):
    """tests/test_keyframe_graph.py::test_keyframe_graph_checkpoint_roundtrip
    on the port."""
    kt = _run(synthetic.circular_trajectory(14, radius=0.05))
    path = str(tmp_path / "slam_state.npz")
    serialization.save_keyframe_graph(path, kt.graph)
    restored = KeyframeGraph(K, CFG.graph, CFG.tracker, use_threading=False)
    serialization.load_keyframe_graph_state(path, restored)
    s1, p1 = kt.trajectory()
    s2, p2 = restored.trajectory()
    np.testing.assert_allclose(s1, s2)
    np.testing.assert_allclose(p1, p2, atol=1e-6)
    assert [k.id for k in restored.keyframes] == [k.id for k in kt.graph.keyframes]
    for a, b in zip(restored.keyframes, kt.graph.keyframes):
        assert a.evaluation._first == b.evaluation._first
        assert a.evaluation._n == b.evaluation._n


def test_checkpoint_resume_full_workflow(tmp_path):
    """tests/test_keyframe_graph.py::test_checkpoint_resume_full_workflow on
    the port: save mid-sequence, restore into a fresh back end with the
    keyframes' frames re-attached, continue tracking, loop-close and
    final-optimize."""
    n = 16
    poses = synthetic.circular_trajectory(n, radius=0.08, rot_amplitude=0.03)
    gt_stamps = np.arange(n) / 30.0
    s_full, p_full = _run(poses).trajectory()
    ate_full = trajectory.ate_rmse(s_full, p_full, gt_stamps, poses)

    kt_a = _run(poses[:9], finish=False)
    path = str(tmp_path / "mid.npz")
    serialization.save_keyframe_graph(path, kt_a.graph)
    restored = KeyframeGraph(K, CFG.graph, CFG.tracker, use_threading=False)
    serialization.load_keyframe_graph_state(path, restored,
                                            frame_provider=lambda ts: _frame(poses, ts))
    for k in restored.keyframes:
        assert k.frame.levels is not None and k.evaluation is not None
    assert restored._pending_key is not None

    kt_b = KeyframeTracker(K, CFG, graph=restored, device="cpu")
    resume_ts = restored.timestamps[restored._pending_key]
    kt_b.init(restored.graph.vertex_pose(restored._pending_key))
    for i in range(int(round(resume_ts * 30.0)), n):
        kt_b.update(_frame(poses, i / 30.0))
    kt_b.force_keyframe()
    kt_b.finish()
    s_res, p_res = kt_b.trajectory()
    assert len(np.unique(np.round(s_res * 30.0))) == n
    ate_res = trajectory.ate_rmse(s_res, p_res, gt_stamps, poses)
    assert ate_res < 0.01, (ate_res, ate_full)
    assert ate_res < max(2.5 * ate_full, 0.005), (ate_res, ate_full)


# -- cli/benchmark ---------------------------------------------------------

def _cli(main, args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(args)
    return rc, json.loads(out.getvalue())


def _assert_reports_close(report, ref):
    for key in CLI_KEYS - {"frames", "mode", "timing"}:
        atol = RPE_ROT_ATOL if key == "rpe_rotational_rad" else CLI_ATOL
        assert abs(report[key] - ref[key]) <= atol, (key, report[key], ref[key])


MODES = {"odometry": ["--mode", "odometry"], "loop": ["--mode", "slam", "--engine", "loop"],
         "streaming": ["--mode", "slam", "--engine", "streaming"]}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_cli_synthetic_matches_reference(mode, tmp_path):
    args = ["--synthetic", "8", "--shape", "60x80", "--timing"] + MODES[mode]
    rc, report = _cli(t_cli.main, args + ["--output-dir", str(tmp_path / "port"),
                                          "--device", "cpu"])
    ref_rc, ref = _cli(j_cli.main, args + ["--output-dir", str(tmp_path / "ref")])
    assert rc == ref_rc == 0
    assert set(report) == set(ref) == CLI_KEYS
    assert set(report["timing"]) == set(ref["timing"])
    assert (report["frames"], report["mode"]) == (ref["frames"], ref["mode"])
    _assert_reports_close(report, ref)
    files = {"trajectory.txt"} | ({"trajectory_optimized.txt", "edge_errors.txt"}
                                  if mode != "odometry" else set())
    assert files <= set(os.listdir(tmp_path / "port"))
    lines = (tmp_path / "port" / "trajectory.txt").read_text().strip().splitlines()
    assert len(lines) == 8 and len(lines[0].split()) == 8


@pytest.mark.parametrize("mode", sorted(MODES))
def test_cli_on_tum_directory(mode, tum_dirs, tmp_path):
    """tests/test_tum_roundtrip.py::test_cli_odometry_on_tum_directory on
    the port in each mode; odometry also against the reference's CLI."""
    port_dir, _ = tum_dirs
    args = ["--dataset", port_dir] + MODES[mode]
    rc, report = _cli(t_cli.main, args + ["--output-dir", str(tmp_path), "--device", "cpu"])
    assert rc == 0 and report["frames"] == 10
    assert report["ate_rmse_m"] < TUM_ATE_GATE_M, report
    assert report["ate_rmse_optimized_m"] < TUM_ATE_GATE_M, report
    if mode == "odometry":
        _, ref = _cli(j_cli.main, args + ["--output-dir", str(tmp_path / "ref")])
        _assert_reports_close(report, ref)


def test_cli_refuses_what_it_cannot_do(capsys):
    assert t_cli.main([]) == 2
    assert "--dataset or --synthetic" in capsys.readouterr().err


@pytest.mark.parametrize("engine", ["loop", "streaming"])
def test_cli_writes_the_interactive_viewer(engine, tmp_path):
    """``--interactive-html g.html`` in SLAM mode exits 0 and writes the
    viewer into the output directory: one HTML file whose embedded payload
    parses, with the reference's keys, a keyframe entry per keyframe of
    the trajectory's graph and an edge per graph edge."""
    rc, report = _cli(t_cli.main, ["--synthetic", "8", "--shape", "60x80", "--mode", "slam",
                                   "--engine", engine, "--interactive-html", "g.html",
                                   "--device", "cpu",
                                   "--output-dir", str(tmp_path)])
    assert rc == 0 and report["frames"] == 8
    html = (tmp_path / "g.html").read_text()
    assert "<canvas" in html and not os.path.exists(tmp_path / "g.html.tmp")
    payload = json.loads(re.search(r"const D = (.*?);\n", html).group(1))
    assert set(payload) == {"title", "trajectory", "keyframes", "edges", "clouds", "errimgs"}
    assert len(payload["keyframes"]) >= 2 and len(payload["edges"]) >= 1
    assert len(payload["trajectory"]) >= len(payload["keyframes"])


def test_cli_profile_dir(tmp_path):
    rc, report = _cli(t_cli.main, ["--synthetic", "3", "--shape", "60x80", "--mode", "odometry",
                                   "--device", "cpu", "--output-dir", str(tmp_path),
                                   "--profile-dir", str(tmp_path / "trace")])
    assert rc == 0 and report["frames"] == 3
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
