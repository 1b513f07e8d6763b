"""The port's warps, histogram and viewers against the reference's, on the
CPU: ``ops/warp``, ``utils/histogram``, ``utils/visualization`` and
``utils/interactive_viz``.

- The cases of ``tests/test_warp_viz.py`` and the warp cases of
  ``tests/test_occlusion.py`` on the port, each also against the
  reference's function on the same inputs.  The samplers are bit-equal
  (``test_torch_modular.py``); the warps' point transform rounds otherwise
  than the reference's CPU matrix product by an ulp (ibid.), so the warped
  images agree within 1e-3 gray levels and 1e-5 m where both are valid, a
  projection that lands on a rounding edge (a floor, a round, a bounds test)
  can move a pixel, and the valid masks differ in at most 0.2 % of the
  pixels.  The histogram and the PLY export are equal to the reference's.
- The slow cases of ``tests/test_warp_viz.py`` (the edge error images and
  the interactive viewer) and ``tests/test_occlusion.py`` (streaming SLAM
  on the occluded scene) in a not-slow form at a smaller size: the viewer
  of a port-built ``KeyframeGraph`` carries the payload keys and counts of
  the reference's viewer of the reference-built graph from the same maps;
  ``attach_live_viewer`` re-exports on a map change.
"""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvo_slam_tpu.config import GraphConfig as JGraphConfig
from dvo_slam_tpu.config import TrackerConfig as JTrackerConfig
from dvo_slam_tpu.models.frames import Frame as JFrame
from dvo_slam_tpu.models.keyframe_graph import KeyframeGraph as JKeyframeGraph
from dvo_slam_tpu.models.local_map import LocalMap as JLocalMap
from dvo_slam_tpu.models.streaming import _ReplayEvaluation
from dvo_slam_tpu.ops import interp as j_interp
from dvo_slam_tpu.ops import pyramid as j_pyr
from dvo_slam_tpu.ops import se3 as j_se3
from dvo_slam_tpu.ops import warp as j_warp
from dvo_slam_tpu.ops.camera import Intrinsics as JIntrinsics
from dvo_slam_tpu.utils import histogram as j_hist
from dvo_slam_tpu.utils import interactive_viz as j_iviz
from dvo_slam_tpu.utils import synthetic as j_syn
from dvo_slam_tpu.utils import visualization as j_viz

from dvo_slam_tpu_torch import convert
from dvo_slam_tpu_torch.config import GraphConfig, KeyframeConfig, SlamConfig, TrackerConfig
from dvo_slam_tpu_torch.models.evaluation import RestoredEvaluation
from dvo_slam_tpu_torch.models.frames import Frame
from dvo_slam_tpu_torch.models.keyframe_graph import KeyframeGraph
from dvo_slam_tpu_torch.models.keyframe_tracker import KeyframeTracker
from dvo_slam_tpu_torch.models.local_map import LocalMap
from dvo_slam_tpu_torch.models.streaming import StreamingSLAM
from dvo_slam_tpu_torch.ops import interp, pyramid, se3, warp
from dvo_slam_tpu_torch.ops.camera import Intrinsics
from dvo_slam_tpu_torch.utils import histogram, interactive_viz, synthetic, trajectory
from dvo_slam_tpu_torch.utils import visualization

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

K = Intrinsics(80.0, 80.0, 39.5, 29.5)
JK = JIntrinsics(*K)
SHAPE = (60, 80)
VALUE_ATOL = 1e-3  # gray levels, where both packages' warps are valid
DEPTH_ATOL = 1e-5  # meters
MASK_SHARE = 0.002  # of the pixels whose validity may differ


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _levels(pose, scene=None, gate=True, **kw):
    """Level 0 of a rendered frame in both packages (bit-equal)."""
    i, d, v = j_syn.render_frame(pose, JK, SHAPE, scene=scene, **kw)
    extra = {} if gate else {"max_depth_derivative": 0.0}
    return (j_pyr.make_level(jnp.asarray(i), jnp.asarray(d), jnp.asarray(v), **extra),
            pyramid.make_level(_t(i), _t(d), _t(v), **extra))


def _T(twist):
    return np.asarray(j_se3.exp_se3(jnp.asarray(twist, jnp.float32)), np.float64)


def _warp_T(T):
    inv = np.linalg.inv(T).astype(np.float32)
    return jnp.asarray(inv), _t(inv)


def _assert_images_close(got, want, atol):
    """Valid masks differ in at most MASK_SHARE of the pixels; the values
    agree within ``atol`` where both are valid."""
    (g, gv), (w, wv) = (tuple(_np(x) for x in got), tuple(_np(x) for x in want))
    assert (gv != wv).mean() <= MASK_SHARE, (gv != wv).sum()
    both = gv & wv
    np.testing.assert_allclose(g[both], w[both], rtol=0, atol=atol)
    return gv


def test_inverse_warp_reconstructs_reference():
    T = _T([0.02, 0.01, 0.0, 0.0, 0.0, 0.01])
    (j_ref, ref), (j_cur, cur) = _levels(np.eye(4)), _levels(T)
    jT, tT = _warp_T(T)
    got = warp.warp_intensity_inverse(ref.depth, ref.valid, cur, K, tT)
    with jax.disable_jit():
        want = j_warp.warp_intensity_inverse(j_ref.depth, j_ref.valid, j_cur, JK, jT)
    v = _assert_images_close(got, want, VALUE_ATOL)
    assert v.mean() > 0.7
    err = np.abs(_np(got[0]) - _np(ref.intensity))[v]
    assert np.median(err) < 1.0, np.median(err)


def test_error_image_small_at_truth_large_at_identity():
    T = _T([0.05, 0.0, 0.0, 0.0, 0.0, 0.0])
    (j_ref, ref), (j_cur, cur) = _levels(np.eye(4)), _levels(T)
    jT, tT = _warp_T(T)
    means = []
    for j_warp_T, t_warp_T in ((jT, tT), (jnp.eye(4), torch.eye(4))):
        got = warp.intensity_error_image(ref, cur, K, t_warp_T)
        with jax.disable_jit():
            want = j_warp.intensity_error_image(j_ref, j_cur, JK, j_warp_T)
        v = _assert_images_close(got, want, VALUE_ATOL)
        means.append(float(_np(got[0])[v].mean()))
    assert means[0] * 3 < means[1], means


def test_forward_depth_warp_roundtrip():
    T = _T([0.03, 0.0, 0.0, 0.0, 0.0, 0.0])
    (j_ref, ref), (_, tgt) = _levels(np.eye(4)), _levels(T)
    jT, tT = _warp_T(T)
    got = warp.warp_depth_forward(ref.depth, ref.valid, K, tT)
    with jax.disable_jit():
        want = j_warp.warp_depth_forward(j_ref.depth, j_ref.valid, JK, jT)
    _assert_images_close(got, want, DEPTH_ATOL)
    both = _np(got[1]) & _np(tgt.valid)
    assert both.mean() > 0.5
    assert np.median(np.abs(_np(got[0]) - _np(tgt.depth))[both]) < 0.02


def test_normals_point_against_view_direction():
    (j_ref, ref) = _levels(np.eye(4))
    normals, ok = warp.compute_normals(ref.depth, ref.valid, K)
    with jax.disable_jit():
        j_normals, j_ok = j_warp.compute_normals(j_ref.depth, j_ref.valid, JK)
    np.testing.assert_array_equal(_np(ok), _np(j_ok))
    np.testing.assert_allclose(_np(normals), _np(j_normals), rtol=0, atol=1e-6)
    n = _np(normals)[_np(ok)]
    assert len(n) > 1000
    np.testing.assert_allclose(np.linalg.norm(n, axis=1), 1.0, atol=1e-4)


def test_histogram_median_entropy():
    rng = np.random.default_rng(0)
    data = rng.normal(0, 1, (64, 64)).astype(np.float32)
    mask = rng.random((64, 64)) > 0.1
    hist = histogram.compute_histogram(_t(data), _t(mask), 101, -5.0, 5.0)
    j_hist_ = j_hist.compute_histogram(jnp.asarray(data), jnp.asarray(mask), 101, -5.0, 5.0)
    np.testing.assert_array_equal(_np(hist), _np(j_hist_))
    assert float(hist.sum()) == mask.sum()
    med = histogram.median_from_histogram(hist, -5.0, 5.0)
    assert float(med) == float(j_hist.median_from_histogram(j_hist_, -5.0, 5.0))
    assert abs(float(med) - float(np.median(data[mask]))) < 0.1
    ent = float(histogram.entropy_from_histogram(hist))
    np.testing.assert_allclose(ent, float(j_hist.entropy_from_histogram(j_hist_)), rtol=1e-6)
    assert 0.0 < ent < np.log2(101)
    delta = histogram.compute_histogram(torch.zeros(8, 8), torch.ones(8, 8, dtype=torch.bool),
                                        11, -1, 1)
    assert float(histogram.entropy_from_histogram(delta)) < 1e-6


def test_visualization_outputs(tmp_path):
    poses = synthetic.circular_trajectory(10, radius=0.05)
    visualization.plot_trajectory(str(tmp_path / "traj.png"), poses, poses, title="test")
    assert (tmp_path / "traj.png").stat().st_size > 1000
    i, d, v = synthetic.render_frame(np.eye(4), K, SHAPE)
    pose = poses[3]
    visualization.export_point_cloud_ply(str(tmp_path / "cloud.ply"), i, d, v, K, pose, stride=4)
    j_viz.export_point_cloud_ply(str(tmp_path / "ref.ply"), i, d, v, JK, pose, stride=4)
    text = (tmp_path / "cloud.ply").read_text()
    assert text == (tmp_path / "ref.ply").read_text()
    lines = text.splitlines()
    assert lines[0] == "ply"
    assert int([ln for ln in lines if ln.startswith("element vertex")][0].split()[-1]) > 100
    err = np.abs(np.random.default_rng(0).normal(0, 5, SHAPE)).astype(np.float32)
    visualization.save_error_image(str(tmp_path / "err.png"), err, np.ones(SHAPE, bool))
    assert (tmp_path / "err.png").stat().st_size > 1000


def test_figures_name_matplotlib_when_it_is_missing(monkeypatch, tmp_path):
    import sys

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        visualization.save_error_image(str(tmp_path / "e.png"), np.zeros(SHAPE), np.ones(SHAPE, bool))


def test_forward_intensity_warp_roundtrip():
    T = _T([0.02, 0.01, 0.0, 0.0, 0.0, 0.01])
    (j_ref, ref), (_, tgt) = _levels(np.eye(4)), _levels(T)
    jT, tT = _warp_T(T)
    got = warp.warp_intensity_forward(ref.intensity, ref.depth, ref.valid, K, tT)
    with jax.disable_jit():
        want = j_warp.warp_intensity_forward(j_ref.intensity, j_ref.depth, j_ref.valid, JK, jT)
    # a floor on a pixel edge moves a splat: the winners' intensities differ there
    gv, wv = _np(got[1]), _np(want[1])
    assert (gv != wv).mean() <= MASK_SHARE
    same = gv & wv & (np.abs(_np(got[0]) - _np(want[0])) <= VALUE_ATOL)
    assert same.sum() >= 0.99 * (gv & wv).sum()
    both = gv & _np(tgt.valid)
    assert both.mean() > 0.4
    err = np.abs(_np(got[0]) - _np(tgt.intensity))[both]
    assert np.median(err) < 6.0 and np.percentile(err, 25) < 3.0


# --- tests/test_occlusion.py's warp cases -----------------------------------


def _oracle_depth_buffer(intensity, depth, valid, x, y, z):
    """tests/test_occlusion.py's NumPy Interpolation::bilinearWithDepthBuffer."""
    h, w = intensity.shape
    x0, y0 = int(np.floor(x)), int(np.floor(y))
    x1, y1 = x0 + 1, y0 + 1
    if x1 >= w or y1 >= h or x0 < 0 or y0 < 0:
        return np.nan
    x1w, y1w = x - x0, y - y0
    val = total = 0.0
    for yi, xi, wgt in ((y0, x0, (1 - x1w) * (1 - y1w)), (y0, x1, x1w * (1 - y1w)),
                        (y1, x0, (1 - x1w) * y1w), (y1, x1, x1w * y1w)):
        if valid[yi, xi] and depth[yi, xi] > z - 0.05:
            val += wgt * intensity[yi, xi]
            total += wgt
    return val / total if total > 0 else np.nan


def test_depth_buffered_interp_matches_oracle():
    rng = np.random.default_rng(0)
    h, w = 24, 32
    intensity = rng.uniform(0, 255, (h, w)).astype(np.float32)
    depth = np.full((h, w), 2.0, np.float32)
    depth[8:16, 10:20] = 1.0
    valid = rng.random((h, w)) > 0.1
    n = 300
    u = rng.uniform(-1.0, w + 1.0, n).astype(np.float32)
    v = rng.uniform(-1.0, h + 1.0, n).astype(np.float32)
    z = rng.uniform(0.8, 2.2, n).astype(np.float32)
    values, ok = interp.bilinear_with_depth_buffer(_t(intensity), _t(depth), _t(valid),
                                                   _t(u), _t(v), _t(z))
    want = j_interp.bilinear_with_depth_buffer(*(jnp.asarray(a) for a in
                                                 (intensity, depth, valid, u, v, z)))
    np.testing.assert_array_equal(_np(values), _np(want[0]))
    np.testing.assert_array_equal(_np(ok), _np(want[1]))
    values, ok = _np(values), _np(ok)
    for i in range(n):
        expect = _oracle_depth_buffer(intensity, depth, valid, u[i], v[i], z[i])
        assert ok[i] == (not np.isnan(expect)), i
        if ok[i]:
            np.testing.assert_allclose(values[i], expect, rtol=1e-5, atol=1e-4)


def test_depth_buffer_rejects_foreground_blend():
    intensity = np.zeros((8, 8), np.float32)
    depth = np.full((8, 8), 2.0, np.float32)
    intensity[:, 4:] = 200.0
    depth[:, 4:] = 1.0
    valid = np.ones((8, 8), bool)
    u, v = torch.tensor([3.5]), torch.tensor([3.0])
    val, ok = interp.bilinear_with_depth_buffer(_t(intensity), _t(depth), _t(valid), u, v,
                                                torch.tensor([2.0]))
    assert bool(ok[0]) and float(val[0]) == 0.0
    val, ok = interp.bilinear_with_depth_buffer(_t(intensity), _t(depth), _t(valid), u, v,
                                                torch.tensor([1.0]))
    assert bool(ok[0]) and float(val[0]) == 100.0


def _oracle_forward_advanced(depth, valid, k, T):
    """tests/test_occlusion.py's NumPy warpDepthForwardAdvanced."""
    h, w = depth.shape
    R, t = T[:3, :3], T[:3, 3]
    fx, fy, ox, oy = k.fx, k.fy, k.ox, k.oy
    z_factor1 = R[0, 0] + R[0, 1] * (fx / fy)
    x_factor1 = -R[2, 0] - R[2, 1] * (fx / fy)
    z_factor2 = R[1, 1] + R[1, 0] * (fy / fx)
    y_factor2 = -R[2, 1] - R[2, 0] * (fy / fx)
    out = np.full((h, w), np.inf, np.float64)
    for y in range(h):
        for x in range(w):
            if not valid[y, x]:
                continue
            z = float(depth[y, x])
            p = np.array([(x - ox) * z / fx, (y - oy) * z / fy, z])
            x_len = int(np.ceil(z_factor1 + x_factor1 * p[0] / p[2])) + 1
            y_len = int(np.ceil(z_factor2 + y_factor2 * p[1] / p[2])) + 1
            pt = R @ p + t
            xp = int(np.floor(pt[0] * fx / pt[2] + ox))
            yp = int(np.floor(pt[1] * fy / pt[2] + oy))
            for yy in range(max(yp, 0), min(yp + y_len, h)):
                for xx in range(max(xp, 0), min(xp + x_len, w)):
                    out[yy, xx] = min(out[yy, xx], pt[2])
    ok = np.isfinite(out)
    return np.where(ok, out, 0.0), ok


def test_forward_depth_warp_advanced_matches_oracle():
    _, d, v = j_syn.render_frame(np.eye(4), JK, SHAPE, scene=j_syn.occluded_scene())
    T = _T([0.03, -0.01, 0.02, 0.02, -0.015, 0.01])
    got = warp.warp_depth_forward_advanced(_t(d), _t(v), K, _t(T.astype(np.float32)))
    with jax.disable_jit():
        want = j_warp.warp_depth_forward_advanced(jnp.asarray(d), jnp.asarray(v), JK,
                                                  jnp.asarray(T, jnp.float32))
    _assert_images_close(got, want, DEPTH_ATOL)
    want_d, want_v = _oracle_forward_advanced(np.asarray(d, np.float64), v, K, T)
    got_d, got_v = _np(got[0]), _np(got[1])
    assert (got_v == want_v).mean() > 0.999
    both = got_v & want_v
    np.testing.assert_allclose(got_d[both], want_d[both], rtol=1e-4, atol=1e-4)


def test_depth_buffered_warp_cleaner_at_occlusion():
    scene = j_syn.occluded_scene()
    T = _T([0.05, 0.0, 0.0, 0.0, 0.03, 0.0])
    (j_ref, ref), (j_cur, cur) = (_levels(np.eye(4), scene, gate=False),
                                  _levels(T, scene, gate=False))
    jT, tT = _warp_T(T)
    out = {}
    for buffered in (True, False):
        got = warp.warp_intensity_inverse(ref.depth, ref.valid, cur, K, tT,
                                          use_depth_buffer=buffered)
        with jax.disable_jit():
            want = j_warp.warp_intensity_inverse(j_ref.depth, j_ref.valid, j_cur, JK, jT,
                                                 use_depth_buffer=buffered)
        _assert_images_close(got, want, VALUE_ATOL)
        out[buffered] = (_np(got[0]), _np(got[1]))
    both = out[True][1] & out[False][1]
    ref_i = _np(ref.intensity)
    err_db = np.abs(out[True][0] - ref_i)[both]
    err_pl = np.abs(out[False][0] - ref_i)[both]
    assert err_db.mean() < err_pl.mean()
    assert np.percentile(err_db, 99) < np.percentile(err_pl, 99)


def test_slam_ate_on_occluded_scene():
    """tests/test_occlusion.py::test_slam_ate_on_occluded_scene (slow there)
    at 30x40 (pyramid levels 1->0 for 2->0) and 24 frames for 40 on the
    same loop: streaming SLAM on the occluded scene stays within its 2 cm
    gate."""
    scene = synthetic.occluded_scene()
    k, shape = Intrinsics(40.0, 40.0, 19.5, 14.5), (30, 40)
    cfg = SlamConfig(
        tracker=TrackerConfig(first_level=1, last_level=0, max_iterations_per_level=30,
                              precision=1e-4, use_initial_estimate=True),
        keyframe=KeyframeConfig(max_translational_distance=0.08),
    )
    num_frames = 24
    poses = synthetic.circular_trajectory(num_frames, radius=0.15, rot_amplitude=0.12,
                                          z_amplitude=0.05)
    iu8 = np.zeros((num_frames,) + shape, np.uint8)
    du16 = np.zeros((num_frames,) + shape, np.uint16)
    for i in range(num_frames):
        intensity, depth, valid = synthetic.render_frame(
            poses[i], k, shape, scene=scene, seed=100 + i, depth_noise=0.002, intensity_noise=1.0)
        iu8[i] = np.clip(intensity, 0, 255).astype(np.uint8)
        du16[i] = np.where(valid, depth * 5000.0, 0).astype(np.uint16)
    stamps = np.arange(num_frames) / 30.0
    slam = StreamingSLAM(k, cfg, device="cpu")
    online = slam.track_sequence(iu8, du16, stamps)
    assert np.isfinite(online).all()
    g_stamps, traj = slam.graph.trajectory()
    assert len(traj) >= 2
    ate = trajectory.ate_rmse(g_stamps, traj, stamps, poses)
    assert ate < 0.02, f"occluded-scene SLAM ATE {ate}"
    assert "constraint_insert" in slam.graph.timers.summary()
    slam.graph.shutdown()


# --- the viewers ------------------------------------------------------------

VK = Intrinsics(40.0, 40.0, 19.5, 14.5)  # tests/test_warp_viz.py's viewer cases
VSHAPE = (30, 40)
VIEW_TRACKER = dict(first_level=1, last_level=0, max_iterations_per_level=15, precision=1e-4,
                    use_initial_estimate=True)
VIEW_GRAPH = dict(new_constraint_search_radius=5.0, new_constraint_min_entropy_ratio_coarse=0.03,
                  new_constraint_min_entropy_ratio_fine=0.3,
                  min_equation_system_constraint_ratio=0.1, optimization_iterations=10,
                  final_optimization_iterations=20)
MAP_FRAMES = 2


def _payload(path):
    html = open(path).read()
    assert "<canvas" in html and "showEdge" in html
    return json.loads(re.search(r"const D = (.*?);\n", html).group(1))


def _exp(xi):
    return np.asarray(j_se3.exp_se3(np.asarray(xi, np.float32)), np.float64)


@pytest.fixture(scope="module")
def viewer_graphs():
    """The same hand-built local maps (four maps of two frames on a noisy
    loop, ``test_torch_keyframe_graph.py``'s construction) into both
    packages' ``KeyframeGraph``, synchronously, then the final pass."""
    poses = synthetic.circular_trajectory(4 * MAP_FRAMES + 1, radius=0.05, rot_amplitude=0.02)
    j_frames = []
    for i, pose in enumerate(poses):
        i_, d_, v_ = synthetic.render_frame(pose, VK, VSHAPE, seed=i, depth_noise=0.002,
                                            intensity_noise=1.0)
        j_frames.append(JFrame.from_arrays(i_, d_, v_, i / 30.0, 2))
    t_frames = [convert.frame_from_reference(f, device="cpu") for f in j_frames]
    tcfg, gcfg = JTrackerConfig(**VIEW_TRACKER), JGraphConfig(**VIEW_GRAPH)
    graphs = []
    for package, frames in (("reference", j_frames), ("port", t_frames)):
        if package == "reference":
            kg = JKeyframeGraph(JIntrinsics(*VK), gcfg, tcfg, use_threading=False)
            local_map, evaluation = JLocalMap, _ReplayEvaluation
        else:
            kg = KeyframeGraph(VK, convert.config_from_reference(gcfg),
                               convert.config_from_reference(tcfg), use_threading=False)
            local_map = LocalMap
            evaluation = lambda v: RestoredEvaluation(  # noqa: E731
                {"kind": "loglik", "first": v, "average": v, "n": 1.0})
        rng = np.random.default_rng(0)
        info = np.diag([4e4] * 3 + [1e5] * 3)
        for m in range(4):
            kf = MAP_FRAMES * m
            lm = local_map.create(frames[kf], poses[kf])
            for i in range(kf + 1, kf + MAP_FRAMES + 1):
                lm.add_frame(frames[i])
                noise = lambda: _exp(rng.normal(0, 1e-3, 6))  # noqa: E731
                if i > kf + 1:
                    lm.add_odometry_measurement(np.linalg.inv(poses[i - 1]) @ poses[i] @ noise(),
                                                info)
                lm.add_keyframe_measurement(np.linalg.inv(poses[kf]) @ poses[i] @ noise(), info)
            lm.evaluation = evaluation(100.0 + 10.0 * m)
            kg.add(lm)
        kg.final_optimization()
        graphs.append(kg)
    return graphs


def test_interactive_viewer_matches_reference(viewer_graphs, tmp_path):
    """tests/test_warp_viz.py::test_interactive_graph_export (slow there)
    on the port's graph: one self-contained HTML file whose payload has the
    reference's keys and counts for the same maps (keyframes, edges and
    their fields, trajectory, clouds, error grids), written atomically."""
    ref_kg, kg = viewer_graphs
    out = str(tmp_path / "graph.html")
    assert interactive_viz.export_interactive_graph(out, kg, intrinsics=VK, cloud_level=1) == out
    assert not os.path.exists(out + ".tmp")
    j_iviz.export_interactive_graph(str(tmp_path / "ref.html"), ref_kg,
                                    intrinsics=JIntrinsics(*VK), cloud_level=1)
    payload, ref = _payload(out), _payload(str(tmp_path / "ref.html"))
    assert set(payload) == set(ref)
    assert len(payload["keyframes"]) == len(ref["keyframes"]) == len(kg.keyframes)
    assert [k["id"] for k in payload["keyframes"]] == [k["id"] for k in ref["keyframes"]]
    assert len(payload["trajectory"]) == len(ref["trajectory"]) >= len(payload["keyframes"])
    assert [(e["i"], e["j"], e["robust"], e["active"]) for e in payload["edges"]] == [
        (e["i"], e["j"], e["robust"], e["active"]) for e in ref["edges"]]
    assert set(payload["edges"][0]) == set(ref["edges"][0])
    assert [c["id"] for c in payload["clouds"]] == [c["id"] for c in ref["clouds"]]
    assert payload["clouds"] and all(len(c["pts"]) == 3 * len(c["gray"]) > 0
                                     for c in payload["clouds"])
    assert sorted(payload["errimgs"]) == sorted(ref["errimgs"])
    assert payload["errimgs"], "the loop edges carry error grids"
    for key, grid in payload["errimgs"].items():
        assert (grid["h"], grid["w"]) == (ref["errimgs"][key]["h"], ref["errimgs"][key]["w"])
        assert len(grid["data"]) == grid["h"] * grid["w"]


def test_live_viewer_reexports_on_map_change(viewer_graphs, tmp_path):
    _, kg = viewer_graphs
    live = str(tmp_path / "live.html")
    cb = interactive_viz.attach_live_viewer(kg, live, intrinsics=VK, refresh_seconds=1.5,
                                            cloud_level=1, error_images=False)
    assert callable(cb) and not os.path.exists(live)
    kg._fire_map_changed()
    html = open(live).read()
    assert 'http-equiv="refresh" content="1.5"' in html and "const D = " in html
    os.remove(live)
    kg._fire_map_changed()
    assert os.path.exists(live)
    kg.map_changed_callbacks.remove(cb)


def test_edge_error_image_export(viewer_graphs, tmp_path):
    """tests/test_warp_viz.py::test_edge_error_image_export (slow there) on
    the port's graph: the worst loop closures' heatmaps, the reference's
    file names for the same maps."""
    ref_kg, kg = viewer_graphs
    written = visualization.export_edge_error_images(str(tmp_path / "port"), kg, VK, worst_k=3)
    ref = j_viz.export_edge_error_images(str(tmp_path / "ref"), ref_kg, JIntrinsics(*VK),
                                         worst_k=3)
    assert written and len(written) == len(ref)
    assert [os.path.basename(p).split("_chi2")[0] for p in written] == [
        os.path.basename(p).split("_chi2")[0] for p in ref]
    for p in written:
        assert os.path.getsize(p) > 1000


def test_keyframe_tracker_viewer_export(tmp_path):
    """The port's ``KeyframeTracker`` on the viewer case's 10 frames (the
    tracking form of the reference's slow export tests), then the viewer
    and the edge error images of its graph."""
    cfg = SlamConfig(
        tracker=TrackerConfig(**VIEW_TRACKER),
        keyframe=KeyframeConfig(max_translational_distance=0.04, min_entropy_ratio=0.5,
                                min_equation_system_constraint_ratio=0.1),
        graph=GraphConfig(**VIEW_GRAPH),
    )
    poses = synthetic.circular_trajectory(10, radius=0.05, rot_amplitude=0.02)
    kt = KeyframeTracker(VK, cfg, device="cpu", use_threading=False)
    kt.init()
    for i, pose in enumerate(poses):
        intensity, depth, valid = synthetic.render_frame(pose, VK, VSHAPE, seed=i)
        kt.update(Frame.from_arrays(intensity, depth, valid, i / 30.0, cfg.tracker.num_levels,
                                    device="cpu"))
    kt.force_keyframe()
    kt.finish()
    out = str(tmp_path / "graph.html")
    interactive_viz.export_interactive_graph(out, kt.graph, intrinsics=VK, cloud_level=1)
    payload = _payload(out)
    assert len(payload["keyframes"]) == len(kt.graph.keyframes) >= 2
    assert payload["edges"] and payload["clouds"]
    written = visualization.export_edge_error_images(str(tmp_path), kt.graph, VK, worst_k=3)
    assert all(os.path.getsize(p) > 1000 for p in written)
    kt.graph.shutdown()
