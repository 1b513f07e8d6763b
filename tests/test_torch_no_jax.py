"""The port never imports JAX nor the JAX package: with ``sys.modules["jax"]``
and ``sys.modules["dvo_slam_tpu"]`` set to None (so that importing either
raises), every module of ``dvo_slam_tpu_torch`` (the ``parallel`` modules
and the tools included) and ``chip_smoke.py`` import, and a tiny CPU
``match_pyramids``, a one-rank gloo pixel-sharded match, both multi-stream
schedules, the temporal tracker, the gather probe's check and the ATE
metric run, a tiny CPU ``KeyframeTracker`` (the back end included)
tracks, finishes and exports its trajectory, a tiny CPU ``StreamingSLAM``
tracks in chunks and its graph is checkpointed and exported as the
interactive viewer, the modular tracker path and the error-image warp run,
a tiny CPU
``DataParallelSLAM`` tracks two streams, and the benchmark CLI runs
odometry.  The C++ source and build of ``native`` are not taken for
modules.  Afterwards no ``jax`` and no
``dvo_slam_tpu`` module is loaded.  No source file of the port names either
package in an import, a dynamic one included."""

import ast
import os
import subprocess
import sys

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["dvo_slam_tpu"] = None
import numpy as np
import torch
torch.set_num_threads(1)
import dvo_slam_tpu_torch
names = [m.name for m in pkgutil.walk_packages(dvo_slam_tpu_torch.__path__, "dvo_slam_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # the card's smoke run imports no JAX either
parallel = {"dvo_slam_tpu_torch.parallel." + m
            for m in ("mesh", "distributed", "sharded_alignment", "multistream", "temporal",
                      "dp_slam", "distributed_ba")}
tools = {"dvo_slam_tpu_torch.tools." + m for m in ("gather_probe", "multistream_bench")}
ops = {"dvo_slam_tpu_torch.ops.table_copy", "dvo_slam_tpu_torch.ops.warp"}
viewers = {"dvo_slam_tpu_torch.utils." + m
           for m in ("histogram", "visualization", "interactive_viz")}
back_end = {"dvo_slam_tpu_torch.models." + m
            for m in ("constraints", "keyframe_graph", "keyframe_tracker", "pose_graph")}
back_end.add("dvo_slam_tpu_torch.utils.timers")
drivers = {"dvo_slam_tpu_torch.models.streaming", "dvo_slam_tpu_torch.cli.benchmark",
           "dvo_slam_tpu_torch.native", "dvo_slam_tpu_torch.bench"}
drivers |= {"dvo_slam_tpu_torch.utils." + m
            for m in ("dataset", "metrics", "serialization", "synthetic_tum", "trajectory")}
wanted = parallel | tools | ops | back_end | drivers | viewers
assert wanted <= set(names), sorted(wanted - set(names))
# the native extension's C++ source and its build are not Python modules
# (``ops.ingest`` is the card's ingest, plain Python)
assert not [n for n in names if n.startswith("dvo_slam_tpu_torch.native.")
            or "_dvo_ingest" in n or ".build" in n], names

from dvo_slam_tpu_torch.config import TrackerConfig
from dvo_slam_tpu_torch.models.dense_tracker import match_pyramids
from dvo_slam_tpu_torch.ops.camera import Intrinsics
from dvo_slam_tpu_torch.ops.pyramid import build_pyramid
from dvo_slam_tpu_torch.utils import synthetic

K = Intrinsics(32.0, 32.0, 15.5, 11.5)
cfg = TrackerConfig(first_level=1, last_level=0, max_iterations_per_level=5)
levels = []
for pose in (np.eye(4), synthetic.circular_trajectory(50)[1]):
    i, d, v = synthetic.render_frame(pose, K, (24, 32))
    levels.append(build_pyramid(torch.from_numpy(i), torch.from_numpy(d),
                                torch.from_numpy(v), cfg.num_levels))
result = match_pyramids(cfg, K, levels[0], levels[1])
assert torch.isfinite(result.transformation).all()
import dataclasses
from dvo_slam_tpu_torch.config import InfluenceFunction, ScaleEstimator
from dvo_slam_tpu_torch.ops import warp
modular = dataclasses.replace(cfg, influence_function=InfluenceFunction.HUBER,
                              scale_estimator=ScaleEstimator.MAD)
assert torch.isfinite(match_pyramids(modular, K, levels[0], levels[1]).transformation).all()
err, ok = warp.intensity_error_image(levels[0][0], levels[1][0], K, result.transformation)
assert err.shape == (24, 32) and bool(ok.any())

import tempfile
from dvo_slam_tpu_torch.parallel import distributed, mesh, sharded_alignment
with tempfile.TemporaryDirectory() as store:
    distributed.initialize(init_method=f"file://{store}/store", world_size=1, rank=0,
                           backend="gloo", device="cpu")
    run = sharded_alignment.make_pixel_sharded_matcher(cfg, K, mesh.make_mesh(1, device="cpu"))
    sharded = run(levels[0], levels[1], torch.eye(4))
    distributed.shutdown()
assert torch.isfinite(sharded.transformation).all()

from dvo_slam_tpu_torch.parallel import multistream, temporal
from dvo_slam_tpu_torch.tools import gather_probe
frames = []
for pose in synthetic.circular_trajectory(3, radius=0.02):
    i, d, v = synthetic.render_frame(pose, K, (24, 32))
    frames.append((np.clip(i, 0, 255).astype(np.uint8), np.where(v, d * 5000.0, 0).astype(np.uint16)))
iu = np.stack([np.stack([f[0] for f in frames])] * 2)
du = np.stack([np.stack([f[1] for f in frames])] * 2)
for schedule in ("lockstep", "sequential"):
    tracks = multistream.make_multistream_tracker(cfg, K, schedule=schedule,
                                                  device="cpu").tracks(iu, du)
    assert tracks.poses.shape == (2, 2, 4, 4) and torch.isfinite(tracks.poses).all()
chain = temporal.make_temporal_tracker(cfg, K, num_chunks=2, device="cpu")(iu[0], du[0])
assert chain.shape == (2, 4, 4) and np.isfinite(chain).all()
gather_probe.check_variants(gather_probe.make_inputs(2, 6, 8, device="cpu"))
from dvo_slam_tpu_torch.config import SlamConfig
from dvo_slam_tpu_torch.models.keyframe_tracker import KeyframeTracker
kt = KeyframeTracker(K, SlamConfig(tracker=cfg), use_threading=False, device="cpu")
kt.init()
for t, pose in enumerate(synthetic.circular_trajectory(4, radius=0.02)):
    i, d, v = synthetic.render_frame(pose, K, (24, 32))
    kt.update(kt.make_frame(i, d, v, t / 30.0))
kt.force_keyframe()
kt.finish()
assert kt.trajectory()[1].shape == (4, 4, 4) and kt.graph.keyframes
from dvo_slam_tpu_torch.models.streaming import StreamingSLAM
from dvo_slam_tpu_torch.utils import serialization
ss = StreamingSLAM(K, SlamConfig(tracker=cfg), device="cpu")
iu8 = np.stack([f[0] for f in frames])
du16 = np.stack([f[1] for f in frames])
online = ss.track_sequence(iu8, du16, np.arange(3) / 30.0, pipeline_chunk=2)
assert online.shape == (3, 4, 4) and np.isfinite(online).all() and ss.graph.keyframes
with tempfile.TemporaryDirectory() as out:
    serialization.save_keyframe_graph(out + "/graph.npz", ss.graph)
    assert serialization.load_pose_graph(out + "/graph.npz").num_vertices == 3
    from dvo_slam_tpu_torch.cli import benchmark
    assert benchmark.main(["--synthetic", "3", "--shape", "60x80", "--mode", "odometry",
                           "--device", "cpu", "--output-dir", out]) == 0
    from dvo_slam_tpu_torch.utils import interactive_viz
    interactive_viz.export_interactive_graph(out + "/graph.html", ss.graph, intrinsics=K,
                                             cloud_level=1)
    assert "const D = " in open(out + "/graph.html").read()
ss.graph.shutdown()
from dvo_slam_tpu_torch.parallel.dp_slam import DataParallelSLAM
dp = DataParallelSLAM(K, SlamConfig(tracker=cfg), device="cpu")
assert dp.track_sequences(iu, du, np.arange(3) / 30.0).shape == (2, 3, 4, 4)
assert len(dp.trajectories()) == 2
dp.shutdown()
from dvo_slam_tpu_torch.utils import trajectory
stamps = np.arange(3) / 30.0
assert trajectory.ate_rmse(stamps, np.tile(np.eye(4), (3, 1, 1)), stamps,
                           np.tile(np.eye(4), (3, 1, 1))) == 0.0
from dvo_slam_tpu_torch import benchmark_config, config as t_config, convert
assert convert.config_to_reference(benchmark_config(), t_config) == benchmark_config()
assert convert.config_from_reference(benchmark_config()) == benchmark_config()
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "dvo_slam_tpu")
                and sys.modules[m] is not None)
assert not leaked, leaked
print("modules", len(names), "ok")
"""


def test_port_imports_and_runs_without_jax():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=repo, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "ok" in proc.stdout


def _imported_roots(tree):
    """Top-level package names that a module imports, statically or through
    ``importlib.import_module`` / ``__import__`` with a literal name."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", None)
            if name in ("import_module", "__import__") and node.args:
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    yield arg.value.split(".")[0]
                else:
                    yield "<dynamic>"


def test_port_sources_name_no_reference_import():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    files = [os.path.join(repo, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(repo, "dvo_slam_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    bad = {}
    for path in files:
        with open(path) as f:
            roots = set(_imported_roots(ast.parse(f.read(), path)))
        hit = roots & {"jax", "jaxlib", "dvo_slam_tpu", "<dynamic>"}
        if hit:
            bad[os.path.relpath(path, repo)] = sorted(hit)
    assert len(files) > 20 and not bad, bad
