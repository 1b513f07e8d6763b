"""The port never imports JAX: with ``sys.modules["jax"]`` set to None (so
that importing it raises), every module of ``dvo_slam_tpu_torch`` (the
``parallel`` modules and the tools included) and ``chip_smoke.py`` import,
and a tiny CPU ``match_pyramids``, a one-rank gloo pixel-sharded match,
both multi-stream schedules, the temporal tracker and the gather probe's
check run.  Of the
JAX package the port loads only its plain modules, ``dvo_slam_tpu.config``
and ``dvo_slam_tpu.utils.trajectory``."""

import os
import subprocess
import sys

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
import numpy as np
import torch
torch.set_num_threads(1)
import dvo_slam_tpu_torch
names = [m.name for m in pkgutil.walk_packages(dvo_slam_tpu_torch.__path__, "dvo_slam_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # the card's smoke run imports no JAX either
parallel = {"dvo_slam_tpu_torch.parallel." + m
            for m in ("mesh", "distributed", "sharded_alignment", "multistream", "temporal")}
tools = {"dvo_slam_tpu_torch.tools." + m for m in ("gather_probe", "multistream_bench")}
ops = {"dvo_slam_tpu_torch.ops.table_copy"}
assert parallel | tools | ops <= set(names), sorted((parallel | tools | ops) - set(names))

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

import tempfile
from dvo_slam_tpu_torch.parallel import distributed, mesh, sharded_alignment
with tempfile.TemporaryDirectory() as store:
    distributed.initialize(init_method=f"file://{store}/store", world_size=1, rank=0,
                           backend="gloo")
    run = sharded_alignment.make_pixel_sharded_matcher(cfg, K, mesh.make_mesh(1))
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
    tracks = multistream.make_multistream_tracker(cfg, K, schedule=schedule).tracks(iu, du)
    assert tracks.poses.shape == (2, 2, 4, 4) and torch.isfinite(tracks.poses).all()
chain = temporal.make_temporal_tracker(cfg, K, num_chunks=2)(iu[0], du[0])
assert chain.shape == (2, 4, 4) and np.isfinite(chain).all()
gather_probe.check_variants(gather_probe.make_inputs(2, 6, 8))
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")
                and sys.modules[m] is not None)
assert not leaked, leaked
reference = sorted(m for m in sys.modules if m.split(".")[0] == "dvo_slam_tpu")
assert reference == ["dvo_slam_tpu", "dvo_slam_tpu.config", "dvo_slam_tpu.utils",
                     "dvo_slam_tpu.utils.trajectory"], reference
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
