"""The port never imports JAX: with ``sys.modules["jax"]`` set to None (so
that importing it raises), every module of ``dvo_slam_tpu_torch`` and
``chip_smoke.py`` import and a tiny CPU ``match_pyramids`` runs.  Of the
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
