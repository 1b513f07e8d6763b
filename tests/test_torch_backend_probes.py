"""The port's back-end probes against the reference's, at a cut size on
the CPU (``dvo_slam_tpu_torch/tools/{backend_scale_probe,
final_pass_profile,cg_iteration_stats}.py`` against ``tools/`` of the
same names, each reference run through its own ``main``).

- ``backend_scale_probe`` at 8 keyframes x 7 frames (60x80): keyframes,
  vertices, edges before and after the final pass equal; every pose-graph
  solve's route (each package's ``PoseGraph._solve_compact`` records the
  route it is handed, local maps' solves included) the same sequence; the
  optimized ATE within 1e-4 m of the reference's (which prints it rounded
  to 1e-5 m; the run's ATE is about 51 mm, dominated by the drift the
  probe injects).
- ``final_pass_profile``: the graph's vertices and edges, every round's
  edges removed and route equal.
- ``cg_iteration_stats`` on a 64-vertex ring, 3 GN steps: vertices, loop
  edges, Schur separators and the policy's route equal, each step's CG
  iterations within 2 of the reference's (the stopping test reads a
  reduction whose order differs), the chi2 before each step within rtol
  1e-5 and atol 1e-6 of the reference's (printed to 6 decimals).
"""

import importlib.util
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from dvo_slam_tpu.models import pose_graph as j_pose_graph

from dvo_slam_tpu_torch.models import pose_graph
from dvo_slam_tpu_torch.tools import backend_scale_probe, cg_iteration_stats, final_pass_profile

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATE_ATOL_M = 1e-4
CG_ITERATIONS_ATOL = 2
CHI2_RTOL = 1e-5
CHI2_ATOL = 1e-6  # the reference prints chi2 to 6 decimals


def _reference_tool(name):
    spec = importlib.util.spec_from_file_location(f"reference_{name}",
                                                  os.path.join(REPO, "tools", name + ".py"))
    module = importlib.util.module_from_spec(spec)
    path = list(sys.path)
    try:
        spec.loader.exec_module(module)
    finally:
        sys.path[:] = path  # the reference tools edit sys.path when imported
    return module


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


@pytest.fixture
def routes(monkeypatch):
    """The route every solve of either package takes, in order."""
    seen = {"port": [], "reference": []}
    for key, cls in (("port", pose_graph.PoseGraph), ("reference", j_pose_graph.PoseGraph)):
        solve = cls._solve_compact

        def recorded(self, sub, chain, iterations, delta, solver, *args, _solve=solve,
                     _seen=seen[key]):
            _seen.append(solver)
            return _solve(self, sub, chain, iterations, delta, solver, *args)

        monkeypatch.setattr(cls, "_solve_compact", recorded)
    return seen


def test_backend_scale_probe_matches_reference(routes, capsys):
    first, second = backend_scale_probe.main(8, 7, device="cpu")
    capsys.readouterr()
    _reference_tool("backend_scale_probe").main(8, 7)
    ref_first, ref_second = _json_lines(capsys.readouterr().out)
    for key in ("keyframes", "vertices", "edges_before_final"):
        assert first[key] == ref_first[key], key
    assert second["edges_after_final"] == ref_second["edges_after_final"]
    assert abs(second["ate_m"] - ref_second["ate_m"]) < ATE_ATOL_M
    assert routes["port"] == routes["reference"] and routes["port"]
    assert sum(second["routes"].values()) > 0 and not second["fallbacks"]
    assert first["device"] == "cpu" and first["peak_device_bytes"] is None
    assert set(ref_second) <= set(second) and set(ref_first) <= set(first)


def test_final_pass_profile_matches_reference(routes, capsys):
    size, rounds, totals = final_pass_profile.main("cpu")
    capsys.readouterr()
    _reference_tool("final_pass_profile").main()
    ref_size, ref_rounds, ref_totals = _json_lines(capsys.readouterr().out)
    assert (size["vertices"], size["edges"]) == (ref_size["vertices"], ref_size["edges"])
    assert [r["removed"] for r in rounds] == [r["removed"] for r in ref_rounds["rounds"]]
    assert totals["removed_edges"] == ref_totals["removed_edges"]
    # the warm schedule and the timed one, 10 solves each, in both packages
    assert routes["port"] == routes["reference"] and len(routes["port"]) == 20
    assert [r["route"] for r in rounds] == routes["port"][10:]


def test_cg_iteration_stats_match_reference(routes, capsys, monkeypatch):
    args = ["--sizes", "64", "--gn-steps", "3"]
    (record,) = cg_iteration_stats.main(args + ["--device", "cpu"])
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", ["cg_iteration_stats"] + args)
    x64 = jax.config.jax_enable_x64
    try:
        _reference_tool("cg_iteration_stats").main()
    finally:
        jax.config.update("jax_enable_x64", x64)  # the reference tool turns it on
    (ref,) = _json_lines(capsys.readouterr().out)
    for key in ("vertices", "odometry_edges", "loop_edges", "schur_separators", "auto_solver"):
        assert record[key] == ref[key], key
    counts, ref_counts = record["cg_iterations_per_gn_step"], ref["cg_iterations_per_gn_step"]
    assert len(counts) == len(ref_counts) == 3
    assert np.abs(np.subtract(counts, ref_counts)).max() <= CG_ITERATIONS_ATOL
    np.testing.assert_allclose(record["chi2_before_each_step"], ref["chi2_before_each_step"],
                               rtol=CHI2_RTOL, atol=CHI2_ATOL)
    assert record["allreduces_per_gn_step_distributed"] == counts
    assert routes["port"] == routes["reference"] == [record["auto_route"]]
