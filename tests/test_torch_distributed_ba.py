"""The port's distributed bundle adjustment (``parallel/distributed_ba``) on
the CPU.

The graphs are the reference tests' (``tests/test_parallel.py``): the
12-vertex noisy chain with an exact robust loop edge (edge capacity 16) for
Gauss-Newton and CG, and the 48-vertex ring with a loop every 8 vertices
(capacity 64) for the Schur route.  Each is built by the reference and
copied into the port with ``convert.pose_graph_from_reference``.

The port's ranks run in child processes, 2 and 4 gloo ranks on a
``file://`` rendezvous in a temporary directory (no process group in the
test worker; ``jax`` blocked in the children), each joined with its own
timeout.  Each solver is held:

- against the port's single-device solver of the same route
  (``pose_graph.optimize``, float64): the two differ only in the order the
  ranks' partial sums are added, so the history within rtol 1e-12 and the
  poses within 1e-12, far tighter than the reference's own (measured:
  history 1.7e-16 relative, poses equal);
- against the reference's distributed function on its 8-device CPU mesh
  (float32): the reference tests' tolerances, history rtol 1e-3 / atol
  1e-3 and poses 1e-4 (GN, CG), history rtol 1e-4 / atol 1e-5 and poses
  1e-5 (Schur), and the dense oracle within 1e-3 (measured: history 3.6e-6,
  4.5e-6 and 3.0e-5 relative, poses 1.1e-7, 1.1e-7 and 6.1e-7);
- every rank returns the same bits.

An edge capacity that the world size does not divide raises (the
reference's ``test_distributed_ba_rejects_bad_shard_count``).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvo_slam_tpu.models import pose_graph as j_pg
from dvo_slam_tpu.ops import se3 as j_se3
from dvo_slam_tpu.parallel import distributed_ba as j_dba
from dvo_slam_tpu.parallel import mesh as j_mesh

from dvo_slam_tpu_torch import convert
from dvo_slam_tpu_torch.models import pose_graph as t_pg
from dvo_slam_tpu_torch.parallel import distributed_ba as t_dba
from dvo_slam_tpu_torch.parallel.mesh import BATCH_AXIS, Mesh

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 120
WORLDS = (2, 4)
GN_ITERATIONS = 10
CG_ITERATIONS, CG_INNER = 8, 128  # tests/test_parallel.py::test_distributed_cg_matches_single_device
SCHUR_ITERATIONS = 10
SINGLE_RTOL = 1e-12
SINGLE_ATOL = 1e-12
# the reference tests' tolerances: (history rtol, history atol, poses atol)
REF_TOL = {"gn": (1e-3, 1e-3, 1e-4), "cg": (1e-3, 1e-3, 1e-4), "schur": (1e-4, 1e-5, 1e-5)}
DENSE_ORACLE_ATOL = 1e-3

# One rank of the port.  argv: work directory, world size, rank.
_CHILD = r"""
import sys
sys.modules["jax"] = None  # the port's multi-rank path needs no JAX
import numpy as np
import torch
torch.set_num_threads(1)
from dvo_slam_tpu_torch.models import pose_graph as pg
from dvo_slam_tpu_torch.parallel import distributed, distributed_ba as dba, mesh as mesh_lib

work, world, rank = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
data = np.load(f"{work}/graphs.npz")
distributed.initialize(init_method=f"file://{work}/store{world}", world_size=world,
                       rank=rank, backend="gloo", device="cpu")
mesh = mesh_lib.make_mesh(world, device="cpu")

def graph(name):
    return pg.GraphArrays(*(torch.from_numpy(data[f"{name}/{f}"]) for f in pg.GraphArrays._fields))

struct = pg.ChainStructure(*(data[f"struct/{f}"] for f in pg.ChainStructure._fields))
runs = {
    "gn": dba.distributed_gauss_newton(graph("chain"), mesh, iterations=int(data["gn_iterations"])),
    "cg": dba.distributed_gauss_newton_cg(graph("chain"), mesh, iterations=int(data["cg_iterations"]),
                                          cg_iterations=int(data["cg_inner"])),
    "schur": dba.distributed_gauss_newton_schur(graph("ring"), struct, mesh,
                                                iterations=int(data["schur_iterations"])),
}
out = {}
for name, (g, history) in runs.items():
    assert g.poses.dtype == torch.float64 and history.dtype == torch.float64
    out[name + "/poses"] = g.poses.numpy()
    out[name + "/history"] = history.numpy()
np.savez(f"{work}/out_w{world}_r{rank}.npz", **out)
distributed.shutdown()
"""


def _exp(xi):
    return np.asarray(j_se3.exp_se3(jnp.asarray(np.asarray(xi, np.float32))))


def _chain_graph(n=12, seed=0):
    """tests/test_parallel.py::_chain_graph: a noisy odometry chain and an
    exact robust loop edge."""
    rng = np.random.default_rng(seed)
    true = [np.eye(4)]
    for _ in range(n):
        true.append(true[-1] @ _exp([0.3, 0.0, 0.0, 0.0, 0.0, 2 * np.pi / n]))
    g = j_pg.PoseGraph(vertex_capacity=16, edge_capacity=16)
    pose = np.eye(4)
    g.add_vertex(0, pose, fixed=True)
    for i in range(n):
        meas = np.linalg.inv(true[i]) @ true[i + 1] @ _exp(rng.normal(0, 0.01, 6))
        pose = pose @ meas
        g.add_vertex(i + 1, pose)
        g.add_edge(i, i + 1, meas, np.eye(6))
    g.add_edge(0, n, np.linalg.inv(true[0]) @ true[n], 100 * np.eye(6), robust=True)
    return g, np.asarray(true)


def _ring_graph(n=48, loop_every=8):
    """tests/test_parallel.py::test_distributed_schur_matches_single_device's graph."""
    rng = np.random.default_rng(7)
    true = [np.eye(4)]
    for _ in range(n):
        true.append(true[-1] @ _exp([0.3, 0.0, 0.0, 0.0, 0.0, 2 * np.pi / n]))
    g = j_pg.PoseGraph(vertex_capacity=64, edge_capacity=64)
    g.add_vertex(0, np.eye(4), fixed=True)
    pose = np.eye(4)
    for i in range(n):
        meas = np.linalg.inv(true[i]) @ true[i + 1] @ _exp(rng.normal(0, 0.01, 6))
        pose = pose @ meas
        g.add_vertex(i + 1, pose)
        g.add_edge(i, i + 1, meas, np.eye(6))
    for i in range(0, n - loop_every, loop_every):
        g.add_edge(i, i + loop_every, np.linalg.inv(true[i]) @ true[i + loop_every],
                   50.0 * np.eye(6), robust=True)
    return g


def _f64(arrays):
    return t_pg.GraphArrays(*(x.to(torch.float64) if x.is_floating_point() else x for x in arrays))


class _Runs:
    """The reference's distributed solves, the port's single solves and the
    port's ranks (started at construction, joined on first use)."""

    def __init__(self, work):
        self.work = work
        chain, self.true = _chain_graph()
        ring = _ring_graph()
        mesh = j_mesh.make_mesh(8)
        chain_arrays, ring_arrays = chain.to_arrays(), ring.to_arrays()
        ref_struct = ring._chain_structure(max_level=0)
        assert ref_struct is not None and ref_struct.seg_len.shape[0] > 1
        self.ref = {
            "gn": j_dba.distributed_gauss_newton(chain_arrays, mesh, iterations=GN_ITERATIONS),
            "cg": j_dba.distributed_gauss_newton_cg(chain_arrays, mesh, iterations=CG_ITERATIONS,
                                                    cg_iterations=CG_INNER),
            "schur": j_dba.distributed_gauss_newton_schur(ring_arrays, ref_struct, mesh,
                                                          iterations=SCHUR_ITERATIONS),
        }
        self.ref = {k: (np.asarray(g.poses), np.asarray(h)) for k, (g, h) in self.ref.items()}
        self.ref_dense = np.asarray(
            j_pg.optimize(ring_arrays, iterations=SCHUR_ITERATIONS, solver="dense")[0].poses)

        port_chain = _f64(convert.pose_graph_from_reference(chain).to_arrays())
        port_ring_graph = convert.pose_graph_from_reference(ring)
        port_ring = _f64(port_ring_graph.to_arrays())
        self.struct = port_ring_graph._chain_structure(max_level=0)
        self.chain, self.ring = port_chain, port_ring
        self.single = {
            "gn": t_pg.optimize(port_chain, GN_ITERATIONS, solver="dense"),
            "cg": t_pg.optimize(port_chain, CG_ITERATIONS, solver="cg", cg_iterations=CG_INNER),
            "schur": t_pg.optimize(port_ring, SCHUR_ITERATIONS, solver="schur", struct=self.struct),
        }
        self.single = {k: (g.poses.numpy(), h.numpy()) for k, (g, h) in self.single.items()}

        arrays = {"gn_iterations": GN_ITERATIONS, "cg_iterations": CG_ITERATIONS,
                  "cg_inner": CG_INNER, "schur_iterations": SCHUR_ITERATIONS}
        for name, g in (("chain", port_chain), ("ring", port_ring)):
            for field, value in zip(t_pg.GraphArrays._fields, g):
                arrays[f"{name}/{field}"] = value.numpy()
        for field, value in zip(t_pg.ChainStructure._fields, self.struct):
            arrays[f"struct/{field}"] = np.asarray(value)
        np.savez(work / "graphs.npz", **arrays)
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        self.procs = {
            world: [subprocess.Popen([sys.executable, "-c", _CHILD, str(work), str(world), str(r)],
                                     cwd=REPO, env=env, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
                    for r in range(world)]
            for world in WORLDS
        }
        self.joined = set()

    def out(self, world, rank=0):
        if world not in self.joined:
            procs = self.procs[world]
            for proc in procs:
                try:
                    log, _ = proc.communicate(timeout=CHILD_TIMEOUT_S)
                except subprocess.TimeoutExpired:
                    self.kill()
                    pytest.fail(f"a rank did not finish within {CHILD_TIMEOUT_S} s")
                assert proc.returncode == 0, log
            self.joined.add(world)
        return np.load(self.work / f"out_w{world}_r{rank}.npz")

    def kill(self):
        for procs in self.procs.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    r = _Runs(tmp_path_factory.mktemp("dba"))
    yield r
    r.kill()


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("solver", ["gn", "cg", "schur"])
def test_matches_port_single_solver(runs, solver, world):
    out = runs.out(world)
    poses, history = runs.single[solver]
    np.testing.assert_allclose(out[solver + "/history"], history, rtol=SINGLE_RTOL, atol=0)
    np.testing.assert_allclose(out[solver + "/poses"], poses, atol=SINGLE_ATOL, rtol=0)
    for rank in range(1, world):
        other = runs.out(world, rank)
        for key in ("poses", "history"):
            np.testing.assert_array_equal(other[f"{solver}/{key}"], out[f"{solver}/{key}"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("solver", ["gn", "cg", "schur"])
def test_matches_reference_distributed(runs, solver, world):
    out = runs.out(world)
    ref_poses, ref_history = runs.ref[solver]
    rtol, atol, pose_atol = REF_TOL[solver]
    np.testing.assert_allclose(out[solver + "/history"], ref_history, rtol=rtol, atol=atol)
    np.testing.assert_allclose(out[solver + "/poses"], ref_poses, atol=pose_atol)
    if solver == "schur":
        np.testing.assert_allclose(out[solver + "/poses"], runs.ref_dense, atol=DENSE_ORACLE_ATOL)
    else:
        # and it solved the problem (the reference tests' gate)
        n = 12
        assert np.linalg.norm(out[solver + "/poses"][n][:3, 3] - runs.true[n][:3, 3]) < 0.01


def test_one_rank_in_process_equals_single(runs):
    """A one-rank mesh (no collective needed to check the arithmetic):
    with a single rank the all-reduce is the identity, so a stand-in
    reduce gives the port's distributed dense and Schur steps exactly the
    single solvers' numbers."""
    mesh = Mesh(None, BATCH_AXIS, 0, 1, torch.device("cpu"))
    orig = t_dba._all_reduce
    t_dba._all_reduce = lambda m: (lambda x: x)
    try:
        g, h = t_dba.distributed_gauss_newton(runs.chain, mesh, iterations=GN_ITERATIONS)
        gs, hs = t_dba.distributed_gauss_newton_schur(runs.ring, runs.struct, mesh,
                                                      iterations=SCHUR_ITERATIONS)
    finally:
        t_dba._all_reduce = orig
    np.testing.assert_array_equal(h.numpy(), runs.single["gn"][1])
    np.testing.assert_array_equal(g.poses.numpy(), runs.single["gn"][0])
    np.testing.assert_array_equal(hs.numpy(), runs.single["schur"][1])
    np.testing.assert_array_equal(gs.poses.numpy(), runs.single["schur"][0])


@pytest.mark.parametrize("fn", ["gn", "cg"])
def test_bad_shard_count_raises(runs, fn):
    """tests/test_parallel.py::test_distributed_ba_rejects_bad_shard_count:
    16 edge slots do not divide over 3 ranks (the check comes before any
    collective, so a stand-in mesh of 3 is enough)."""
    mesh = Mesh(None, BATCH_AXIS, 0, 3, torch.device("cpu"))
    solve = {"gn": t_dba.distributed_gauss_newton, "cg": t_dba.distributed_gauss_newton_cg}[fn]
    with pytest.raises(ValueError, match="not divisible by mesh size 3"):
        solve(runs.chain, mesh, iterations=1)
    with pytest.raises(ValueError, match="mesh axis"):
        solve(runs.chain, mesh, iterations=1, axis="pixels")


def test_pad_chain_structure(runs):
    """Zero-length segments pad the segment axis to a multiple of the world
    size; the padded structure solves to the same numbers."""
    g = runs.struct.seg_len.shape[0]
    padded = t_dba.pad_chain_structure(runs.struct, 5)
    assert padded.seg_len.shape[0] % 5 == 0 and padded.seg_len.shape[0] - g < 5
    assert (padded.seg_len[g:] == 0).all() and padded.seg_edges.shape[1:] == runs.struct.seg_edges.shape[1:]
    assert t_dba.pad_chain_structure(runs.struct, 1) is runs.struct
    _, h = t_pg.optimize(runs.ring, 2, solver="schur", struct=padded)
    _, h_ref = t_pg.optimize(runs.ring, 2, solver="schur", struct=runs.struct)
    np.testing.assert_array_equal(h.numpy(), h_ref.numpy())
