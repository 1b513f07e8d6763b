"""Block-CG (``pose_graph.solve_blocks_cg``) in chunks of K steps, on the
CPU.

The loop carries the reference's (x, r, z, p, rz, k) and its condition
``active`` on the device, and reads ``active`` once per chunk of K steps
(none before the first); a step where ``active`` is false leaves the carry
as it was.  On the card the loop is one while-graph launch, or one graph
replay per chunk in the host-polled form (``tests_cuda/test_while_cg_cuda.py``
and ``tests_cuda/test_sharded_graph_cuda.py`` hold both to the eager
loop); here the chunks run eagerly:

- at K = 2, 3, 8 and 32 the solution and k are the K = 1 run's bits, on
  the 24-vertex loopy ring of ``tests/test_torch_pose_graph_solvers.py``
  and on the LM stress graph (``tests/test_pose_graph.py``), alone and
  sharded over two gloo ranks (an edge of zero blocks evens an odd edge
  count; child processes, ``file://`` rendezvous,
  ``jax`` blocked, each joined with its own timeout), where the ranks
  agree bit for bit, take the one-process solve's k and stay within 1e-9
  of its largest entry (the ranks' partial sums are added in another
  order; on the stress graph that moves entries of x by up to 2.6e-9);
- k equals the reference's ``solve_blocks_cg(..., return_iterations=True)``
  (float64, ``jax.enable_x64``) on the LM stress graph, at its default
  tolerance with the cap reached and not, and x is within the 1e-9 of its
  largest entry that ``test_cg_iterations_and_tolerance`` states;
- a step past the stop is inert.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvo_slam_tpu.models import pose_graph as j_pg
from dvo_slam_tpu.ops import se3 as j_se3

from dvo_slam_tpu_torch.convert import pose_graph_from_reference
from dvo_slam_tpu_torch.models import irls_graph
from dvo_slam_tpu_torch.models import pose_graph as t_pg

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 120
CHUNKS = (2, 3, 8, 32)
GRAPHS = ("loopy", "stress")
X_RTOL = 1e-9  # tests/test_torch_pose_graph_solvers.py::test_cg_iterations_and_tolerance


def _exp(xi):
    return np.asarray(j_se3.exp_se3(jnp.asarray(xi, jnp.float32)), np.float64)


def _rel(a, b):
    return np.linalg.inv(a) @ b


def loopy_graph(n, seed):
    """tests/test_pose_graph.py's drifty ring with a robust loop every 7."""
    rng = np.random.default_rng(seed)
    step = [0.4, 0.0, 0.0, 0.0, 0.0, 2 * np.pi / n]
    true = [np.eye(4)]
    for _ in range(n):
        true.append(true[-1] @ _exp(step))
    g = j_pg.PoseGraph()
    pose = np.eye(4)
    g.add_vertex(0, pose, fixed=True)
    for i in range(n):
        meas = _rel(true[i], true[i + 1]) @ _exp(rng.normal(0, 0.02, 6))
        pose = pose @ meas
        g.add_vertex(i + 1, pose)
        g.add_edge(i, i + 1, meas, np.eye(6))
    for i in range(0, n - 7, 7):
        g.add_edge(i, i + 7, _rel(true[i], true[i + 7]), 50.0 * np.eye(6), robust=True)
    return g


def lm_stress_graph():
    """tests/test_pose_graph.py::_lm_stress_graph (float64)."""
    rng = np.random.default_rng(1)
    n = 40
    true = [np.eye(4)]
    step = _exp([0.5, 0, 0, 0, 0, 0.0])
    for _ in range(n - 1):
        true.append(true[-1] @ step)
    g = j_pg.PoseGraph(vertex_capacity=64, edge_capacity=64, dtype=np.float64)
    g.add_vertex(0, true[0], fixed=True)
    for i in range(1, n):
        g.add_vertex(i, true[i] @ _exp(rng.normal(0, 0.8, 6)))
    info = np.diag([1.0, 1.0, 1.0, 1e-4, 1e-4, 1e-4])
    for i in range(n - 1):
        g.add_edge(i, i + 1, _rel(true[i], true[i + 1]), info)
    g.add_edge(2, 37, _exp([3.0, -2.0, 1.5, 1.2, -0.9, 1.4]), np.eye(6) * 1e4)
    g.add_edge(5, 35, _exp([-2.5, 1.8, -1.2, -1.0, 1.1, -0.8]), np.eye(6) * 1e4)
    return g


def _system(graph):
    """(n, the solve's arguments: edges, blocks, -b, free) in float64."""
    arrays = pose_graph_from_reference(graph)._compact_subgraph(0).to_graph_arrays()
    arrays = arrays._replace(**{k: getattr(arrays, k).to(torch.float64)
                                for k in ("poses", "measurements", "information")})
    H_ii, H_ij, H_jj, b_i, b_j, _ = t_pg.edge_blocks(arrays)
    free = arrays.vertex_mask & ~arrays.fixed_mask
    b = t_pg._gradient(arrays, b_i, b_j)
    return arrays.poses.shape[0], (arrays.edge_i, arrays.edge_j, H_ii, H_ij, H_jj, -b, free)


@pytest.fixture(scope="module")
def systems():
    return {"loopy": _system(loopy_graph(24, seed=3)), "stress": _system(lm_stress_graph())}


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
data = np.load(f"{work}/systems.npz")
distributed.initialize(init_method=f"file://{work}/store{world}", world_size=world,
                       rank=rank, backend="gloo", device="cpu")
mesh = mesh_lib.make_mesh(world, device="cpu")
reduce = dba._all_reduce(mesh)
out = {}
for name in data["names"]:
    n = int(data[name + "/n"])
    ei, ej, H_ii, H_ij, H_jj, rhs, free = (torch.from_numpy(data[f"{name}/{f}"]) for f in range(7))
    per = ei.shape[0] // world
    lo = rank * per
    edge = lambda t: t[lo: lo + per]
    for chunk in [1] + [int(c) for c in data["chunks"]]:
        x, k = pg.solve_blocks_cg(n, edge(ei), edge(ej), edge(H_ii), edge(H_ij), edge(H_jj), rhs,
                                  free, return_iterations=True, all_reduce=reduce, chunk=chunk)
        out[f"{name}/K{chunk}/x"] = x.numpy()
        out[f"{name}/K{chunk}/k"] = np.array(k)
np.savez(f"{work}/out_w{world}_r{rank}.npz", **out)
distributed.shutdown()
print("rank", rank, "of", world, "done")
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, systems):
    """Two gloo ranks, each solving its half of every system's edges at
    K = 1 and every K of ``CHUNKS``: [rank] -> outputs."""
    work = tmp_path_factory.mktemp("ranks")
    arrays = {"names": np.array(GRAPHS), "chunks": np.array(CHUNKS)}
    for name, (n, args) in systems.items():
        arrays[name + "/n"] = np.array(n)
        pad = args[0].shape[0] % 2  # an edge of zero blocks on vertex 0 evens the shards
        for f, t in enumerate(args):
            if f < 5 and pad:
                t = torch.cat([t, torch.zeros((pad,) + t.shape[1:], dtype=t.dtype)])
            arrays[f"{name}/{f}"] = t.numpy()
    np.savez(work / "systems.npz", **arrays)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD, str(work), "2", str(rank)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    ) for rank in range(2)]
    try:
        for proc in procs:
            try:
                log, _ = proc.communicate(timeout=CHILD_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                pytest.fail(f"a rank did not finish within {CHILD_TIMEOUT_S} s")
            assert proc.returncode == 0, log
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [np.load(work / f"out_w2_r{rank}.npz") for rank in range(2)]


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("graph", GRAPHS)
def test_chunks_bit_equal_to_one_step(systems, graph, chunk):
    n, args = systems[graph]
    x1, k1 = t_pg.solve_blocks_cg(n, *args, return_iterations=True, chunk=1)
    x, k = t_pg.solve_blocks_cg(n, *args, return_iterations=True, chunk=chunk)
    assert k == k1 and 0 < k1 < 100
    assert x.dtype == x1.dtype and torch.equal(x, x1)


def test_cpu_default_is_one_step(systems):
    """On the CPU the default chunk is one step: a read per iteration, as
    the keyframe graph's host solves always read, and none before the
    first step (a first chunk from a failed condition is inert)."""
    n, args = systems["loopy"]
    reads = []
    read = t_pg._cg_read
    try:
        t_pg._cg_read = lambda carry: reads.append(1) or read(carry)
        _, k = t_pg.solve_blocks_cg(n, *args, return_iterations=True)
    finally:
        t_pg._cg_read = read
    assert len(reads) == k


@pytest.mark.parametrize("chunk", (1, 8))
@pytest.mark.parametrize("iterations", (100, 5))
def test_iterations_match_reference_on_lm_stress_graph(systems, iterations, chunk):
    """k equals the reference's while_loop count at its default tolerance,
    where it stops on the tolerance (100) and on the cap (5), and x agrees
    within 1e-9 of its largest entry."""
    n, args = systems["stress"]
    x, k = t_pg.solve_blocks_cg(n, *args, iterations=iterations, return_iterations=True,
                                chunk=chunk)
    with jax.enable_x64(True):
        x_ref, k_ref = j_pg.solve_blocks_cg(n, *(jnp.asarray(t.numpy()) for t in args),
                                            iterations=iterations, return_iterations=True)
        x_ref, k_ref = np.asarray(x_ref), int(k_ref)
    assert k == k_ref
    assert k < iterations if iterations == 100 else k == iterations
    np.testing.assert_allclose(x.numpy(), x_ref, rtol=0, atol=X_RTOL * float(x.abs().max()))


def test_step_past_stop_is_inert(systems):
    """Steps taken from a carry whose condition failed change no bit of
    it, k included."""
    n, args = systems["stress"]
    ei, ej, H_ii, H_ij, H_jj, rhs, free = args
    rhs = rhs * free.to(rhs.dtype)[:, None]
    L = t_pg.block_diag_preconditioner(n, ei, ej, H_ii, H_jj, free, rhs.dtype)
    stop2 = 1e-12 * torch.clamp(t_pg._vdot(rhs, rhs), min=1e-30)

    def matvec(v):
        return t_pg.edge_matvec(ei, ej, H_ii, H_ij, H_jj, free, v)

    z = t_pg._precond(L, rhs)
    k = torch.zeros((), dtype=torch.int64)
    carry = (torch.zeros_like(rhs), rhs, z, z, t_pg._vdot(rhs, z), k,
             t_pg._cg_active(k, rhs, 100, stop2))
    active, steps = True, 0
    while active:
        carry = t_pg._cg_chunk(matvec, L, carry, 1, 100, stop2)
        active, steps = bool(carry[6]), steps + 1
    assert int(carry[5]) == steps
    after = t_pg._cg_chunk(matvec, L, carry, 5, 100, stop2)
    for a, b in zip(after, carry):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("chunk", (1,) + CHUNKS)
@pytest.mark.parametrize("graph", GRAPHS)
def test_two_gloo_ranks(systems, ranks, graph, chunk):
    """Sharded over two ranks: the ranks agree bit for bit, every K gives
    the K = 1 bits, k is the one-process solve's and x within 1e-9 of
    its largest entry."""
    n, args = systems[graph]
    x1, k1 = t_pg.solve_blocks_cg(n, *args, return_iterations=True, chunk=1)
    key = f"{graph}/K{chunk}"
    r0, r1 = ranks
    for field in ("x", "k"):
        np.testing.assert_array_equal(r0[f"{key}/{field}"], r1[f"{key}/{field}"])
        np.testing.assert_array_equal(r0[f"{key}/{field}"], r0[f"{graph}/K1/{field}"])
    assert int(r0[key + "/k"]) == k1
    np.testing.assert_allclose(r0[key + "/x"], x1.numpy(), rtol=0,
                               atol=X_RTOL * float(x1.abs().max()))


def test_graph_route_is_chosen_up_front(systems, monkeypatch):
    """The card's CG takes graphs by the device and the reduction's group
    alone (``irls_graph.loop_form``, asked with the group that
    ``solve_blocks_cg`` names): the CPU and ``CUDA_GRAPHS`` off run
    eagerly, a reduction that names no group runs eagerly, no reduction is
    a local graph."""
    n, args = systems["loopy"]
    asked, loop_form = [], irls_graph.loop_form
    monkeypatch.setattr(irls_graph, "loop_form",
                        lambda device, group=(): asked.append(group) or loop_form(device, group))
    for reduce in (None, lambda x: x):
        t_pg.solve_blocks_cg(n, *args, iterations=1, all_reduce=reduce)
    no_reduction, unnamed = asked
    cuda = torch.device("cuda", 0)
    assert loop_form(torch.device("cpu"), no_reduction) == ("eager", None)
    assert loop_form(cuda, no_reduction) == ("while", ())
    assert loop_form(cuda, unnamed) == ("eager", None)
    monkeypatch.setattr(irls_graph, "CUDA_GRAPHS", False)
    assert loop_form(cuda, no_reduction) == ("eager", None)
