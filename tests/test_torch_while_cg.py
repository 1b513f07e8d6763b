"""Block-CG and the pixel-sharded level in the while form's terms, on the
CPU.

On the card both loops are one launch of a CUDA graph whose WHILE node
repeats a chunk while the loop's condition holds (block-CG: while
``active``; the sharded level: while not ``done``), the NCCL all-reduces
inside its body, where the process group's probe admitted that form
(``tests_cuda/test_while_cg_cuda.py``,
``tests_cuda/test_sharded_graph_cuda.py``).  Here:

- ``solve_blocks_cg`` against the reference's ``solve_blocks_cg``
  (float64, ``jax.enable_x64``) on the seeded 24-vertex loopy ring: starts
  whose condition already fails (a zero right-hand side, one below the
  tolerance's floor, an iteration cap of 0) give the reference's x and k =
  0, the eager loop running one inert chunk and then its one read, never a
  read before it; ``return_iterations`` on and off give the same x, and k
  equal to the reference's, at K = 1 and 8;
- the form is chosen up front per group (``irls_graph.loop_form``): the
  CPU, gloo and ``CUDA_GRAPHS`` off run eagerly; ``WHILE_GRAPHS`` off, a
  group whose probe was refused and a group that no probe chose replay
  host-polled; a
  probed NCCL group and a loop without collectives take the while form
  (NCCL and the card mocked: the graphs' chunks run eagerly in their
  place, and the one-rank all-reduce is the identity); the pixel-sharded
  level and CG then call the while runner with their flag and its sense,
  or the host-polled one, and give the eager loop's bits;
- two gloo ranks (child processes, ``file://`` rendezvous, ``jax``
  blocked): the ranks run the same chunks and reads, for CG over the ranks
  and for the pixel-sharded level, at K = 1 and 8, and no group form is
  probed over gloo.
"""

import contextlib
import json
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvo_slam_tpu.models import pose_graph as j_pg

from dvo_slam_tpu_torch.config import TrackerConfig
from dvo_slam_tpu_torch.models import dense_tracker, irls_graph
from dvo_slam_tpu_torch.models import pose_graph as t_pg
from dvo_slam_tpu_torch.odometry import build_frame, render_sequence, upload_sequence
from dvo_slam_tpu_torch.ops.camera import Intrinsics
from dvo_slam_tpu_torch.parallel import mesh as mesh_lib
from dvo_slam_tpu_torch.parallel import sharded_alignment
from dvo_slam_tpu_torch.tools import graph_check
from dvo_slam_tpu_torch.utils import synthetic

from test_torch_cg_chunks import X_RTOL, _system, loopy_graph

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 120
CHUNKS = (1, 8)
NCCL = ("group", "nccl", 1, 0, -1)  # a mocked NCCL group's key part
K = Intrinsics(80.0, 80.0, 39.5, 29.5)  # tests/test_parallel.py
SHAPE = (60, 80)
CFG = TrackerConfig(first_level=1, last_level=0, max_iterations_per_level=25,
                    kernel_backend="fused")


@pytest.fixture(scope="module")
def ring():
    return _system(loopy_graph(24, seed=3))


def _reference(n, args, iterations=100):
    with jax.enable_x64(True):
        x, k = j_pg.solve_blocks_cg(n, *(jnp.asarray(t.numpy()) for t in args),
                                    iterations=iterations, return_iterations=True)
        return np.asarray(x), int(k)


@contextlib.contextmanager
def _events():
    """The order of the eager loop's chunks and reads."""
    events = []
    chunk, read = t_pg._cg_chunk, t_pg._cg_read
    t_pg._cg_chunk = lambda *a: events.append("chunk") or chunk(*a)
    t_pg._cg_read = lambda carry: events.append("read") or read(carry)
    try:
        yield events
    finally:
        t_pg._cg_chunk, t_pg._cg_read = chunk, read


@pytest.mark.parametrize("returned", [True, False])
@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("start", ["zero", "below_floor", "no_iterations"])
def test_a_start_that_has_converged(ring, start, chunk, returned):
    n, (*edges, rhs, free) = ring
    iterations = 0 if start == "no_iterations" else 100
    if start != "no_iterations":
        rhs = torch.zeros_like(rhs) if start == "zero" else torch.full_like(rhs, 1e-24)
    args = (*edges, rhs, free)
    x_ref, k_ref = _reference(n, args, iterations)
    with _events() as events:
        out = t_pg.solve_blocks_cg(n, *args, iterations=iterations, chunk=chunk,
                                   return_iterations=returned)
    x, k = out if returned else (out, None)
    assert events == ["chunk", "read"]  # one inert chunk, then its read; none before
    assert k_ref == 0 and k in (0, None)
    np.testing.assert_array_equal(x.numpy(), x_ref)
    assert not x.abs().max()


@pytest.mark.parametrize("chunk", CHUNKS)
def test_return_iterations_on_and_off(ring, chunk):
    n, args = ring
    x_ref, k_ref = _reference(n, args)
    x, k = t_pg.solve_blocks_cg(n, *args, chunk=chunk, return_iterations=True)
    x_only = t_pg.solve_blocks_cg(n, *args, chunk=chunk)
    assert isinstance(k, int) and k == k_ref and 0 < k < 100
    assert torch.equal(x, x_only)
    np.testing.assert_allclose(x.numpy(), x_ref, rtol=0, atol=X_RTOL * float(x.abs().max()))


@contextlib.contextmanager
def _mocked_nccl(monkeypatch, form):
    """A one-rank NCCL group whose probe gave ``form`` ("while", "polled",
    or None for no probe); its collectives are the identity."""
    monkeypatch.setattr(irls_graph.dist, "get_backend", lambda group=None: "nccl")
    monkeypatch.setattr(irls_graph, "group_key", lambda group=None: NCCL)
    monkeypatch.setattr(torch.distributed, "all_reduce", lambda t, *a, **k: None)
    if form is not None:
        monkeypatch.setitem(irls_graph._group_forms, NCCL, irls_graph.GroupForm(
            form, None if form == "while" else "refused by the mock", {}))
    yield


def test_form_is_chosen_up_front_per_group(monkeypatch):
    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    assert irls_graph.loop_form(cpu, None) == ("eager", None)  # the CPU: eager
    monkeypatch.setattr(irls_graph.dist, "get_backend", lambda group=None: "gloo")
    assert irls_graph.loop_form(cuda, None) == ("eager", None)  # gloo: eager
    with _mocked_nccl(monkeypatch, "while"):
        assert irls_graph.loop_form(cuda, None) == ("while", NCCL)
        assert irls_graph.loop_form(cuda) == ("while", ())  # no collectives
        monkeypatch.setattr(irls_graph, "CUDA_GRAPHS", False)
        assert irls_graph.loop_form(cuda, None) == ("eager", None)  # CUDA_GRAPHS off
        monkeypatch.setattr(irls_graph, "CUDA_GRAPHS", True)
        monkeypatch.setattr(irls_graph, "WHILE_GRAPHS", False)  # WHILE_GRAPHS off: polled
        assert irls_graph.loop_form(cuda, None) == ("polled", NCCL)
        assert irls_graph.loop_form(cuda) == ("polled", ())
        monkeypatch.setattr(irls_graph, "WHILE_GRAPHS", True)
        assert irls_graph.stats()["group_forms"][repr(NCCL)] == "while"
        monkeypatch.setitem(irls_graph._group_forms, NCCL,
                            irls_graph.GroupForm("polled", "CUDA's text", {}))
        assert irls_graph.loop_form(cuda, None) == ("polled", NCCL)  # refused: polled
        assert irls_graph.stats()["group_forms"][repr(NCCL)] == "polled: CUDA's text"
        irls_graph.forget_group(NCCL)
        assert irls_graph.loop_form(cuda, None) == ("polled", NCCL)  # never probed: polled


class _Graphs:
    """Stands in for a key's ``LevelGraphs``: runs the chunks eagerly in the
    form the caller asks for and records it."""

    def __init__(self):
        self.lock = threading.Lock()
        self.calls = []

    def load(self, inputs):
        self.inputs = tuple(t.clone() for t in inputs)

    def run_level(self, program, counters, flag, loop_on=False):
        self.calls.append(("while", flag, loop_on))
        state = program(self.inputs, None)
        while bool((state[flag] == loop_on).any()):
            state = program(self.inputs, state)
        return state

    def run_head(self, program, counters):
        self.calls.append("head")
        self.program = program
        self.state = program(self.inputs, None)
        return self.state

    def run_tail(self, counters):
        self.calls.append("tail")
        self.state = self.program(self.inputs, self.state)
        return self.state


def _as_on_the_card(monkeypatch):
    """``irls_graph.loop_form`` as on the card, for the CPU tensors."""
    loop_form = irls_graph.loop_form
    monkeypatch.setattr(irls_graph, "loop_form",
                        lambda device, group=(): loop_form(torch.device("cuda", 0), group))


def _graphs(monkeypatch):
    made = []

    def graphs_for(key, device):
        made.append((key, _Graphs()))
        return made[-1][1]

    monkeypatch.setattr(irls_graph, "graphs_for", graphs_for)
    return made


@pytest.fixture(scope="module")
def pair():
    poses = synthetic.circular_trajectory(2, radius=0.05, rot_amplitude=0.02)
    intensity, depth = upload_sequence(*render_sequence(poses, SHAPE, K), torch.device("cpu"))
    return [build_frame(CFG, intensity[k], depth[k]) for k in range(2)]


def _sharded(pair):
    mesh = mesh_lib.Mesh(None, mesh_lib.BATCH_AXIS, 0, 1, torch.device("cpu"))
    with graph_check.sharded_recording() as levels:
        result = sharded_alignment.make_pixel_sharded_matcher(CFG, K, mesh)(
            *pair, torch.eye(4))
    return result, levels


# the sharded level's cases: the group's probed form (None: no probe) and
# whether WHILE_GRAPHS is on
SHARDED_FORMS = {"while": ("while", True), "polled": ("polled", True),
                 "while_graphs_off": ("while", False), "unprobed": (None, True)}


@pytest.mark.parametrize("form", list(SHARDED_FORMS))
def test_sharded_level_takes_its_groups_form(pair, monkeypatch, form):
    probed, while_graphs = SHARDED_FORMS[form]
    with _mocked_nccl(monkeypatch, probed):
        want, want_levels = _sharded(pair)  # eager: the graph route not taken
        _as_on_the_card(monkeypatch)
        monkeypatch.setattr(irls_graph, "WHILE_GRAPHS", while_graphs)
        made = _graphs(monkeypatch)
        got, levels = _sharded(pair)
    assert len(made) == len(levels) == CFG.first_level - CFG.last_level + 1
    for key, graphs in made:
        assert key[0] == "sharded" and key[1] == NCCL
        if form == "while":
            assert graphs.calls == [("while", dense_tracker._DONE, False)]
        else:
            assert graphs.calls[0] == "head" and set(graphs.calls[1:]) <= {"tail"}
    assert graph_check.differences(levels, want_levels) == []
    assert torch.equal(got.transformation, want.transformation)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("form", ["while", "polled"])
def test_cg_takes_its_groups_form(ring, monkeypatch, form, chunk):
    n, args = ring
    x_ref, k_ref = t_pg.solve_blocks_cg(n, *args, chunk=chunk, return_iterations=True)

    def reduce(t):
        return t

    reduce.group = None
    with _mocked_nccl(monkeypatch, form):
        _as_on_the_card(monkeypatch)
        made = _graphs(monkeypatch)
        reads = []
        read = t_pg._cg_read
        monkeypatch.setattr(t_pg, "_cg_read", lambda carry: reads.append(1) or read(carry))
        x, k = t_pg.solve_blocks_cg(n, *args, chunk=chunk, return_iterations=True,
                                    all_reduce=reduce)
    ((key, graphs),) = made
    assert key[0] == "cg" and key[1] == NCCL
    if form == "while":
        assert graphs.calls == [("while", t_pg._ACTIVE, True)] and reads == []
    else:
        assert graphs.calls == ["head"] + ["tail"] * (len(reads) - 1)
        assert len(reads) == -(-k_ref // chunk)
    assert k == k_ref and torch.equal(x, x_ref)


# Two ranks of the port.  argv: work directory, world size, rank.
_CHILD = r"""
import json, sys
sys.modules["jax"] = None  # the port's multi-rank path needs no JAX
import numpy as np
import torch
torch.set_num_threads(1)
from dvo_slam_tpu_torch.config import TrackerConfig
from dvo_slam_tpu_torch.models import dense_tracker, irls_graph, pose_graph as pg
from dvo_slam_tpu_torch.odometry import build_frame, render_sequence, upload_sequence
from dvo_slam_tpu_torch.ops.camera import Intrinsics
from dvo_slam_tpu_torch.parallel import distributed, distributed_ba as dba, mesh as mesh_lib
from dvo_slam_tpu_torch.parallel import sharded_alignment as sa
from dvo_slam_tpu_torch.utils import synthetic

work, world, rank = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
spec = json.load(open(f"{work}/spec.json"))
distributed.initialize(init_method=f"file://{work}/store", world_size=world, rank=rank,
                       backend="gloo", device="cpu")
mesh = mesh_lib.make_mesh(world, device="cpu")
out = {"forms": irls_graph.stats()["group_forms"]}
data = np.load(f"{work}/system.npz")
ei, ej, H_ii, H_ij, H_jj, rhs, free = (torch.from_numpy(data[str(f)]) for f in range(7))
per = ei.shape[0] // world
edge = lambda t: t[rank * per: (rank + 1) * per]
chunks, chunk_fn = [0], pg._cg_chunk
pg._cg_chunk = lambda *a: chunks.__setitem__(0, chunks[0] + 1) or chunk_fn(*a)
poses = synthetic.circular_trajectory(2, radius=0.05, rot_amplitude=0.02)
K = Intrinsics(*spec["K"])
cfg = TrackerConfig(**spec["cfg"])
intensity, depth = upload_sequence(*render_sequence(poses, tuple(spec["shape"]), K),
                                   torch.device("cpu"))
frames = [build_frame(cfg, intensity[k], depth[k]) for k in range(2)]
for chunk in spec["chunks"]:
    chunks[0] = 0
    x, k = pg.solve_blocks_cg(int(data["n"]), edge(ei), edge(ej), edge(H_ii), edge(H_ij),
                              edge(H_jj), rhs, free, return_iterations=True,
                              all_reduce=dba._all_reduce(mesh), chunk=chunk)
    out[f"cg/K{chunk}"] = [k, chunks[0]]
    sa.CHUNK_STEPS = chunk
    dense_tracker.read_done.calls = 0
    r = sa.make_pixel_sharded_matcher(cfg, K, mesh)(*frames, torch.eye(4))
    out[f"sharded/K{chunk}"] = [[int(s.iterations) for s in r.level_stats],
                                dense_tracker.read_done.calls]
distributed.shutdown()
with open(f"{work}/out_r{rank}.json", "w") as f:
    json.dump(out, f)
print("rank", rank, "done")
"""


def test_two_gloo_ranks_run_the_same_chunks(tmp_path, ring):
    n, args = ring
    arrays = {"n": np.array(n)}
    pad = args[0].shape[0] % 2  # an edge of zero blocks on vertex 0 evens the shards
    for f, t in enumerate(args):
        if f < 5 and pad:
            t = torch.cat([t, torch.zeros((pad,) + t.shape[1:], dtype=t.dtype)])
        arrays[str(f)] = t.numpy()
    np.savez(tmp_path / "system.npz", **arrays)
    spec = {"K": list(K), "shape": list(SHAPE), "chunks": list(CHUNKS),
            "cfg": dict(first_level=1, last_level=0, max_iterations_per_level=25,
                        kernel_backend="fused")}
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD, str(tmp_path), "2", str(rank)],
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
    r0, r1 = (json.loads((tmp_path / f"out_r{rank}.json").read_text()) for rank in range(2))
    assert r0 == r1
    assert r0["forms"] == {}  # gloo: no probe, the chunks run eagerly
    for chunk in CHUNKS:
        k, chunks = r0[f"cg/K{chunk}"]
        assert 0 < k and chunks == -(-k // chunk)
        iterations, reads = r0[f"sharded/K{chunk}"]
        assert reads == sum(-(-it // chunk) for it in iterations) > 0
