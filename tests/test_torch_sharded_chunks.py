"""The pixel-sharded IRLS level in chunks of K steps, on the CPU.

``parallel/sharded_alignment`` runs each level's loop as the tracker's:
K steps (``CHUNK_STEPS``) between two reads of ``done``, a step past
``done`` inert.  On the CPU, and over gloo, the chunks run eagerly; on the
card over NCCL each is one CUDA graph replay
(``tests_cuda/test_sharded_graph_cuda.py``).  Here the port's ranks run as
child processes, two gloo ranks and one on a ``file://`` rendezvous in a
temporary directory (``jax`` blocked, each joined with its own timeout),
on the 60x80 scene and config of
``tests/test_parallel.py::test_pixel_sharded_matcher``, at K = 1-4:

- every level's final carry, its iterations and terminations, and the
  result, bit-equal to K = 1;
- the counts (selected pixels, valid constraints, iterations,
  terminations) equal to the reference's ``make_pixel_sharded_matcher``
  on a 2-device mesh, compiled, and the pose within the atol 1e-5 that
  ``tests/test_torch_parallel.py`` states;
- the evaluations executed equal ``dense_tracker.executed_steps``.

And the graph cache's bookkeeping for process groups (no capture): a key
carries its group's backend, size, rank and generation, a new
``initialize`` starts a new generation, ``shutdown`` releases the group's
keys and ``release(where=...)`` drops only the keys that match.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvo_slam_tpu.config import TrackerConfig
from dvo_slam_tpu.models.frames import Frame
from dvo_slam_tpu.ops import se3 as j_se3
from dvo_slam_tpu.ops.camera import Intrinsics
from dvo_slam_tpu.parallel import mesh as j_mesh
from dvo_slam_tpu.parallel.sharded_alignment import make_pixel_sharded_matcher
from dvo_slam_tpu.utils import synthetic

from dvo_slam_tpu_torch.models import irls_graph

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 120
K = (80.0, 80.0, 39.5, 29.5)  # tests/test_parallel.py
SHAPE = (60, 80)
CFG = dict(first_level=1, last_level=0, max_iterations_per_level=25, kernel_backend="fused")
TWIST = [0.012, -0.006, 0.008, 0.003, 0.0, 0.005]
SEED = 11
CHUNKS = (1, 2, 3, 4)
WORLDS = (1, 2)
POSE_ATOL = 1e-5  # tests/test_torch_parallel.py

# One rank of the port.  argv: work directory, world size, rank.
_CHILD = r"""
import json, sys
sys.modules["jax"] = None  # the port's multi-rank path needs no JAX
import numpy as np
import torch
torch.set_num_threads(1)
from dvo_slam_tpu_torch.config import TrackerConfig
from dvo_slam_tpu_torch.convert import levels_from_numpy
from dvo_slam_tpu_torch.models import dense_tracker, irls_graph
from dvo_slam_tpu_torch.ops import fused_kernels
from dvo_slam_tpu_torch.ops.camera import Intrinsics
from dvo_slam_tpu_torch.parallel import distributed, mesh as mesh_lib
from dvo_slam_tpu_torch.parallel import sharded_alignment as sa

work, world, rank = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
spec = json.load(open(f"{work}/spec.json"))
data = np.load(f"{work}/inputs.npz")
K = Intrinsics(*spec["K"])
cfg = TrackerConfig(**spec["cfg"])
distributed.initialize(init_method=f"file://{work}/store{world}", world_size=world,
                       rank=rank, backend="gloo", device="cpu")
mesh = mesh_lib.make_mesh(world, device="cpu")
levels = lambda role: levels_from_numpy(
    [tuple(data[f"{role}/{l}/{f}"] for f in range(8)) for l in range(spec["levels"])],
    device="cpu")
ref, cur = levels("ref"), levels("cur")
out = {}

carries, evaluations = [], [0]
match_level, plain = sa._match_level_sharded, fused_kernels.warp_fused_partials_plain
def recorded(*args):
    carry, iterations = match_level(*args)
    carries.append(carry)
    return carry, iterations
def counted(*args, **kwargs):
    evaluations[0] += 1
    return plain(*args, **kwargs)
sa._match_level_sharded, fused_kernels.warp_fused_partials_plain = recorded, counted
for chunk in spec["chunks"]:
    sa.CHUNK_STEPS = chunk
    carries.clear()
    evaluations[0] = 0
    r = sa.make_pixel_sharded_matcher(cfg, K, mesh)(ref, cur, torch.eye(4))
    key = f"K{chunk}"
    out[key + "/T"] = r.transformation.numpy()
    out[key + "/info"] = r.information.numpy()
    out[key + "/nll"] = r.neg_log_likelihood.numpy()
    out[key + "/counts"] = np.array(
        [[int(s.valid_pixels), int(s.valid_constraints), int(s.iterations), int(s.termination)]
         for s in r.level_stats], np.int64)
    out[key + "/executed"] = np.array(
        dense_tracker.executed_steps([s.iterations for s in r.level_stats], chunk))
    out[key + "/evaluations"] = np.array(evaluations[0])
    for lv, carry in enumerate(carries):
        for field, value in zip(carry._fields, carry):
            out[f"{key}/carry{lv}/{field}"] = value.numpy()
sa._match_level_sharded, fused_kernels.warp_fused_partials_plain = match_level, plain

# the graph cache's keys and the process group (bookkeeping; no capture)
cpu = torch.device("cpu")
tag = irls_graph.group_key()
irls_graph.graphs_for(("sharded", tag), cpu)
irls_graph.graphs_for(("level",), cpu)
book = {"tag": list(tag), "keys_before": len(irls_graph._cache)}
distributed.shutdown()
book["keys_after_shutdown"] = sorted(repr(k[1:]) for k in irls_graph._cache)
distributed.initialize(init_method=f"file://{work}/again{world}", world_size=world,
                       rank=rank, backend="gloo", device="cpu")
# every rank has joined the new group before any rank can tear it down
torch.distributed.barrier()
book["tag_again"] = list(irls_graph.group_key())
distributed.shutdown()
irls_graph.release()
with open(f"{work}/book_w{world}_r{rank}.json", "w") as f:
    json.dump(book, f)
np.savez(f"{work}/out_w{world}_r{rank}.npz", **out)
print("rank", rank, "of", world, "done")
"""


def _exp(twist):
    return np.asarray(j_se3.exp_se3(jnp.asarray(np.asarray(twist, np.float32))), np.float64)


def _levels(pose):
    i, d, v = synthetic.render_frame(pose, Intrinsics(*K), SHAPE, seed=SEED, depth_noise=0.002)
    return Frame.from_arrays(i, d, v, 0.0, 2).levels


def _join(procs):
    """Join each rank with its own timeout; kill every rank if one hangs."""
    for proc in procs:
        try:
            log, _ = proc.communicate(timeout=CHILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
                p.communicate()
            pytest.fail(f"a rank did not finish within {CHILD_TIMEOUT_S} s")
        assert proc.returncode == 0, log


@pytest.fixture(scope="module")
def scene():
    return _levels(np.eye(4)), _levels(_exp(TWIST))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, scene):
    """Both worlds' ranks, run once: ``ranks[world][rank]`` is (outputs,
    bookkeeping)."""
    work = tmp_path_factory.mktemp("ranks")
    arrays = {}
    for role, levels in zip(("ref", "cur"), scene):
        for lv, level in enumerate(levels):
            for f, value in enumerate(level):
                arrays[f"{role}/{lv}/{f}"] = np.array(value)
    np.savez(work / "inputs.npz", **arrays)
    spec = {"K": K, "cfg": CFG, "chunks": CHUNKS, "levels": len(scene[0])}
    (work / "spec.json").write_text(json.dumps(spec))
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = {
        world: [subprocess.Popen(
            [sys.executable, "-c", _CHILD, str(work), str(world), str(rank)],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ) for rank in range(world)]
        for world in WORLDS
    }
    try:
        for world in WORLDS:
            _join(procs[world])
    finally:
        for group in procs.values():
            for p in group:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    return {
        world: [(np.load(work / f"out_w{world}_r{rank}.npz"),
                 json.loads((work / f"book_w{world}_r{rank}.json").read_text()))
                for rank in range(world)]
        for world in WORLDS
    }


@pytest.fixture(scope="module")
def reference(scene):
    """The reference's pixel-sharded matcher on a 2-device mesh, compiled."""
    run = make_pixel_sharded_matcher(TrackerConfig(**CFG), Intrinsics(*K), j_mesh.make_mesh(2))
    r = run(*scene, jnp.eye(4, dtype=jnp.float32))
    counts = np.array([[int(s.valid_pixels), int(s.valid_constraints), int(s.iterations),
                        int(s.termination)] for s in r.level_stats])
    return counts, np.asarray(r.transformation)


def _fields(out, prefix):
    return sorted(k for k in out.files if k.startswith(prefix + "/"))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("chunk", CHUNKS[1:])
def test_chunks_bit_equal_to_one_step(ranks, world, chunk):
    """Every level's carry, the counts and the result at K = 2-4 are the
    K = 1 run's bits, on every rank."""
    for out, _ in ranks[world]:
        want = _fields(out, "K1")
        got = _fields(out, f"K{chunk}")
        assert [k[len(f"K{chunk}"):] for k in got] == [k[2:] for k in want]
        assert any("/carry1/" in k for k in want)
        for name in want:
            if name.endswith(("/executed", "/evaluations")):
                continue
            a, b = out[f"K{chunk}" + name[2:]], out[name]
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), name


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("chunk", CHUNKS)
def test_counts_match_reference(ranks, reference, world, chunk):
    """The level statistics equal the reference's (a one-rank run its
    selected pixels, iterations and terminations, as
    ``tests/test_torch_parallel.py`` holds it), the pose within 1e-5, and
    the ranks return the same bits."""
    counts, T = reference
    out = ranks[world][0][0]
    got = out[f"K{chunk}/counts"]
    if world == 2:
        np.testing.assert_array_equal(got, counts)
    else:
        np.testing.assert_array_equal(got[:, [0, 2, 3]], counts[:, [0, 2, 3]])
    np.testing.assert_allclose(out[f"K{chunk}/T"], T, atol=POSE_ATOL)
    for other, _ in ranks[world][1:]:
        for name in _fields(out, f"K{chunk}"):
            np.testing.assert_array_equal(other[name], out[name])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("chunk", CHUNKS)
def test_evaluations_are_executed_steps(ranks, world, chunk):
    """A level runs K * ceil(iterations / K) evaluations; past K = 1 some
    of them are the inert steps after ``done``."""
    for out, _ in ranks[world]:
        its = out[f"K{chunk}/counts"][:, 2]
        executed = int(out[f"K{chunk}/executed"])
        assert int(out[f"K{chunk}/evaluations"]) == executed
        assert executed == sum(-(-int(i) // chunk) * chunk for i in its)
        if chunk == 1:
            assert executed == its.sum()


@pytest.mark.parametrize("world", WORLDS)
def test_group_keys_and_shutdown(ranks, world):
    """A key names its group's backend, size, rank and generation;
    ``shutdown`` drops that group's keys and no other; the next
    ``initialize`` is a new generation."""
    for rank, (_, book) in enumerate(ranks[world]):
        tag = book["tag"]
        assert tag[:4] == ["group", "gloo", world, rank]
        assert book["keys_before"] == 2
        assert book["keys_after_shutdown"] == [repr(("level",))]
        assert book["tag_again"][:4] == tag[:4] and book["tag_again"][4] == tag[4] + 1


def test_release_where_drops_only_matching_keys():
    """``release(where=...)`` drops the keys it matches, here by their
    group part (two generations of one group), and keeps the rest; a
    dropped key comes back empty, to be captured anew."""
    cpu = torch.device("cpu")
    old, new = ("group", "nccl", 1, 0, 1), ("group", "nccl", 1, 0, 2)
    keys = [("sharded", old, 1), ("cg", old, 8), ("sharded", new, 1), ("level", 1)]
    try:
        made = {key: irls_graph.graphs_for(key, cpu) for key in keys}
        assert len({id(g) for g in made.values()}) == len(keys)
        assert irls_graph.graphs_for(keys[2], cpu) is made[keys[2]]
        irls_graph.release(where=lambda key: old in key)
        left = sorted(k[1:] for k in irls_graph._cache)
        assert left == sorted([keys[2], keys[3]])
        assert irls_graph.graphs_for(keys[0], cpu) is not made[keys[0]]
        irls_graph.release(where=lambda key: key[0] == "level")
        assert sorted(k[1:] for k in irls_graph._cache) == sorted([keys[0], keys[2]])
    finally:
        irls_graph.release()
    assert not irls_graph._cache
