"""The port's multi-rank paths against the reference, on the CPU.

The port's collectives run in child processes, two gloo ranks (and one)
that rendezvous on a ``file://`` store in a temporary directory: no
process group is ever initialised in the test worker.  The children import
only the port, with ``jax`` blocked, and each is joined with its own
timeout and killed on expiry.  The reference runs in the test process, on
the 8-device virtual CPU mesh of ``tests/conftest.py``, compiled.

The pixel-sharded matcher at 2 ranks is held to the reference's
``make_pixel_sharded_matcher`` on ``make_mesh(2)``, on the 60x80 scene and
config of ``tests/test_parallel.py::test_pixel_sharded_matcher`` and on a
second scene with mu = 0.05 and a non-identity initial guess.  Per level,
iterations, terminations, selected pixels and valid constraints EQUAL; the
estimate within atol 1e-5; the information within rtol 1e-3 plus an atol
of 1e-3 of its largest entry (the tracker parity tests' stated deviation:
its small off-diagonal entries cancel); the negative log-likelihood within
rtol 1e-4.  The reference's sharded path differs from its own single path
in four ways (ROADMAP queue C, (a)-(d)); the port mirrors each, and one
test pins each.
"""

import json
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dvo_slam_tpu.config import TrackerConfig
from dvo_slam_tpu.models.frames import Frame
from dvo_slam_tpu.ops import se3 as j_se3
from dvo_slam_tpu.ops.camera import Intrinsics
from dvo_slam_tpu.parallel import distributed as j_distributed
from dvo_slam_tpu.parallel import mesh as j_mesh
from dvo_slam_tpu.parallel.sharded_alignment import make_pixel_sharded_matcher
from dvo_slam_tpu.utils import synthetic

from dvo_slam_tpu_torch.parallel import distributed as t_distributed
from dvo_slam_tpu_torch.parallel import mesh as t_mesh

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 120
K = (80.0, 80.0, 39.5, 29.5)  # tests/test_parallel.py
SHAPE = (60, 80)
FIELDS = ("intensity", "depth", "valid", "idx", "idy", "zdx", "zdy", "zvalid")

SHARDED_CFG = dict(
    first_level=1, last_level=0, max_iterations_per_level=25, kernel_backend="fused"
)
WARM_TWIST = [-0.01, 0.008, 0.006, -0.002, 0.004, -0.003]
WARM_GUESS = [-0.006, 0.005, 0.004, -0.001, 0.002, -0.002]
# name -> (config, twist of the current camera, render seed, initial-guess twist)
SCENES = {
    # tests/test_parallel.py::test_pixel_sharded_matcher
    "identity": (SHARDED_CFG, [0.012, -0.006, 0.008, 0.003, 0.0, 0.005], 11, None),
    # the benchmark's smoothing weight from a warm start: quirk (b)
    "mu-warm": (dict(SHARDED_CFG, mu=0.05), WARM_TWIST, 5, WARM_GUESS),
    # a weight at which the prior moves the estimate: quirk (a)
    "mu-strong": (dict(SHARDED_CFG, mu=1e7), WARM_TWIST, 5, WARM_GUESS),
}
PAIR_CFG = dict(first_level=1, last_level=0, max_iterations_per_level=20)
PAIR_TWISTS = [  # tests/test_parallel.py::test_pair_parallel_matcher, pairs 0-3
    [0.01 * (i % 3 - 1), 0.005 * (i % 2), 0.0, 0.0, 0.0, 0.004 * (i % 2)] for i in range(4)
]

# One rank of the port.  argv: work directory, world size, rank.
_CHILD = r"""
import json, sys
sys.modules["jax"] = None  # the port's multi-rank path needs no JAX
import numpy as np
import torch
torch.set_num_threads(1)
from dvo_slam_tpu_torch.config import TrackerConfig
from dvo_slam_tpu_torch.convert import levels_from_numpy
from dvo_slam_tpu_torch.models.dense_tracker import match_pyramids
from dvo_slam_tpu_torch.ops.camera import Intrinsics
from dvo_slam_tpu_torch.ops import se3
from dvo_slam_tpu_torch.parallel import distributed, mesh as mesh_lib
from dvo_slam_tpu_torch.parallel import sharded_alignment as sa

work, world, rank = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
spec = json.load(open(f"{work}/spec.json"))
data = np.load(f"{work}/inputs.npz")
K = Intrinsics(*spec["K"])
distributed.initialize(init_method=f"file://{work}/store{world}", world_size=world,
                       rank=rank, backend="gloo")
mesh = mesh_lib.make_mesh(world)
out = {}

def levels(prefix):
    return levels_from_numpy([tuple(data[f"{prefix}/{l}/{f}"] for f in spec["fields"])
                              for l in range(spec["levels"][prefix])])

def save(prefix, r):
    out[prefix + "/T"] = r.transformation.numpy()
    out[prefix + "/info"] = r.information.numpy()
    out[prefix + "/nll"] = r.neg_log_likelihood.numpy()
    out[prefix + "/counts"] = np.array(
        [[np.asarray(s.valid_pixels), np.asarray(s.valid_constraints), np.asarray(s.iterations),
          np.asarray(s.termination)] for s in r.level_stats], np.int64)

for name, scene in spec["scenes"].items():
    cfg = TrackerConfig(**scene["cfg"])
    ref, cur = levels(name + "/ref"), levels(name + "/cur")
    init = torch.from_numpy(data[name + "/init"])
    result, final = sa._solve_pixel_sharded(cfg, K, mesh, ref, cur, init)
    save(f"sharded/{name}", result)
    if world == 1:
        out[f"final_ll/{name}"] = final.ll.numpy()
        out[f"final_prior/{name}"] = (cfg.mu * torch.sum(se3.log_se3(final.initial) ** 2)).numpy()
        save(f"single/{name}", match_pyramids(cfg, K, ref, cur, init))
        for key, value in (("depth_buffered_sampling", False), ("kernel_backend", "pallas")):
            save(f"sharded/{name}/{key}", sa.make_pixel_sharded_matcher(
                TrackerConfig(**dict(scene["cfg"], **{key: value})), K, mesh)(ref, cur, init))
        save(f"single/{name}/depth_buffered_sampling", match_pyramids(
            TrackerConfig(**dict(scene["cfg"], depth_buffered_sampling=False)), K, ref, cur, init))

if world == 2:
    cfg = TrackerConfig(**spec["pair_cfg"])
    ref_stack, cur_stack = levels("pairs/ref"), levels("pairs/cur")
    inits = torch.from_numpy(data["pairs/inits"])
    run = sa.make_pair_parallel_matcher(cfg, K, mesh)
    save("pairs/wave", run(ref_stack, cur_stack, inits))
    for b in range(inits.shape[0]):
        save(f"pairs/{b}", match_pyramids(cfg, K, sa._pair(ref_stack, b), sa._pair(cur_stack, b),
                                          inits[b]))
    try:
        run(ref_stack, cur_stack, inits[:3])
    except ValueError as exc:
        out["pairs/odd_batch_error"] = np.array(str(exc))
np.savez(f"{work}/out_w{world}_r{rank}.npz", **out)
distributed.shutdown()
print("rank", rank, "of", world, "done")
"""


def _exp(twist):
    return np.asarray(j_se3.exp_se3(jnp.asarray(np.asarray(twist, np.float32))), np.float64)


def _levels(pose, seed):
    i, d, v = synthetic.render_frame(pose, Intrinsics(*K), SHAPE, seed=seed, depth_noise=0.002)
    return Frame.from_arrays(i, d, v, 0.0, 2).levels


def _put_levels(arrays, prefix, levels):
    """Store each level's eight fields (in ``PyramidLevel`` order)."""
    for lv, level in enumerate(levels):
        for field, value in zip(FIELDS, level):
            arrays[f"{prefix}/{lv}/{field}"] = np.array(value)
    return len(levels)


def _start_ranks(work, world):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return [
        subprocess.Popen(
            [sys.executable, "-c", _CHILD, str(work), str(world), str(rank)],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for rank in range(world)
    ]


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


class _PortRuns:
    """The port's ranks, started once per module; ``out(world, rank)``
    joins them on first use."""

    def __init__(self, work):
        self.work = work
        self.scenes = {}
        arrays, levels = {}, {}
        for name, (cfg, twist, seed, init_twist) in SCENES.items():
            ref, cur = _levels(np.eye(4), seed), _levels(_exp(twist), seed)
            init = np.eye(4) if init_twist is None else _exp(init_twist)
            self.scenes[name] = (ref, cur, init.astype(np.float32))
            levels[name + "/ref"] = _put_levels(arrays, name + "/ref", ref)
            levels[name + "/cur"] = _put_levels(arrays, name + "/cur", cur)
            arrays[name + "/init"] = init.astype(np.float32)
        pairs = [(_levels(np.eye(4), i), _levels(_exp(t), i)) for i, t in enumerate(PAIR_TWISTS)]
        for role, k in (("ref", 0), ("cur", 1)):
            stacked = [  # the reference's stack_frames: a leading batch axis
                [np.stack([np.array(pair[k][lv][f]) for pair in pairs]) for f in range(8)]
                for lv in range(len(pairs[0][k]))
            ]
            levels["pairs/" + role] = _put_levels(arrays, "pairs/" + role, stacked)
        arrays["pairs/inits"] = np.stack([np.eye(4, dtype=np.float32)] * len(PAIR_TWISTS))
        np.savez(work / "inputs.npz", **arrays)
        spec = {
            "K": K, "fields": FIELDS, "levels": levels, "pair_cfg": PAIR_CFG,
            "scenes": {name: {"cfg": s[0]} for name, s in SCENES.items()},
        }
        (work / "spec.json").write_text(json.dumps(spec))
        self.procs = {2: _start_ranks(work, 2), 1: _start_ranks(work, 1)}
        self.joined = set()

    def out(self, world, rank=0):
        if world not in self.joined:
            _join(self.procs[world])
            self.joined.add(world)
        return np.load(self.work / f"out_w{world}_r{rank}.npz")

    def kill(self):
        for procs in self.procs.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    runs = _PortRuns(tmp_path_factory.mktemp("ranks"))
    yield runs
    runs.kill()


def _counts(result):
    return np.array([
        [int(s.valid_pixels), int(s.valid_constraints), int(s.iterations), int(s.termination)]
        for s in result.level_stats
    ])


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_pixel_sharded_matches_reference(port, scene):
    ref_levels, cur_levels, init = port.scenes[scene]
    run = make_pixel_sharded_matcher(TrackerConfig(**SCENES[scene][0]), Intrinsics(*K),
                                     j_mesh.make_mesh(2))
    ref = run(ref_levels, cur_levels, jnp.asarray(init))
    out = port.out(2)
    key = f"sharded/{scene}"
    np.testing.assert_array_equal(out[key + "/counts"], _counts(ref))
    assert (out[key + "/counts"][:, 1] > 1000).all()
    np.testing.assert_allclose(out[key + "/T"], np.asarray(ref.transformation), atol=1e-5)
    info_ref = np.asarray(ref.information)
    np.testing.assert_allclose(out[key + "/info"], info_ref, rtol=1e-3,
                               atol=1e-3 * np.abs(info_ref).max())
    np.testing.assert_allclose(out[key + "/nll"], float(ref.neg_log_likelihood), rtol=1e-4)
    # and it tracks: the reference test's ground-truth gate
    est = out[key + "/T"].astype(np.float64)
    err = np.asarray(j_se3.log_se3(jnp.asarray(
        np.linalg.inv(_exp(SCENES[scene][1])) @ est, jnp.float32)))
    assert np.abs(err).max() < 5e-3, err


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_ranks_agree(port, scene):
    """Both ranks return the same bits; 2 ranks and 1 rank take the same
    iterations and terminations, and agree on the estimate."""
    key = f"sharded/{scene}"
    r0, r1, single = port.out(2, 0), port.out(2, 1), port.out(1, 0)
    for field in ("T", "info", "nll", "counts"):
        np.testing.assert_array_equal(r0[f"{key}/{field}"], r1[f"{key}/{field}"])
    np.testing.assert_array_equal(r0[key + "/counts"][:, 2:], single[key + "/counts"][:, 2:])
    np.testing.assert_allclose(r0[key + "/T"], single[key + "/T"], atol=1e-5)


def test_quirk_a_prior_restarts_at_identity(port):
    """(a) With mu = 0 the sharded and single paths coincide; from a warm
    start with a prior strong enough to move the estimate they part, since
    the sharded path's prior pulls toward each level's start and not toward
    the guess (the reference's sharded path does the same:
    test_pixel_sharded_matches_reference[mu-strong]).  At the benchmark's
    mu = 0.05 the two differ by about 1e-8."""
    out = port.out(1)
    np.testing.assert_array_equal(out["sharded/identity/counts"], out["single/identity/counts"])
    np.testing.assert_allclose(out["sharded/identity/T"], out["single/identity/T"], atol=1e-6)
    gap = np.abs(out["sharded/mu-strong/T"] - out["single/mu-strong/T"]).max()
    assert gap > 5e-5, gap
    assert not np.array_equal(out["sharded/mu-strong/counts"], out["single/mu-strong/counts"])


def test_quirk_b_no_prior_in_neg_log_likelihood(port):
    """(b) The sharded result's negative log-likelihood is -ll of the last
    accepted iteration, without the prior term the single path adds."""
    out = port.out(1)
    assert float(out["final_prior/mu-warm"]) > 0.0
    np.testing.assert_array_equal(out["sharded/mu-warm/nll"], -out["final_ll/mu-warm"])


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_quirk_c_sampling_always_depth_buffered(port, scene):
    """(c) depth_buffered_sampling=False changes the single path's result
    and not the sharded path's."""
    out = port.out(1)
    key = f"sharded/{scene}"
    for field in ("T", "info", "nll", "counts"):
        np.testing.assert_array_equal(
            out[f"{key}/depth_buffered_sampling/{field}"], out[f"{key}/{field}"]
        )
    single = f"single/{scene}"
    assert not np.array_equal(out[f"{single}/depth_buffered_sampling/T"], out[f"{single}/T"])


def test_quirk_d_kernel_backend_not_read(port):
    """(d) kernel_backend='pallas' on CPU tensors raises on the single path
    (test_torch_dense_tracker) and is not read on the sharded path: the
    partials go by the device."""
    out = port.out(1)
    for field in ("T", "info", "nll", "counts"):
        np.testing.assert_array_equal(
            out[f"sharded/identity/kernel_backend/{field}"], out[f"sharded/identity/{field}"]
        )


def test_pair_parallel_bit_equal_to_match_pyramids(port):
    """2 ranks x 2 pairs: the gathered wave is bit-equal to match_pyramids
    pair by pair, and tracks; 3 pairs do not divide over 2 ranks."""
    out = port.out(2)
    for b, twist in enumerate(PAIR_TWISTS):
        np.testing.assert_array_equal(out["pairs/wave/T"][b], out[f"pairs/{b}/T"])
        np.testing.assert_array_equal(out["pairs/wave/info"][b], out[f"pairs/{b}/info"])
        np.testing.assert_array_equal(out["pairs/wave/nll"][b], out[f"pairs/{b}/nll"])
        np.testing.assert_array_equal(out["pairs/wave/counts"][:, :, b], out[f"pairs/{b}/counts"])
        err = np.asarray(j_se3.log_se3(jnp.asarray(
            np.linalg.inv(_exp(twist)) @ out["pairs/wave/T"][b].astype(np.float64), jnp.float32)))
        assert np.abs(err).max() < 5e-3, (b, err)
    assert "does not divide over 2 ranks" in str(out["pairs/odd_batch_error"])


@pytest.mark.parametrize("pid,n", [(0, 1), (1, 3), (2, 3), (3, 4), (5, 8)])
def test_host_work_partition(pid, n):
    ref = j_distributed.HostWorkPartition(pid, n)
    port = t_distributed.HostWorkPartition(pid, n)
    for frames in (0, 1, 7, 100):
        assert port.frame_shard(frames) == ref.frame_shard(frames)
    assert [port.owns_keyframe(k) for k in range(20)] == [ref.owns_keyframe(k) for k in range(20)]
    assert port.local_items(list(range(17))) == ref.local_items(list(range(17)))


def test_host_work_partition_without_process_group():
    assert t_distributed.HostWorkPartition.current() == t_distributed.HostWorkPartition(0, 1)


def test_local_block_pads_and_splits():
    """4801 pixels over 3 ranks: 1601 columns each, the last two zero
    padding, the blocks in rank order make up the padded pack."""
    refpack = torch.arange(8 * 4801, dtype=torch.float32).reshape(8, 4801) + 1.0
    blocks = [
        t_mesh.local_block(refpack, t_mesh.Mesh(None, t_mesh.BATCH_AXIS, r, 3, torch.device("cpu")), 1)
        for r in range(3)
    ]
    assert [tuple(b.shape) for b in blocks] == [(8, 1601)] * 3
    assert all(b.is_contiguous() for b in blocks)
    joined = torch.cat(blocks, dim=1)
    assert torch.equal(joined[:, :4801], refpack)
    assert (joined[:, 4801:] == 0).all()


def test_shard_leading_axis():
    mesh = t_mesh.Mesh(None, t_mesh.BATCH_AXIS, 1, 2, torch.device("cpu"))
    tree = (torch.arange(4), None, (torch.arange(8).reshape(4, 2),))
    got = t_mesh.shard_leading_axis(tree, mesh)
    assert torch.equal(got[0], torch.tensor([2, 3])) and got[1] is None
    assert torch.equal(got[2][0], torch.tensor([[4, 5], [6, 7]]))
    with pytest.raises(ValueError, match="does not divide"):
        t_mesh.shard_leading_axis(torch.arange(3), mesh)
    assert t_mesh.replicated(tree, mesh) is tree


def test_no_mesh_or_rendezvous_without_setup(monkeypatch):
    """make_mesh needs an initialised process group; initialize needs a
    rendezvous (this checks both without initialising one)."""
    with pytest.raises(RuntimeError, match="no process group"):
        t_mesh.make_mesh()
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.delenv("MASTER_PORT", raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        t_distributed.initialize()


def test_sharded_bench_runs_on_cpu():
    """``tools/sharded_bench`` (phase 6's timing, alone in its process) on
    one pair and one round, on the CPU over gloo: both paths solve and
    report a time per iteration."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import json, torch; torch.set_num_threads(1)\n"
        "from dvo_slam_tpu_torch.tools import sharded_bench\n"
        "print(json.dumps(sharded_bench.bench(1, 1, device='cpu')))\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    (one,) = json.loads(proc.stdout.strip().splitlines()[-1])
    assert one["pairs"] == 1 and one["sharded_iterations"] > 0 and one["single_iterations"] > 0
    assert 0.0 < one["sharded_ms_per_iteration"] < 1e4 and 0.0 < one["single_ms_per_iteration"] < 1e4
