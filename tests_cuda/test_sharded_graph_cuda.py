"""The multi-rank device loops as CUDA graphs on the card: the
pixel-sharded IRLS level and block-CG, with their NCCL all-reduces
captured, as while graphs (the all-reduces inside the WHILE body) and as
host-polled replays, against the same loops run eagerly.

Every rank is a child process (process groups are never initialised in
the test process) that rendezvouses on a ``file://`` store in
``tmp_path`` and is joined with its own timeout, every rank killed when
one hangs:

- one NCCL rank: the group's probe at ``initialize`` admits the while
  form (``irls_graph.group_forms``); the pixel-sharded matcher on two
  640x480 pairs at ``benchmark_config().tracker`` as while graphs and as
  host-polled graphs at K = 1-4, every level's carry and iterations and
  the result bit-equal to the eager loop (``irls_graph.CUDA_GRAPHS``
  off) at the same K and to K = 1; the while form reads ``done`` 0 times;
  each of the three sharded kernels and the two step kernels launched
  once per executed step (the while form's counts folded in from the
  card); the group's keys in the
  cache; then ``shutdown()`` drops them, the group's form and no other
  key, ``initialize()`` starts a new generation, and the first pair
  solves to the same bits.  Block-CG on the 513-vertex loopy graph of
  ``tools/cg_iteration_stats`` as a while graph and host-polled at K = 1,
  8 and 32 against the eager loop (x bit-equal, k equal), and
  ``distributed_gauss_newton_cg`` on the one-rank mesh, its CG loop's
  all-reduce in the WHILE body, bit-equal to its host-polled and eager
  runs;
- two NCCL ranks, one card each, where the machine has two cards: the
  ranks agree, and each matches its own eager run;
- two gloo ranks on one card: the sharded level runs its chunks eagerly,
  by the group's backend, and builds no graph.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 600

_CHILD = r"""
import json, sys
import numpy as np
import torch
from dvo_slam_tpu_torch import benchmark_config
from dvo_slam_tpu_torch.models import dense_tracker, irls_graph, pose_graph as pg
from dvo_slam_tpu_torch.odometry import build_frame, render_sequence, upload_sequence
from dvo_slam_tpu_torch.ops import fused_kernels, irls_step
from dvo_slam_tpu_torch.ops.camera import TUM_FR1
from dvo_slam_tpu_torch.parallel import distributed, distributed_ba, mesh as mesh_lib
from dvo_slam_tpu_torch.parallel import sharded_alignment
from dvo_slam_tpu_torch.tools import cg_iteration_stats, driver_launches, graph_check
from dvo_slam_tpu_torch.utils import synthetic

work, world, rank, backend = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
torch.backends.cuda.matmul.allow_tf32 = False
device = torch.device("cuda", 0 if backend == "gloo" else rank)
cfg = benchmark_config().tracker
poses = synthetic.circular_trajectory(100, radius=0.05, rot_amplitude=0.02)
d_i, d_d = upload_sequence(*render_sequence(poses[:3], (480, 640), TUM_FR1), device)
frames = [build_frame(cfg, d_i[k], d_d[k]) for k in range(3)]
eye = torch.eye(4, device=device)
COUNTERS = (fused_kernels.warp_fused_partials_cuda, fused_kernels.sharded_loglik_cuda,
            fused_kernels.sharded_tail_cuda, irls_step.step_head_cuda, irls_step.step_tail_cuda)
report = {"problems": []}
problem = report["problems"].append

def start(name):
    distributed.initialize(init_method=f"file://{work}/{name}{world}", world_size=world,
                           rank=rank, backend=backend, device=device)
    return mesh_lib.make_mesh(world, device=device)

FORMS = {"while": dict(graphs=True, polled=False), "polled": dict(graphs=True, polled=True),
         "eager": dict(graphs=False)}

def solve(mesh, form, chunk):
    run = sharded_alignment.make_pixel_sharded_matcher(cfg, TUM_FR1, mesh)
    driver_launches.reset_counts()
    irls_step.step_head_cuda.launches = irls_step.step_tail_cuda.launches = 0
    with graph_check.loop_mode(sharded=chunk, **FORMS[form]), \
            graph_check.sharded_recording() as levels:
        results = [run(frames[k], frames[k + 1], eye) for k in range(2)]
    irls_graph.fold_counts()
    launches = [c.launches for c in COUNTERS]
    steps = sum(graph_check.counts([s], chunk)[1] for _, s, _ in levels)
    if launches != [steps] * len(COUNTERS):
        problem(f"K={chunk} {form}: launches {launches} != executed steps {steps}")
    reads = dense_tracker.read_done.calls
    if form == "while" and backend == "nccl" and reads:
        problem(f"K={chunk}: the while form read done {reads} times")
    return results, levels

def result_bits(results):
    return [t.cpu().numpy().tobytes() for r in results
            for t in (r.transformation, r.information, r.neg_log_likelihood)]

def sharded_keys():
    return [k for k in irls_graph._cache if k[1] == "sharded"]

mesh = start("first")
group = irls_graph.group_key()
forms = irls_graph.group_forms()
report["group_form"] = irls_graph.stats()["group_forms"].get(repr(group))
if backend == "nccl" and (group not in forms or forms[group].form != "while"):
    problem(f"the group's probe did not admit the while form: {report['group_form']}")
if backend == "gloo" and forms:
    problem(f"gloo probed a form: {forms}")
report["probe_census"] = forms[group].census if group in forms else None
first = None
for chunk in (1, 2, 3, 4):
    runs = {form: solve(mesh, form, chunk) for form in ("while", "polled", "eager")}
    graphed, g_levels = runs["while"]
    if first is None:
        first, first_levels = graphed, g_levels
    for name, (got, got_levels), want_levels in (
            ("polled vs eager", runs["polled"], runs["eager"][1]),
            ("while vs eager", runs["while"], runs["eager"][1]),
            ("while vs K=1", runs["while"], first_levels)):
        diff = graph_check.differences(got_levels, want_levels)
        if diff:
            problem(f"K={chunk} {name}: {diff[:5]}")
    if any(result_bits(r) != result_bits(first) for r, _ in runs.values()):
        problem(f"K={chunk}: results differ")
keys = sharded_keys()
report["sharded_keys"] = len(keys)
if backend == "nccl" and not (keys and all(group in k for k in keys)):
    problem(f"no graph key of the group: {keys}")
if backend == "gloo" and irls_graph.stats()["keys"]:
    problem(f"gloo built graphs: {list(irls_graph._cache)}")
report["iterations"] = [int(s.iterations) for _, s, _ in first_levels]

if backend == "nccl":
    # block-CG: one solve under graphs and eagerly, then distributed GN-CG
    g, _ = cg_iteration_stats.loopy_graph(512, 7)
    arrays = pg.GraphArrays(*(t.to(device) for t in g.to_arrays()))
    H_ii, H_ij, H_jj, b_i, b_j, _ = pg.edge_blocks(arrays)
    free = arrays.vertex_mask & ~arrays.fixed_mask
    b = pg._gradient(arrays, b_i, b_j)
    args = (arrays.poses.shape[0], arrays.edge_i, arrays.edge_j, H_ii, H_ij, H_jj, -b, free)
    cg = {}
    for chunk in (1, 8, 32):
        for form in FORMS:
            with graph_check.loop_mode(**FORMS[form]):
                cg[chunk, form] = pg.solve_blocks_cg(*args, iterations=8192,
                                                     return_iterations=True, chunk=chunk)
    ref_x, ref_k = cg[1, "eager"]
    for (chunk, form), (x, k) in cg.items():
        if k != ref_k or not torch.equal(x, ref_x):
            problem(f"CG K={chunk} {form}: k {k} vs {ref_k}, bit-equal {torch.equal(x, ref_x)}")
    report["cg_iterations"] = ref_k
    gn = {}
    for form in FORMS:
        with graph_check.loop_mode(**FORMS[form]):
            out, hist = distributed_ba.distributed_gauss_newton_cg(arrays, mesh, iterations=2,
                                                                   cg_iterations=8192)
        gn[form] = (out.poses, hist)
    for form in ("while", "polled"):
        if not (torch.equal(gn[form][0], gn["eager"][0]) and torch.equal(gn[form][1], gn["eager"][1])):
            problem(f"distributed GN-CG {form} differs from eager")
    if not [k for k in irls_graph._cache if k[1] == "cg" and group in k]:
        problem("no CG graph key of the group")

others = [k for k in irls_graph._cache if group not in k]
distributed.shutdown()
if any(group in k for k in irls_graph._cache) or [k for k in irls_graph._cache] != others:
    problem("shutdown left the group's keys or dropped others")
if group in irls_graph.group_forms():
    problem("shutdown left the group's form")
mesh = start("again")
if irls_graph.group_key() == group:
    problem("initialize did not start a new generation")
again, _ = solve(mesh, "while", 1)
if result_bits(again[:1]) != result_bits(first[:1]):
    problem("the solve after shutdown and initialize differs")
distributed.shutdown()
irls_graph.release()
with open(f"{work}/report_{backend}_w{world}_r{rank}.json", "w") as f:
    json.dump(report, f)
np.savez(f"{work}/out_{backend}_w{world}_r{rank}.npz",
         T=np.stack([r.transformation.cpu().numpy() for r in first]))
"""


def _run_ranks(work, world, backend):
    from dvo_slam_tpu_torch import _build

    _build.load_library("fused_stats")  # build once, before the ranks load it
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("TORCH_NCCL_BLOCKING_WAIT", None)
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _CHILD, str(work), str(world), str(rank), backend],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for rank in range(world)
    ]
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
    import json

    reports = [json.loads((work / f"report_{backend}_w{world}_r{rank}.json").read_text())
               for rank in range(world)]
    for rank, report in enumerate(reports):
        assert not report["problems"], (rank, report["problems"])
    outs = [np.load(work / f"out_{backend}_w{world}_r{rank}.npz") for rank in range(world)]
    return reports, outs


def test_one_nccl_rank_graphs_equal_eager(tmp_path):
    reports, _ = _run_ranks(tmp_path, 1, "nccl")
    assert reports[0]["sharded_keys"] > 0 and reports[0]["cg_iterations"] > 0


def test_two_nccl_ranks(tmp_path):
    import torch

    if torch.cuda.device_count() < 2:
        pytest.skip("two NCCL ranks need two cards (NCCL refuses two ranks on one device)")
    reports, outs = _run_ranks(tmp_path, 2, "nccl")
    np.testing.assert_array_equal(outs[0]["T"], outs[1]["T"])
    assert reports[0]["iterations"] == reports[1]["iterations"]


def test_gloo_on_the_card_runs_eagerly(tmp_path):
    reports, outs = _run_ranks(tmp_path, 2, "gloo")
    assert reports[0]["sharded_keys"] == 0
    np.testing.assert_array_equal(outs[0]["T"], outs[1]["T"])
