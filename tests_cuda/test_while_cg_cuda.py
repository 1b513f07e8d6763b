"""Block-CG on one card as one while-graph launch
(``pose_graph.solve_blocks_cg``, ``irls_graph.LevelGraphs.run_level`` with
the loop running while the carry's ``active`` is true).

On the 513- and 2,049-vertex loopy graphs of ``tools/cg_iteration_stats``
(one GN step's system, float64 on the card), at K = 1 and 8: x bit-equal
and k equal across the while graph, the host-polled chunk replays and the
eager loop; the while form reads nothing back (no host read of ``active``,
none at all without ``return_iterations``); starts whose condition
already fails (a zero right-hand side, one below the tolerance's floor, an
iteration cap of 0) end at k = 0 with x zero in every form.  ``set_while``
at both senses of its condition against its plain loop.  A CG chunk that
copies from the host: CUDA refuses the WHILE body, and the solve raises
with CUDA's text, the key and the captures' node types.
"""

import pytest
import torch

from dvo_slam_tpu_torch.models import irls_graph
from dvo_slam_tpu_torch.models import pose_graph as pg
from dvo_slam_tpu_torch.tools import cg_iteration_stats, graph_check

pytestmark = pytest.mark.cuda

SIZES = (512, 2048)
CAP = 8192
FORMS = {"while": dict(graphs=True, polled=False), "polled": dict(graphs=True, polled=True),
         "eager": dict(graphs=False)}


def _system(n):
    """One GN step's CG arguments on the loopy graph of n + 1 vertices."""
    g, _ = cg_iteration_stats.loopy_graph(n, 7)
    arrays = pg.GraphArrays(*(t.to("cuda") for t in g.to_arrays()))
    H_ii, H_ij, H_jj, b_i, b_j, _ = pg.edge_blocks(arrays)
    free = arrays.vertex_mask & ~arrays.fixed_mask
    b = pg._gradient(arrays, b_i, b_j)
    return (arrays.poses.shape[0], arrays.edge_i, arrays.edge_j, H_ii, H_ij, H_jj, -b, free)


@pytest.fixture(scope="module")
def systems():
    return {n: _system(n) for n in SIZES}


def _solve(args, form, chunk, iterations=CAP, **kwargs):
    with graph_check.loop_mode(**FORMS[form]):
        return pg.solve_blocks_cg(*args, iterations=iterations, chunk=chunk, **kwargs)


def _count_loop_reads(monkeypatch):
    reads = []
    read = pg._cg_read
    monkeypatch.setattr(pg, "_cg_read", lambda carry: reads.append(1) or read(carry))
    return reads


@pytest.mark.parametrize("chunk", [1, 8])
@pytest.mark.parametrize("size", SIZES)
def test_while_bit_equal_to_polled_and_eager(systems, size, chunk, monkeypatch):
    args = systems[size]
    want_x, want_k = _solve(args, "eager", chunk, return_iterations=True)
    assert want_k > 0
    for rep in range(2):  # the first solve of a key captures and builds, the second launches
        for form in ("polled", "while"):
            x, k = _solve(args, form, chunk, return_iterations=True)
            assert k == want_k and graph_check._same(x, want_x), (form, rep)
    reads = _count_loop_reads(monkeypatch)
    launches = irls_graph.while_counts.launches
    with graph_check.counting_reads() as host:
        x = _solve(args, "while", chunk)
    assert reads == [] and host == [], (reads, host)
    assert irls_graph.while_counts.launches == launches + 1
    assert graph_check._same(x, want_x)
    _solve(args, "polled", chunk)
    assert len(reads) == -(-want_k // chunk)  # host-polled: one read per chunk, none before


@pytest.mark.parametrize("chunk", [1, 8])
@pytest.mark.parametrize("start", ["zero", "below_floor", "no_iterations"])
def test_a_start_that_has_converged(systems, start, chunk, monkeypatch):
    n, *edges, rhs, free = systems[SIZES[0]]
    iterations = 0 if start == "no_iterations" else CAP
    if start != "no_iterations":
        rhs = torch.zeros_like(rhs) if start == "zero" else torch.full_like(rhs, 1e-24)
    args = (n, *edges, rhs, free)
    reads = _count_loop_reads(monkeypatch)
    for form in ("while", "polled", "eager"):
        x, k = _solve(args, form, chunk, iterations=iterations, return_iterations=True)
        assert k == 0 and not x.abs().max().item(), form
    assert len(reads) == 2  # one read each for the host-polled and eager forms' first chunk


def test_set_while_both_senses():
    rows = graph_check.set_while_check(torch.device("cuda", 0), steps=50)
    assert sorted({row["loop_on"] for row in rows}) == [False, True]
    for row in rows:
        assert row["abs_err"] == 0, row


def test_a_refused_build_raises_and_does_not_fall_back(systems, monkeypatch):
    """A CG chunk with an empty dot product (cuBLAS writes its zero from
    the host): CUDA refuses the WHILE body, and the solve raises with
    CUDA's text, the key and the captures' node types."""
    vdot = pg._vdot

    def with_empty_product(a, b):
        return vdot(a, b) + torch.dot(a.reshape(-1)[:0], b.reshape(-1)[:0])

    irls_graph.release()
    monkeypatch.setattr(pg, "_vdot", with_empty_product)
    launches = irls_graph.while_counts.launches
    with pytest.raises(RuntimeError) as info:
        _solve(systems[SIZES[0]], "while", 8)
    text = str(info.value)
    assert "building the CG loop's while graph failed" in text
    assert "cudaGraphInstantiate" in text and "'memcpy'" in text and "'cg'" in text
    assert irls_graph.while_counts.launches == launches
    monkeypatch.undo()
    irls_graph.release()
    assert irls_graph.WHILE_GRAPHS
