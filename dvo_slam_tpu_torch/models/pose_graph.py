"""SE(3) pose-graph optimization (port of
``dvo_slam_tpu.models.pose_graph``: the ``PoseGraph`` container and its
four solver routes).

The reference delegates graph optimization to g2o: the per-keyframe mini
graph uses Levenberg-Marquardt with CSparse (dvo_slam/src/local_map.cpp:
57-90, 208-213) and the global keyframe graph Dogleg with CSparse and
Cauchy robust kernels of width 5 on loop-closure edges
(dvo_slam/src/keyframe_graph.cpp:126-142, 840-853).  Vertices are a dense
[N, 4, 4] pose array and edges are index arrays with stacked [E, 4, 4]
measurements and [E, 6, 6] information matrices, an active mask, a
Cauchy-robust flag and a level.  One iteration computes every edge's
residual, Jacobians and 6x6 blocks and solves the normal equations by one
of four routes:

* ``dense``: the blocks scattered into a dense [6N, 6N] system, Cholesky;
* ``cg``: block-Jacobi preconditioned conjugate gradients on the per-edge
  blocks (O(E) memory);
* ``schur``: degree-2 chains eliminated by block-tridiagonal sweeps, one
  dense Cholesky of the reduced separator system;
* ``sparse``: the gauged system assembled in ``scipy.sparse`` and solved
  exactly (the reference's g2o+CSparse architecture).

Where the solves run: on the host CPU, in float64 torch tensors.  This is
the branch the reference takes whenever its default backend is an
accelerator (``pose_graph.py:44-67, 1706-1721``: graph solves pinned to the
host CPU and promoted to float64), as the reference's g2o+CSparse runs on
the host while the tracker owns the card.  The placement follows the
reference's design; it is not a fallback.  The reference's ``lax.scan`` and
``lax.while_loop`` loops are Python loops here.  The compacted subgraph and
the chain structure are not padded to a power of two: that padding keeps
XLA's compile set closed (``parallel/distributed_ba.pad_chain_structure``
pads the chains to a multiple of the world size only).  The solvers'
tensors live on their inputs' device, so the distributed solvers of
``parallel/distributed_ba`` run these functions in float64 on the card.

Conventions: vertex update is right-multiplicative (T <- T exp(xi)); edge
residual r = log(T_meas^{-1} T_i^{-1} T_j), so a perfect edge has T_meas =
T_i^{-1} T_j (g2o EdgeSE3, local_map.cpp:103-118).
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops import se3
from . import irls_graph

CAUCHY_DELTA = 5.0  # reference: keyframe_graph.cpp:845 (setDelta(5))
GAUGE_DAMPING = 1e-6  # numerical-safety floor of every solver's damping
SOLVERS = ("dense", "cg", "schur", "sparse")


class GraphArrays(NamedTuple):
    """A pose graph as tensors (float64 on the CPU for a solve)."""

    poses: torch.Tensor  # [N, 4, 4]
    vertex_mask: torch.Tensor  # [N] bool, allocated vertices
    fixed_mask: torch.Tensor  # [N] bool, gauge-fixed vertices
    edge_i: torch.Tensor  # [E] int64
    edge_j: torch.Tensor  # [E] int64
    measurements: torch.Tensor  # [E, 4, 4]
    information: torch.Tensor  # [E, 6, 6]
    edge_mask: torch.Tensor  # [E] bool, active edges
    robust: torch.Tensor  # [E] bool, Cauchy-robustified edges


def edge_residuals(graph: GraphArrays):
    """Per-edge residual r = log(T_m^{-1} T_i^{-1} T_j) and chi2 = r^T O r."""
    Ti = graph.poses[graph.edge_i]
    Tj = graph.poses[graph.edge_j]
    B = se3.inverse(Ti) @ Tj
    X = se3.inverse(graph.measurements) @ B
    r = se3.log_se3(X)
    chi2 = torch.einsum("ei,eij,ej->e", r, graph.information, r)
    return r, B, chi2


def cauchy_weights(chi2, robust, delta: float = CAUCHY_DELTA):
    """Cauchy robust-kernel weight rho'(s) = 1 / (1 + s/delta^2) on
    robustified edges, 1 elsewhere."""
    w = 1.0 / (1.0 + chi2 / (delta * delta))
    return torch.where(robust, w, torch.ones_like(w))


def _edge_jacobians(r, B):
    """J_j = Jr^{-1}(r), J_i = -Jr^{-1}(r) Ad(B^{-1}) for right-mult updates."""
    jr_inv = se3.right_jacobian_inverse_approx(r)
    adj_b_inv = se3.adjoint(se3.inverse(B))
    return -(jr_inv @ adj_b_inv), jr_inv


def assemble_blocks(n, ei, ej, H_ii, H_ij, H_jj, b_i, b_j):
    """Scatter per-edge blocks into raw dense normal equations
    ([N, N, 6, 6], [N, 6]), before the gauge."""
    H = torch.zeros((n, n, 6, 6), dtype=H_ii.dtype, device=H_ii.device)
    H.index_put_((ei, ei), H_ii, accumulate=True)
    H.index_put_((ei, ej), H_ij, accumulate=True)
    H.index_put_((ej, ei), H_ij.transpose(-1, -2), accumulate=True)
    H.index_put_((ej, ej), H_jj, accumulate=True)
    b = torch.zeros((n, 6), dtype=b_i.dtype, device=b_i.device)
    _scatter_add(b, ei, b_i)
    _scatter_add(b, ej, b_j)
    return H, b


def apply_gauge(H, b, free, damping=GAUGE_DAMPING):
    """Zero the rows and columns of fixed vertices, identity on their
    diagonal, plus Levenberg damping; flatten to ([6N, 6N], [6N]).  The LM
    loop passes its lambda (plus the floor) as ``damping``."""
    n = H.shape[0]
    freef = free.to(H.dtype)
    H = H * freef[:, None, None, None] * freef[None, :, None, None]
    eye = torch.eye(6, dtype=H.dtype, device=H.device)
    idx = torch.arange(n, device=H.device)
    H[idx, idx] = H[idx, idx] + (1.0 - freef)[:, None, None] * eye
    H[idx, idx] = H[idx, idx] + damping * eye
    b = b * freef[:, None]
    return H.permute(0, 2, 1, 3).reshape(n * 6, n * 6), b.reshape(n * 6)


def _assemble_dense(n, ei, ej, H_ii, H_ij, H_jj, b_i, b_j, free, damping=GAUGE_DAMPING):
    H, b = assemble_blocks(n, ei, ej, H_ii, H_ij, H_jj, b_i, b_j)
    return apply_gauge(H, b, free, damping)


def _cholesky(A):
    """Lower Cholesky factors of [..., k, k]; a factorization that fails
    gives NaN (per matrix), as the reference's does."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[..., None, None], L, torch.full_like(L, float("nan")))


def _solve_scaled(H, b):
    """Cholesky solve with symmetric Jacobi scaling."""
    d = torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-12))
    d_inv = 1.0 / d
    Hs = H * d_inv[:, None] * d_inv[None, :]
    bs = b * d_inv
    L = _cholesky(Hs + 1e-9 * torch.eye(H.shape[0], dtype=H.dtype, device=H.device))
    y = torch.cholesky_solve(bs[:, None], L)[:, 0]
    return y * d_inv


def edge_blocks(graph: GraphArrays, delta: float = CAUCHY_DELTA):
    """Per-edge 6x6 Hessian blocks and 6-vector gradient blocks:
    (H_ii, H_ij, H_jj, b_i, b_j, chi2) over [E, ...]."""
    r, B, chi2 = edge_residuals(graph)
    w = cauchy_weights(chi2, graph.robust, delta) * graph.edge_mask
    W = w[:, None, None] * graph.information  # [E, 6, 6]

    J_i, J_j = _edge_jacobians(r, B)
    WJi = W @ J_i
    WJj = W @ J_j
    H_ii = J_i.transpose(-1, -2) @ WJi
    H_ij = J_i.transpose(-1, -2) @ WJj
    H_jj = J_j.transpose(-1, -2) @ WJj
    Wr = torch.einsum("eab,eb->ea", W, r)
    b_i = torch.einsum("eba,eb->ea", J_i, Wr)
    b_j = torch.einsum("eba,eb->ea", J_j, Wr)
    return H_ii, H_ij, H_jj, b_i, b_j, chi2


def _free(graph: GraphArrays):
    return graph.vertex_mask & ~graph.fixed_mask


def _masked_sum(values, mask):
    return torch.sum(torch.where(mask, values, torch.zeros_like(values)))


def _gradient(graph: GraphArrays, b_i, b_j):
    """The per-vertex gradient [N, 6] of the per-edge blocks."""
    b = torch.zeros((graph.poses.shape[0], 6), dtype=b_i.dtype, device=b_i.device)
    _scatter_add(b, graph.edge_i, b_i)
    _scatter_add(b, graph.edge_j, b_j)
    return b


def _vdot(a, b):
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _scatter_add(out, index, src):
    """``out[index[e]] += src[e]`` along dim 0, in place.  On the CPU
    ``index_add_``, which adds in edge order.  On the card the sort-based
    ``index_put_(accumulate=True)``: it adds each row's entries in edge
    order too, where ``index_add_``'s atomics add them in whatever order
    they land, so that two runs of a solve (a CUDA graph and its eager
    loop) give the same bits."""
    if out.is_cuda:
        return out.index_put_((index,), src, accumulate=True)
    return out.index_add_(0, index, src)


# ------------------------------------------------------------ block CG


def block_diag_preconditioner(n, ei, ej, H_ii, H_jj, free, dtype, damping=GAUGE_DAMPING,
                              all_reduce=None):
    """Cholesky factors of the block-Jacobi preconditioner: the per-vertex
    6x6 diagonal blocks of the gauged system (each edge's diagonal
    contributions plus damping, identity on fixed vertices).  With
    ``all_reduce`` (a function that sums a tensor over the ranks) the
    edges are this rank's shard and their accumulations are summed before
    the gauge: one [N, 6, 6] collective."""
    eye = torch.eye(6, dtype=dtype, device=H_ii.device)
    freef = free.to(dtype)
    D = torch.zeros((n, 6, 6), dtype=dtype, device=H_ii.device)
    _scatter_add(D, ei, H_ii)
    _scatter_add(D, ej, H_jj)
    if all_reduce is not None:
        D = all_reduce(D)
    D = D * freef[:, None, None] + (1.0 - freef)[:, None, None] * eye
    D = D + damping * eye
    return _cholesky(D)


def edge_matvec_partial(ei, ej, H_ii, H_ij, H_jj, free, x):
    """The edges' part P_free H_edges P_free @ x, without the gauge terms
    (the unit of work an edge shard computes before the reduction)."""
    freef = free.to(x.dtype)[:, None]
    xf = x * freef
    xi = xf[ei]
    xj = xf[ej]
    yi = torch.einsum("eab,eb->ea", H_ii, xi) + torch.einsum("eab,eb->ea", H_ij, xj)
    yj = torch.einsum("eba,eb->ea", H_ij, xi) + torch.einsum("eab,eb->ea", H_jj, xj)
    y = torch.zeros_like(x)
    _scatter_add(y, ei, yi)
    _scatter_add(y, ej, yj)
    return y * freef


def _gauge_terms(x, free, damping=GAUGE_DAMPING):
    """Identity rows for fixed vertices plus Levenberg damping on free rows
    (matching :func:`apply_gauge`)."""
    freef = free.to(x.dtype)[:, None]
    return damping * x * freef + x * (1.0 - freef)


def edge_matvec(ei, ej, H_ii, H_ij, H_jj, free, x, damping=GAUGE_DAMPING):
    """y = H_gauged @ x without forming H: gather the two endpoint blocks of
    x per edge, apply the 6x6 blocks, scatter-add the results (the
    block-sparse product whose per-edge unit matches the reference's
    CSparse structure, keyframe_graph.cpp:126-142)."""
    return edge_matvec_partial(ei, ej, H_ii, H_ij, H_jj, free, x) + _gauge_terms(x, free, damping)


# K, the CG steps per chunk on the card: in the while form a set_while run
# between two chunks, in the host-polled form a host read of ``active`` (on
# the CPU: 1, one read per iteration as the keyframe graph's host solves
# always did).  PERF.md §6: K = 8 ran fastest in the sweeps on the card.
CG_CHUNK_STEPS = 8


def _precond(L, r):
    """The block-Jacobi preconditioner's solve (L L^T)^-1 r per vertex, as
    the reference's two triangular solves (``torch.cholesky_solve`` goes
    through MAGMA on the card, which a CUDA graph cannot capture)."""
    y = torch.linalg.solve_triangular(L, r[..., None], upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)[..., 0]


def _live_edges(ei, ej, H_ii, H_ij, H_jj):
    """The edges with a nonzero entry in one of their three blocks (a NaN
    counts as nonzero), in their order."""
    def nonzero(H):
        return (H != 0).flatten(1).any(dim=1)

    live = nonzero(H_ii) | nonzero(H_ij) | nonzero(H_jj)
    return tuple(t[live] for t in (ei, ej, H_ii, H_ij, H_jj))


def _cg_active(k, r, iterations: int, stop2):
    """The reference's loop condition, on the device: (k < iterations) and
    |r|^2 > stop2."""
    return (k < iterations) & (_vdot(r, r) > stop2)


_ACTIVE = 6  # the carry's ``active`` flag: (x, r, z, p, rz, k, active)


def _cg_chunk(matvec, L, carry, steps: int, iterations: int, stop2):
    """``steps`` CG iterations from ``carry`` = (x, r, z, p, rz, k,
    active); a step taken where ``active`` is false leaves the carry as it
    was, so K steps then one read give the result of K = 1, and a chunk
    from a carry whose condition already failed is inert."""
    x, r, z, p, rz, k, active = carry
    for _ in range(steps):
        Hp = matvec(p)
        alpha = rz / torch.clamp(_vdot(p, Hp), min=1e-30)
        x_new = x + alpha * p
        r_new = r - alpha * Hp
        z_new = _precond(L, r_new)
        rz_new = _vdot(r_new, z_new)
        beta = rz_new / torch.clamp(rz, min=1e-30)
        p_new = z_new + beta * p
        x, r, z, p, rz, k = (torch.where(active, new, old) for new, old in zip(
            (x_new, r_new, z_new, p_new, rz_new, k + 1), (x, r, z, p, rz, k)))
        active = _cg_active(k, r, iterations, stop2)
    return x, r, z, p, rz, k, active


def solve_blocks_cg(
    n, ei, ej, H_ii, H_ij, H_jj, rhs, free, iterations: int = 100, tol: float = 1e-6,
    damping=GAUGE_DAMPING, return_iterations: bool = False, all_reduce=None,
    chunk: Optional[int] = None,
):
    """Preconditioned conjugate gradients on the block-sparse gauged normal
    equations ``rhs`` [N, 6] (the replacement for the dense [6N, 6N]
    Cholesky on large graphs; O(E) per iteration).  Stops after
    ``iterations`` or once |r| <= tol |rhs|.

    The reference's ``lax.while_loop`` carries (x, r, z, p, rz, k) and its
    condition on the device, and so does this loop: it runs in chunks of K
    steps (``chunk``; by default ``CG_CHUNK_STEPS`` on the card, 1 on the
    CPU), each step inert once the condition fails, so every K gives the
    K = 1 result bit for bit, and a first chunk from a start whose
    condition already fails leaves it as it is (k = 0).  On the card the
    whole loop is one launch of a CUDA graph whose conditional WHILE node
    repeats the chunk while ``active`` holds (``irls_graph.run_loop``), the
    reduction's all-reduce captured in it where it is a NCCL group's (the
    reduction names its group in ``group``; one that does not runs
    eagerly): nothing is read back from the start to the result.  The
    form is ``irls_graph.loop_form``'s: the host-polled replays
    (``irls_graph.WHILE_GRAPHS`` off, or a group whose probe was refused)
    and the eager loop (the CPU, ``irls_graph.CUDA_GRAPHS`` off, gloo)
    read ``active`` once per chunk.  ``k`` is read once, at the end,
    where ``return_iterations`` asks for it.

    With ``all_reduce`` (a function that sums a tensor over the ranks) the
    edge arrays are this rank's shard and ``rhs`` is already summed: each
    iteration sums ONE [N, 6] partial product over the ranks (the
    reference's ``axis_name`` form), and every rank holds the same
    iterate, so all take the same stopping decision.

    Edges whose three blocks are all zero (the unused slots of a graph's
    edge storage, masked out by ``edge_blocks``) add nothing to any sum and
    are dropped first (``_live_edges``, one host read per solve, which
    stays in the while form: the live edges set the chunk's shapes and so
    its graph key): on the card they would all land on one vertex, whose
    contributions the deterministic scatter (``_scatter_add``) adds one
    after another."""
    dtype = rhs.dtype
    rhs = rhs * free.to(dtype)[:, None]
    ei, ej, H_ii, H_ij, H_jj = _live_edges(ei, ej, H_ii, H_ij, H_jj)
    L = block_diag_preconditioner(n, ei, ej, H_ii, H_jj, free, dtype, damping, all_reduce)
    if chunk is None:
        chunk = CG_CHUNK_STEPS if rhs.is_cuda else 1
    stop2 = tol * tol * torch.clamp(_vdot(rhs, rhs), min=1e-30)
    r = rhs  # b - H @ 0
    z = _precond(L, r)
    k = torch.zeros((), dtype=torch.int64, device=rhs.device)
    carry = (torch.zeros_like(rhs), r, z, z, _vdot(r, z), k, _cg_active(k, r, iterations, stop2))

    def matvec_on(ei, ej, H_ii, H_ij, H_jj, free):
        if all_reduce is None:
            return lambda v: edge_matvec(ei, ej, H_ii, H_ij, H_jj, free, v, damping)

        def matvec(v):
            part = edge_matvec_partial(ei, ej, H_ii, H_ij, H_jj, free, v)
            return all_reduce(part) + _gauge_terms(v, free, damping)

        return matvec

    edges = (ei, ej, H_ii, H_ij, H_jj, free)
    static = edges + (L, stop2) + carry
    solve = len(edges)  # static[solve]: L; static[solve + 1]: stop2

    def program(static, state, into=None):
        start = static[solve + 2:] if state is None else state
        return _cg_chunk(matvec_on(*static[:solve]), static[solve], start, chunk, iterations,
                         static[solve + 1])

    group = () if all_reduce is None else getattr(all_reduce, "group", irls_graph.UNNAMED)
    form, part = irls_graph.loop_form(rhs.device, group)
    key = ("cg", part, chunk, iterations, damping,
           tuple((tuple(t.shape), t.dtype) for t in static))
    carry = irls_graph.run_loop(form, program, static, key, _ACTIVE, _cg_read, loop_on=True)
    if return_iterations:
        return carry[0], int(carry[5])
    return carry[0]


def _cg_read(carry) -> bool:
    """The eager and host-polled loops' one host read per chunk: whether
    the loop's condition still holds."""
    return bool(carry[_ACTIVE])


# ------------------------------------------------------------ Schur chains


class ChainStructure(NamedTuple):
    """Host (NumPy) elimination structure of the Schur chain solver.

    The dense final pass (keyframe_graph.cpp:257-281, all odometry vertices
    included) is dominated by degree-2 chains.  Eliminating them by
    block-tridiagonal factorization reduces the system exactly onto the
    separator vertices (keyframes, loop-closure endpoints): the
    Schur-complement solve of sparse SLAM solvers."""

    sep_ids: np.ndarray  # [S] global vertex index per separator
    sep_edge: np.ndarray  # [Es] edges with both endpoints separators
    sep_edge_a: np.ndarray  # [Es] dense sep index of the edge_i endpoint
    sep_edge_b: np.ndarray  # [Es] dense sep index of the edge_j endpoint
    seg_edges: np.ndarray  # [G, K+1] edge ids along each chain
    seg_flip: np.ndarray  # [G, K+1] bool, stored edge runs Q->P
    seg_len: np.ndarray  # [G] interior vertex count k (>= 1)
    seg_a: np.ndarray  # [G] dense sep index of the chain head
    seg_b: np.ndarray  # [G] dense sep index of the chain tail
    seg_vert: np.ndarray  # [G, K] global interior vertex ids


def chain_partition(n, ei, ej, active, allocated, free) -> Optional[ChainStructure]:
    """Split allocated vertices into degree-2 interior chains and
    separators; None when the graph has no eliminable chain.

    Separators are: fixed vertices, any vertex of degree != 2, self-loop
    endpoints, and one demoted vertex per pure interior cycle (a ring of
    degree-2 vertices needs an anchor to cut it into one open chain)."""
    ei = np.asarray(ei)
    ej = np.asarray(ej)
    active = np.asarray(active)
    allocated = np.asarray(allocated)
    free = np.asarray(free)
    deg = np.zeros(n, np.int64)
    adj = [[] for _ in range(n)]
    forced = np.zeros(n, bool)
    for e in np.nonzero(active)[0]:
        i, j = int(ei[e]), int(ej[e])
        if i == j:
            forced[i] = True
            continue
        deg[i] += 1
        deg[j] += 1
        adj[i].append((int(e), j))
        adj[j].append((int(e), i))
    interior = allocated & free & (deg == 2) & ~forced
    if not interior.any():
        return None
    used = np.zeros(len(ei), bool)
    segments = []  # (sep_a, sep_b, [interior verts], [edges])
    sep_edges = []

    def walk(e0, v0):
        path_e = [e0]
        path_v = []
        used[e0] = True
        prev_e, cur = e0, v0
        while interior[cur]:
            path_v.append(cur)
            (ea, oa), (eb, ob) = adj[cur]
            ne, nv = (eb, ob) if ea == prev_e else (ea, oa)
            used[ne] = True
            path_e.append(ne)
            prev_e, cur = ne, nv
        return path_v, cur, path_e

    def sweep_from(s):
        for e0, v0 in adj[s]:
            if used[e0]:
                continue
            if not interior[v0]:
                used[e0] = True
                sep_edges.append(e0)
                continue
            path_v, end, path_e = walk(e0, v0)
            segments.append((s, end, path_v, path_e))

    for s in range(n):
        if not allocated[s] or interior[s]:
            continue
        sweep_from(s)
    # pure interior cycles: both edges of some interior vertex are still
    # unused; demote it to a separator and cut the ring there (a == b)
    for v in range(n):
        if interior[v] and not any(used[e] for e, _ in adj[v]):
            interior[v] = False
            sweep_from(v)
    for e in np.nonzero(active)[0]:  # self-loop edges
        if int(ei[e]) == int(ej[e]):
            sep_edges.append(int(e))
    if not segments:
        return None

    sep_list = [v for v in range(n) if allocated[v] and not interior[v]]
    sep_of = np.full(n, -1, np.int64)
    sep_of[sep_list] = np.arange(len(sep_list))
    g_count = len(segments)
    k_max = max(len(s[2]) for s in segments)
    seg_edges = np.zeros((g_count, k_max + 1), np.int64)
    seg_flip = np.zeros((g_count, k_max + 1), bool)
    seg_len = np.zeros(g_count, np.int64)
    seg_a = np.zeros(g_count, np.int64)
    seg_b = np.zeros(g_count, np.int64)
    seg_vert = np.zeros((g_count, k_max), np.int64)
    for gidx, (sa, sb, verts, edges) in enumerate(segments):
        k = len(verts)
        seg_len[gidx] = k
        seg_a[gidx] = sep_of[sa]
        seg_b[gidx] = sep_of[sb]
        seg_vert[gidx, :k] = verts
        order = [sa] + verts  # P endpoint of edge t along the walk
        for t, e in enumerate(edges):
            seg_edges[gidx, t] = e
            seg_flip[gidx, t] = int(ei[e]) != order[t]
    se = np.asarray(sorted(set(sep_edges)), np.int64)
    return ChainStructure(
        sep_ids=np.asarray(sep_list, np.int64),
        sep_edge=se,
        sep_edge_a=sep_of[ei[se]].astype(np.int64),
        sep_edge_b=sep_of[ej[se]].astype(np.int64),
        seg_edges=seg_edges,
        seg_flip=seg_flip,
        seg_len=seg_len,
        seg_a=seg_a,
        seg_b=seg_b,
        seg_vert=seg_vert,
    )


def _spd_solve(d, r):
    """Batched SPD block solve through Cholesky."""
    return torch.cholesky_solve(r, _cholesky(d))


def schur_chain_solve(struct: ChainStructure, n, H_ii, H_ij, H_jj, b, free,
                      damping=GAUGE_DAMPING, all_reduce=None):
    """Exact direct solve of the gauged normal equations H dx = -b by chain
    elimination: a forward and a backward block-tridiagonal sweep over every
    chain at once (6x6 solves, 13 right-hand sides: the couplings to both
    end separators and the gradient) reduce the system onto the separators;
    one dense Cholesky solves the reduced system; the chains' updates are
    back-substituted from the same sweep columns.  Gauge and damping as
    :func:`apply_gauge`.

    Zero-length segments (``seg_len == 0``, the padding of
    ``pad_chain_structure``) contribute nothing.  With ``all_reduce`` (a
    function that sums a tensor over the ranks) the segment arrays are this
    rank's shard: each rank eliminates its own chains, the reduced
    [S, S, 6, 6] system and its right-hand side are summed over the ranks
    (the reference's ``axis_name`` form), the small solve runs on every
    rank, and the back-substituted chain updates are summed once as an
    [N, 6] tensor."""
    dtype, device = b.dtype, b.device
    eye = torch.eye(6, dtype=dtype, device=device)
    freef = free.to(dtype)
    rhs = -b * freef[:, None]
    as_long = lambda a: torch.from_numpy(np.asarray(a, np.int64)).to(device)  # noqa: E731
    sep_ids, seg_a, seg_b = as_long(struct.sep_ids), as_long(struct.seg_a), as_long(struct.seg_b)
    seg_len, seg_vert = as_long(struct.seg_len), as_long(struct.seg_vert)
    s_count = sep_ids.shape[0]
    g_count, kp1 = struct.seg_edges.shape
    k_max = kp1 - 1
    rows = torch.arange(g_count, device=device)
    segf = (seg_len > 0).to(dtype)  # padding-segment mask

    e = as_long(struct.seg_edges)
    flip = torch.from_numpy(np.asarray(struct.seg_flip)).to(device)[..., None, None]
    Hii_e, Hij_e, Hjj_e = H_ii[e], H_ij[e], H_jj[e]
    Dp = torch.where(flip, Hjj_e, Hii_e)  # diag block on the earlier endpoint
    Dq = torch.where(flip, Hii_e, Hjj_e)  # diag block on the later endpoint
    U = torch.where(flip, Hij_e.transpose(-1, -2), Hij_e)  # H(P, Q) along the walk

    tpos = torch.arange(k_max, device=device)
    valid_t = tpos[None, :] < seg_len[:, None]  # [G, K]
    last = torch.clamp(seg_len - 1, min=0)
    # interior tridiagonal: D_t = Dq(edge t) + Dp(edge t+1) + damping
    D = torch.where(valid_t[..., None, None], Dq[:, :k_max] + Dp[:, 1:] + damping * eye, eye)
    # off-diagonal O_t couples interior t -> t+1 (edge t+1), real for t <= k-2
    valid_o = tpos[None, :] < (seg_len[:, None] - 1)
    O = torch.where(valid_o[..., None, None], U[:, 1:], torch.zeros_like(U[:, 1:]))

    free_sep = freef[sep_ids]
    # gauged couplings to the end separators
    Ca = U[:, 0].transpose(-1, -2) * (free_sep[seg_a] * segf)[:, None, None]  # H(v_0, sep_a)
    Cb = U[rows, seg_len] * (free_sep[seg_b] * segf)[:, None, None]  # H(v_{k-1}, sep_b)
    b_int = rhs[seg_vert] * valid_t[..., None]  # [G, K, 6]
    onehot0 = (tpos == 0).to(dtype)
    onehotk = (tpos[None, :] == last[:, None]).to(dtype)
    # right-hand-side columns: [A^T at row 0 | B^T at row k-1 | rhs]
    R = torch.cat(
        [Ca[:, None] * onehot0[None, :, None, None], Cb[:, None] * onehotk[..., None, None],
         b_int[..., None]],
        dim=-1,
    )  # [G, K, 6, 13]

    # forward sweep (the reference's first lax.scan)
    d_prev = eye.expand(g_count, 6, 6)
    r_prev = torch.zeros_like(R[:, 0])
    o_prev = torch.zeros_like(D[:, 0])
    Dt, Rt = [], []
    for t in range(k_max):
        z = _spd_solve(d_prev, torch.cat([o_prev, r_prev], -1))
        o_T = o_prev.transpose(-1, -2)
        d_prev = D[:, t] - o_T @ z[..., :6]
        r_prev = R[:, t] - o_T @ z[..., 6:]
        o_prev = O[:, t]
        Dt.append(d_prev)
        Rt.append(r_prev)
    # backward sweep (the second, reversed)
    X = [None] * k_max
    x_next = torch.zeros_like(R[:, 0])
    for t in reversed(range(k_max)):
        x_next = _spd_solve(Dt[t], Rt[t] - O[:, t] @ x_next)
        X[t] = x_next
    X = torch.stack(X, dim=1)  # [G, K, 6, 13]

    corr_a = Ca.transpose(-1, -2) @ X[:, 0]  # [G, 6, 13]
    corr_b = Cb.transpose(-1, -2) @ X[rows, last]

    # the reduced separator system: the chains' contributions ...
    segw = segf[:, None, None]
    S = torch.zeros((s_count, s_count, 6, 6), dtype=dtype, device=device)
    S.index_put_((seg_a, seg_a), Dp[:, 0] * segw - corr_a[..., :6], accumulate=True)
    S.index_put_((seg_a, seg_b), -corr_a[..., 6:12], accumulate=True)
    S.index_put_((seg_b, seg_a), -corr_b[..., :6], accumulate=True)
    S.index_put_((seg_b, seg_b), Dq[rows, seg_len] * segw - corr_b[..., 6:12], accumulate=True)
    rhs_seg = torch.zeros((s_count, 6), dtype=dtype, device=device)
    _scatter_add(rhs_seg, seg_a, -corr_a[..., 12])
    _scatter_add(rhs_seg, seg_b, -corr_b[..., 12])
    if all_reduce is not None:
        S = all_reduce(S)
        rhs_seg = all_reduce(rhs_seg)
    # ... plus the separator-separator edges
    se, sa, sb = (as_long(a) for a in (struct.sep_edge, struct.sep_edge_a, struct.sep_edge_b))
    S.index_put_((sa, sa), H_ii[se], accumulate=True)
    S.index_put_((sa, sb), H_ij[se], accumulate=True)
    S.index_put_((sb, sa), H_ij[se].transpose(-1, -2), accumulate=True)
    S.index_put_((sb, sb), H_jj[se], accumulate=True)
    rhs_sep = rhs[sep_ids] + rhs_seg
    # gauge and damping on the reduced system (apply_gauge semantics)
    S = S * free_sep[:, None, None, None] * free_sep[None, :, None, None]
    diag = torch.arange(s_count, device=device)
    S[diag, diag] = S[diag, diag] + ((1.0 - free_sep) + damping)[:, None, None] * eye
    Hs = S.permute(0, 2, 1, 3).reshape(s_count * 6, s_count * 6)
    x_sep = _solve_scaled(Hs, (rhs_sep * free_sep[:, None]).reshape(-1)).reshape(s_count, 6)
    x_sep = x_sep * free_sep[:, None]

    # back-substitute the chains from the solved columns
    x_int = (
        X[..., 12]
        - torch.einsum("gkab,gb->gka", X[..., :6], x_sep[seg_a])
        - torch.einsum("gkab,gb->gka", X[..., 6:12], x_sep[seg_b])
    ) * valid_t[..., None]
    dx = torch.zeros((n, 6), dtype=dtype, device=device)
    _scatter_add(dx, seg_vert.reshape(-1), x_int.reshape(-1, 6))
    if all_reduce is not None:
        dx = all_reduce(dx)
    _scatter_add(dx, sep_ids, x_sep)
    return dx * freef[:, None]


# ------------------------------------------------------------ the loops


def apply_pose_update(graph: GraphArrays, H, b):
    """Solve the assembled system and right-update the free poses."""
    n = graph.poses.shape[0]
    delta_x = _solve_scaled(H, -b).reshape(n, 6)
    delta_x = torch.where(_free(graph)[:, None], delta_x, torch.zeros_like(delta_x))
    return graph._replace(poses=graph.poses @ se3.exp_se3(delta_x))


def _check_solver(solver: str, struct):
    if solver not in ("dense", "cg", "schur"):
        raise ValueError(f"unknown solver {solver!r}")
    if solver == "schur" and struct is None:
        raise ValueError("solver='schur' needs the chain structure (chain_partition)")


def _solve_step(graph: GraphArrays, delta, solver, cg_iterations, damping, struct=None):
    """One damped normal-equations solve at the current poses ->
    (dx [N, 6], b [N, 6], chi2_robust []): the unit of the GN and LM loops
    on the dense, CG and Schur routes."""
    _check_solver(solver, struct)
    H_ii, H_ij, H_jj, b_i, b_j, _ = edge_blocks(graph, delta)
    n = graph.poses.shape[0]
    free = _free(graph)
    b = _gradient(graph, b_i, b_j)
    if solver == "dense":
        H, bf = _assemble_dense(
            n, graph.edge_i, graph.edge_j, H_ii, H_ij, H_jj, b_i, b_j, free, damping
        )
        dx = _solve_scaled(H, -bf).reshape(n, 6)
    elif solver == "cg":
        dx = solve_blocks_cg(n, graph.edge_i, graph.edge_j, H_ii, H_ij, H_jj, -b, free,
                             iterations=cg_iterations, damping=damping)
    else:
        dx = schur_chain_solve(struct, n, H_ii, H_ij, H_jj, b, free, damping=damping)
    dx = torch.where(free[:, None], dx, torch.zeros_like(dx))
    return dx, b, _graph_chi2(graph, delta)


def gauss_newton_iteration(graph: GraphArrays, delta: float = CAUCHY_DELTA,
                           solver: str = "dense", cg_iterations: int = 100, struct=None):
    """One robust Gauss-Newton iteration; returns (new_graph, total_chi2).
    ``solver``: "dense" (the [6N, 6N] Cholesky), "cg" (block-Jacobi CG on
    the per-edge blocks) or "schur" (chain elimination over ``struct``)."""
    _check_solver(solver, struct)
    H_ii, H_ij, H_jj, b_i, b_j, chi2 = edge_blocks(graph, delta)
    n = graph.poses.shape[0]
    free = _free(graph)
    if solver == "dense":
        H, b = _assemble_dense(n, graph.edge_i, graph.edge_j, H_ii, H_ij, H_jj, b_i, b_j, free)
        new_graph = apply_pose_update(graph, H, b)
    else:
        b = _gradient(graph, b_i, b_j)
        if solver == "cg":
            delta_x = solve_blocks_cg(n, graph.edge_i, graph.edge_j, H_ii, H_ij, H_jj, -b, free,
                                      iterations=cg_iterations)
            delta_x = torch.where(free[:, None], delta_x, torch.zeros_like(delta_x))
        else:
            delta_x = schur_chain_solve(struct, n, H_ii, H_ij, H_jj, b, free)
        new_graph = graph._replace(poses=graph.poses @ se3.exp_se3(delta_x))
    return new_graph, _masked_sum(chi2, graph.edge_mask)


def optimize(graph: GraphArrays, iterations: int, delta: float = CAUCHY_DELTA,
             solver: str = "dense", cg_iterations: int = 100, struct=None):
    """A fixed number of robust GN iterations (g2o's optimize(n)).  Returns
    (graph, chi2_history [iterations])."""
    history = []
    for _ in range(iterations):
        graph, chi2 = gauss_newton_iteration(graph, delta, solver, cg_iterations, struct)
        history.append(chi2)
    return graph, torch.stack(history) if history else torch.zeros(0, dtype=graph.poses.dtype)


def _graph_chi2(graph: GraphArrays, delta=CAUCHY_DELTA):
    """Total robustified chi2 at the current poses, the LM accept metric
    (g2o's activeRobustChi2(): robust edges contribute
    delta^2 log(1 + chi2/delta^2))."""
    _, _, chi2 = edge_residuals(graph)
    d2 = delta * delta
    rho = torch.where(graph.robust, d2 * torch.log1p(chi2 / d2), chi2)
    return _masked_sum(rho, graph.edge_mask)


def optimize_lm(
    graph: GraphArrays,
    iterations: int,
    delta: float = CAUCHY_DELTA,
    solver: str = "dense",
    cg_iterations: int = 100,
    struct: Optional[ChainStructure] = None,
    lambda_init: float = 1e-5,
    lambda_min: float = 1e-10,
    lambda_max: float = 1e8,
    tol: float = 0.0,
):
    """Levenberg-Marquardt with Nielsen lambda adaptation (g2o's LM on the
    local map, local_map.cpp:57-90, 208-213; Dogleg on the global graph,
    keyframe_graph.cpp:138-142).

    Each step solves (H + lambda I) dx = -b through the selected route,
    evaluates the candidate's robustified chi2 and accepts or rejects it:
    on accept lambda shrinks by max(1/3, 1 - (2 rho - 1)^3), on reject the
    step is discarded and lambda grows by the doubling sequence nu.
    Rejected steps count against ``iterations``.  Returns (graph,
    chi2_history [iterations]) with the chi2 before each step.

    ``tol`` > 0 stops once a step moves the robustified chi2 by less than
    ``tol`` relative (either way), or a step is rejected at the lambda
    ceiling; the history keeps its length, slots past the exit holding the
    final chi2."""
    lam, nu = lambda_init, 2.0
    history = []
    for _ in range(iterations):
        lam_used = lam
        dx, b, chi2_cur_t = _solve_step(graph, delta, solver, cg_iterations,
                                        GAUGE_DAMPING + lam, struct)
        cand = graph._replace(poses=graph.poses @ se3.exp_se3(dx))
        chi2_cur = float(chi2_cur_t)
        chi2_new = float(_graph_chi2(cand, delta))
        # predicted chi2 decrease of the damped quadratic model
        pred = float(torch.sum(dx * (lam * dx - b)))
        rho = (chi2_cur - chi2_new) / max(pred, 1e-30)
        accept = chi2_new < chi2_cur and np.isfinite(chi2_new)
        if accept:
            graph = cand
            s = 2.0 * rho - 1.0
            lam = lam * max(1.0 / 3.0, 1.0 - s * (s * s))
            nu = 2.0
        else:
            lam = lam * nu
            nu = nu * 2.0
        lam = min(max(lam, lambda_min), lambda_max)
        history.append(chi2_cur)
        if tol > 0.0:
            # converged when a step barely moves chi2 either way: at the
            # optimum LM steps are tiny and usually rejected by float dust
            converged = np.isfinite(chi2_new) and abs(chi2_cur - chi2_new) < tol * max(
                chi2_cur, 1e-30
            )
            # rejected at the lambda ceiling: no admissible step is left
            stuck = not accept and lam_used >= 0.5 * lambda_max
            if converged or stuck:
                break
    if len(history) < iterations:
        history += [float(_graph_chi2(graph, delta))] * (iterations - len(history))
    return graph, torch.tensor(history, dtype=torch.float64)


def edge_robust_weights(graph: GraphArrays, delta: float = CAUCHY_DELTA):
    """Per-edge Cauchy weights and chi2, for outlier pruning
    (removeOutlierConstraints, keyframe_graph.cpp:643-674)."""
    _, _, chi2 = edge_residuals(graph)
    return cauchy_weights(chi2, graph.robust, delta), chi2


# ------------------------------------------------------------ the container


class _Subgraph(NamedTuple):
    """The compacted active subgraph (host NumPy) and the index map back
    into the owning PoseGraph's vertex storage."""

    vidx: np.ndarray  # [n] original vertex indices
    n: int
    e: int
    poses: np.ndarray
    fixed: np.ndarray
    edge_i: np.ndarray
    edge_j: np.ndarray
    measurements: np.ndarray
    information: np.ndarray
    robust: np.ndarray

    def to_graph_arrays(self) -> GraphArrays:
        """The subgraph as float64 CPU tensors (the solve's precision)."""
        f64 = lambda a: torch.from_numpy(np.asarray(a, np.float64))  # noqa: E731
        return GraphArrays(
            poses=f64(self.poses),
            vertex_mask=torch.ones(self.n, dtype=torch.bool),
            fixed_mask=torch.from_numpy(self.fixed.copy()),
            edge_i=torch.from_numpy(self.edge_i.astype(np.int64)),
            edge_j=torch.from_numpy(self.edge_j.astype(np.int64)),
            measurements=f64(self.measurements),
            information=f64(self.information),
            edge_mask=torch.ones(self.e, dtype=torch.bool),
            robust=torch.from_numpy(self.robust.copy()),
        )

    def chain_structure(self) -> Tuple[Optional[ChainStructure], int]:
        """(the chain structure or None, its separator count)."""
        struct = chain_partition(self.n, self.edge_i, self.edge_j, np.ones(self.e, bool),
                                 np.ones(self.n, bool), ~self.fixed)
        return struct, 0 if struct is None else len(struct.sep_ids)


class PoseGraph:
    """Host-side growable pose graph (NumPy storage; the g2o
    SparseOptimizer facade of LocalMap and KeyframeGraph).  Vertices and
    edges are appended on the host, capacity doubling as they grow;
    ``optimize`` solves the compacted active subgraph in float64 on the
    CPU."""

    # above this many active vertices the dense [6N, 6N] Cholesky (a
    # 768x768 factorization at 128) gives way to the larger routes
    DENSE_SOLVER_MAX_VERTICES = 128
    # separator cap of the Schur route: its reduced system is a dense
    # [6S, 6S] Cholesky
    SCHUR_SEPARATOR_MAX_VERTICES = 384
    # "auto" takes the exact sparse factorization up to this many vertices
    # where chain elimination is degenerate (a SLAM graph: an odometry and a
    # keyframe edge per frame give every vertex degree >= 3)
    SPARSE_DIRECT_MAX_VERTICES = 4096
    # past this separator share the reduced system is the whole system
    SCHUR_SEPARATOR_MAX_FRACTION = 0.6

    def __init__(self, vertex_capacity: int = 16, edge_capacity: int = 32, dtype=np.float32):
        self.dtype = dtype
        self._n = 0
        self._e = 0
        self._vertex_ids: dict = {}
        # structure cache: the compacted subgraph and its chain structure
        # are pure functions of (graph structure, max_level), not of the
        # poses; mutators bump _struct_version and optimize() refreshes
        # only the poses
        self._struct_version = 0
        self._struct_cache = None  # ((version, max_level), entry dict or None)
        # convergence memo: an optimize() whose LM loop exited via the tol
        # test has reached its fixed point for the current (structure,
        # poses); re-solving the identical state returns that history.
        # edge_diagnostics memoizes on the same versions.
        self._poses_version = 0
        self._converged_memo = None
        self._diag_memo = None
        self._real_sep_count = 0
        # the route the last solve took ("dense", "cg", "schur" or "sparse")
        self.last_solver: Optional[str] = None
        # (min_idx, max_idx) -> [edge indices], for find_edge
        self._edge_index: dict = {}
        self._alloc_vertices(vertex_capacity)
        self._alloc_edges(edge_capacity)

    def _touch_structure(self):
        self._struct_version += 1
        self._struct_cache = None

    def _touch_poses(self):
        self._poses_version += 1

    def _alloc_vertices(self, cap):
        self.poses = np.tile(np.eye(4, dtype=self.dtype), (cap, 1, 1))
        self.fixed = np.zeros(cap, bool)

    def _alloc_edges(self, cap):
        self.edge_i = np.zeros(cap, np.int32)
        self.edge_j = np.zeros(cap, np.int32)
        self.measurements = np.tile(np.eye(4, dtype=self.dtype), (cap, 1, 1))
        self.information = np.tile(np.eye(6, dtype=self.dtype), (cap, 1, 1))
        self.edge_active = np.zeros(cap, bool)
        self.robust = np.zeros(cap, bool)
        # edge "level": 0 = always optimized, 2 = only in dense mode (the
        # reference's g2o edge levels, keyframe_graph.cpp:764-772, 257-264)
        self.edge_level = np.zeros(cap, np.int32)

    @property
    def num_vertices(self) -> int:
        return self._n

    @property
    def num_edges(self) -> int:
        return self._e

    def add_vertex(self, key, pose, fixed: bool = False) -> int:
        """Add (or update) a vertex keyed by any hashable id; returns index."""
        if key in self._vertex_ids:
            idx = self._vertex_ids[key]
            self.poses[idx] = np.asarray(pose, self.dtype)
            self._touch_poses()
            if bool(self.fixed[idx]) != fixed:
                self._touch_structure()  # gauge change
            self.fixed[idx] = fixed
            return idx
        self._touch_structure()
        self._touch_poses()
        if self._n == len(self.poses):
            old_p, old_f = self.poses, self.fixed
            self._alloc_vertices(2 * len(old_p))
            self.poses[: self._n] = old_p
            self.fixed[: self._n] = old_f
        idx = self._n
        self._vertex_ids[key] = idx
        self.poses[idx] = np.asarray(pose, self.dtype)
        self.fixed[idx] = fixed
        self._n += 1
        return idx

    def vertex_index(self, key) -> int:
        return self._vertex_ids[key]

    def has_vertex(self, key) -> bool:
        return key in self._vertex_ids

    def vertex_pose(self, key) -> np.ndarray:
        return self.poses[self._vertex_ids[key]]

    def set_vertex_pose(self, key, pose):
        self.poses[self._vertex_ids[key]] = np.asarray(pose, self.dtype)
        self._touch_poses()

    def set_fixed(self, key, fixed: bool = True):
        self.fixed[self._vertex_ids[key]] = fixed
        self._touch_structure()

    def add_edge(
        self, key_i, key_j, measurement, information, robust: bool = False, level: int = 0
    ) -> int:
        """Add edge with measurement T_i^{-1} T_j and 6x6 information."""
        if self._e == len(self.edge_i):
            old = (self.edge_i, self.edge_j, self.measurements, self.information,
                   self.edge_active, self.robust, self.edge_level)
            self._alloc_edges(2 * len(self.edge_i))
            new = (self.edge_i, self.edge_j, self.measurements, self.information,
                   self.edge_active, self.robust, self.edge_level)
            for n, o in zip(new, old):
                n[: self._e] = o
        k = self._e
        self.edge_i[k] = self._vertex_ids[key_i]
        self.edge_j[k] = self._vertex_ids[key_j]
        self.measurements[k] = np.asarray(measurement, self.dtype)
        self.information[k] = np.asarray(information, self.dtype)
        self.edge_active[k] = True
        self.robust[k] = robust
        self.edge_level[k] = level
        self._e += 1
        a, b = int(self.edge_i[k]), int(self.edge_j[k])
        self._edge_index.setdefault((min(a, b), max(a, b)), []).append(k)
        self._touch_structure()
        return k

    def rename_vertex(self, old_key, new_key):
        """Re-key a vertex (g2o changeId, keyframe_graph.cpp:776-780)."""
        idx = self._vertex_ids.pop(old_key)
        self._vertex_ids[new_key] = idx

    def set_edge_level(self, edge_index: int, level: int):
        self.edge_level[edge_index] = level
        self._touch_structure()

    def set_all_edge_levels(self, level: int):
        """Promote every edge into the optimized set (the dense final
        optimization mode, keyframe_graph.cpp:257-264)."""
        self.edge_level[: self._e] = level
        self._touch_structure()

    def find_edge(self, key_i, key_j):
        """Index of the first active edge between two vertices (either
        direction), or None."""
        a, b = int(self._vertex_ids[key_i]), int(self._vertex_ids[key_j])
        for k in self._edge_index.get((min(a, b), max(a, b)), ()):
            if self.edge_active[k]:
                return k
        return None

    def edge_list(self):
        """Active edges as (key_i, key_j, measurement, information, robust,
        level)."""
        rev = {v: k for k, v in self._vertex_ids.items()}
        return [
            (rev[int(self.edge_i[k])], rev[int(self.edge_j[k])], self.measurements[k],
             self.information[k], bool(self.robust[k]), int(self.edge_level[k]))
            for k in range(self._e)
            if self.edge_active[k]
        ]

    def vertex_keys(self):
        return list(self._vertex_ids.keys())

    def deactivate_edges(self, edge_indices):
        """Mask out edges (the outlier-removal primitive)."""
        self.edge_active[np.asarray(edge_indices, np.int64)] = False
        self._touch_structure()

    def to_arrays(self) -> GraphArrays:
        """The whole allocated storage as CPU tensors in the graph's dtype."""
        vmask = np.zeros(len(self.poses), bool)
        vmask[: self._n] = True
        return GraphArrays(
            poses=torch.from_numpy(self.poses.copy()),
            vertex_mask=torch.from_numpy(vmask),
            fixed_mask=torch.from_numpy(self.fixed & vmask),
            edge_i=torch.from_numpy(self.edge_i.astype(np.int64)),
            edge_j=torch.from_numpy(self.edge_j.astype(np.int64)),
            measurements=torch.from_numpy(self.measurements.copy()),
            information=torch.from_numpy(self.information.copy()),
            edge_mask=torch.from_numpy(self.edge_active.copy()),
            robust=torch.from_numpy(self.robust.copy()),
        )

    def _chain_structure(self, max_level) -> Optional[ChainStructure]:
        """The Schur route's elimination structure of the whole storage over
        edges with level <= max_level, under optimize()'s gauge (vertex 0
        fixed when nothing is)."""
        cap = len(self.poses)
        allocated = np.zeros(cap, bool)
        allocated[: self._n] = True
        fixed = (self.fixed & allocated).copy()
        if not fixed[: self._n].any():
            fixed[0] = True
        active = self.edge_active & (self.edge_level <= max_level)
        struct = chain_partition(cap, self.edge_i, self.edge_j, active, allocated,
                                 allocated & ~fixed)
        self._real_sep_count = 0 if struct is None else len(struct.sep_ids)
        return struct

    def _compact_subgraph(self, max_level) -> Optional[_Subgraph]:
        """The active subgraph: only vertices touched by an active edge with
        level <= max_level enter the solve (g2o's
        initializeOptimization(level), keyframe_graph.cpp:481-489).  Vertices
        outside it would receive a zero update, so compaction is exact."""
        e_act = self.edge_active[: self._e] & (self.edge_level[: self._e] <= max_level)
        eidx = np.nonzero(e_act)[0]
        if eidx.size == 0:
            return None
        used = np.zeros(self._n, bool)
        used[self.edge_i[eidx]] = True
        used[self.edge_j[eidx]] = True
        vidx = np.nonzero(used)[0]
        remap = np.zeros(self._n, np.int32)
        remap[vidx] = np.arange(vidx.size, dtype=np.int32)
        fixed = self.fixed[vidx].copy()
        if not fixed.any():
            # gauge: fix the first subgraph vertex (what g2o requires
            # before initializeOptimization)
            fixed[0] = True
        return _Subgraph(
            vidx=vidx, n=int(vidx.size), e=int(eidx.size), poses=self.poses[vidx].copy(),
            fixed=fixed, edge_i=remap[self.edge_i[eidx]], edge_j=remap[self.edge_j[eidx]],
            measurements=self.measurements[eidx].copy(),
            information=self.information[eidx].copy(), robust=self.robust[eidx].copy(),
        )

    def _resolve_solver(self, solver: str, sub: _Subgraph, entry: dict):
        """(route, chain structure or None) for ``solver`` on ``sub``: the
        reference's policy (pose_graph.py:1571-1598).  ``entry`` caches the
        chain structure with the compacted subgraph."""

        def cached_chain():
            if "chain" not in entry:
                entry["chain"] = sub.chain_structure()
            struct, self._real_sep_count = entry["chain"]
            return struct

        if solver == "auto":
            if sub.n <= self.DENSE_SOLVER_MAX_VERTICES:
                return "dense", None
            chain = cached_chain()
            sep_ok = (
                chain is not None
                and self._real_sep_count <= self.SCHUR_SEPARATOR_MAX_VERTICES
                and self._real_sep_count <= self.SCHUR_SEPARATOR_MAX_FRACTION * sub.n
            )
            if sep_ok:
                return "schur", chain
            # degenerate chains or loopy graphs: the exact sparse
            # factorization, CG beyond its cap
            return ("sparse" if sub.n <= self.SPARSE_DIRECT_MAX_VERTICES else "cg"), None
        if solver == "schur":
            chain = cached_chain()
            if chain is None:
                # nothing to eliminate: the dense system is the reduced one
                return ("dense" if sub.n <= self.DENSE_SOLVER_MAX_VERTICES else "cg"), None
            return "schur", chain
        if solver not in SOLVERS:
            raise ValueError(f"unknown solver {solver!r}")
        return solver, None

    def optimize(
        self,
        iterations: int = 50,
        delta: float = CAUCHY_DELTA,
        max_level: int = 0,
        solver: str = "auto",
        algorithm: str = "lm",
        tol: float = 1e-8,
    ) -> np.ndarray:
        """Optimize in place over edges with level <= max_level; returns the
        chi2 history (float64).  max_level=0 is the sparse keyframe-graph
        mode, max_level >= 2 the dense mode including odometry edges.

        The solve runs on the compacted active subgraph, in float64 on the
        CPU (module docstring).  ``solver``: "auto" takes the dense Cholesky
        up to DENSE_SOLVER_MAX_VERTICES active vertices; beyond that the
        Schur route when chain elimination leaves a small separator set,
        else the sparse factorization (CG beyond SPARSE_DIRECT_MAX_VERTICES);
        "dense", "cg", "schur" and "sparse" force a route.  ``algorithm``:
        "lm" (default, adaptive lambda, as g2o's Levenberg) or "gn" (fixed
        damping).  ``tol``: the LM loop's relative convergence threshold (0
        runs the full budget).  A ``RuntimeError`` of the dense, CG or Schur
        solve degrades to the sparse route with a warning."""
        if self._n < 2 or self._e < 1:
            return np.zeros(0, self.dtype)
        if algorithm not in ("gn", "lm"):
            raise ValueError(f"unknown algorithm {algorithm!r}")
        # convergence memo: identical (structure, poses, objective) to a
        # solve that already exited via the tol test (keyed on the solver
        # name before it is resolved)
        memo_key = (self._struct_version, self._poses_version, max_level, solver, algorithm,
                    delta, tol)
        if tol > 0.0 and self._converged_memo is not None and self._converged_memo[0] == memo_key:
            return np.asarray(self._converged_memo[1]).copy()
        key = (self._struct_version, max_level)
        if self._struct_cache is None or self._struct_cache[0] != key:
            sub = self._compact_subgraph(max_level)
            self._struct_cache = (key, None if sub is None else {"sub": sub})
        entry = self._struct_cache[1]
        if entry is None:
            return np.zeros(0, self.dtype)
        sub = entry["sub"]
        sub.poses[:] = self.poses[sub.vidx]
        route, chain = self._resolve_solver(solver, sub, entry)
        try:
            history, out_poses = self._solve_compact(sub, chain, iterations, delta, route,
                                                     algorithm, tol)
        except RuntimeError as err:
            if route == "sparse":
                raise
            # a failed solve degrades to the exact host factorization
            warnings.warn(
                f"pose-graph {route!r} solve failed ({err!r}); "
                "falling back to the host sparse-direct solver"
            )
            route = "sparse"
            history, out_poses = self._optimize_sparse_direct(
                iterations, delta, sub.to_graph_arrays(), algorithm, tol
            )
        self.last_solver = route
        self.poses[sub.vidx] = out_poses.astype(self.dtype, copy=False)
        self._touch_poses()
        history = np.asarray(history)
        # memo only a solve the tol test terminated: the history repeats the
        # final chi2 past the exit, so a tail |delta| below tol tells a
        # converged fixed point from a budget spent mid-descent.  (A run
        # that ends in a streak of rejected steps also passes this test:
        # the reference's defect, pose_graph.py:1631, kept as it is.)
        if (
            tol > 0.0
            and history.shape[0] >= 2
            and abs(float(history[-1]) - float(history[-2]))
            < tol * max(abs(float(history[-1])), 1e-30)
        ):
            self._converged_memo = (
                (self._struct_version, self._poses_version, max_level, solver, algorithm,
                 delta, tol),
                history.copy(),
            )
        else:
            self._converged_memo = None
        return history

    def _solve_compact(self, sub, chain, iterations, delta, solver, algorithm, tol):
        """One solve of a compacted subgraph by one route -> (history,
        poses [n, 4, 4])."""
        arrays = sub.to_graph_arrays()
        if solver == "sparse":
            return self._optimize_sparse_direct(iterations, delta, arrays, algorithm, tol)
        # Krylov bound: a chain of N vertices needs ~N CG iterations to
        # carry a correction end to end; the tolerance ends it earlier on
        # well-conditioned graphs
        cg_iterations = min(max(256, 2 * sub.n), 8192)
        if algorithm == "lm":
            out, history = optimize_lm(arrays, iterations, delta, solver, cg_iterations,
                                       struct=chain, tol=tol)
        else:
            out, history = optimize(arrays, iterations, delta, solver, cg_iterations,
                                    struct=chain)
        return history.numpy(), out.poses.numpy()

    @staticmethod
    def _finish_history(history, chi2_final):
        """Append the post-step chi2, so that a tol-terminated run's history
        ends in the converged plateau the convergence memo reads."""
        if np.isfinite(chi2_final):
            history.append(float(chi2_final))

    def _optimize_sparse_direct(self, iterations, delta, arrays: GraphArrays,
                                algorithm="gn", tol: float = 0.0):
        """Sparse-direct GN/LM: the per-edge blocks in float64 torch, the
        gauged system assembled in ``scipy.sparse`` and solved exactly (the
        reference's g2o+CSparse architecture, keyframe_graph.cpp:138-142).
        Returns (history, poses [N, 4, 4]): unlike the other routes, the
        history ends where the loop does (plus the final chi2 after a tol
        exit)."""
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla

        n = arrays.poses.shape[0]
        free = (arrays.vertex_mask & ~arrays.fixed_mask).numpy()
        ei = arrays.edge_i.numpy()
        ej = arrays.edge_j.numpy()
        history = []
        poses = arrays.poses
        lam, nu = 1e-5, 2.0  # LM state (Nielsen adaptation, as optimize_lm)
        r6 = np.arange(6)
        rr, cc = np.meshgrid(r6, r6, indexing="ij")
        freef = free.astype(np.float64)
        scale = freef[ei] * freef[ej]
        diag_idx = (np.arange(n)[:, None] * 6 + r6[None]).ravel()
        for _ in range(iterations):
            H_ii, H_ij, H_jj, b_i, b_j, chi2 = edge_blocks(arrays._replace(poses=poses), delta)
            history.append(float(_masked_sum(chi2, arrays.edge_mask)))
            H_ii, H_ij, H_jj = H_ii.numpy(), H_ij.numpy(), H_jj.numpy()
            b = np.zeros((n, 6))
            np.add.at(b, ei, b_i.numpy())
            np.add.at(b, ej, b_j.numpy())
            # the gauged system in COO block form
            rows, cols, vals = [], [], []

            def add_block(i_arr, j_arr, blk):
                rows.append((i_arr[:, None, None] * 6 + rr[None]).ravel())
                cols.append((j_arr[:, None, None] * 6 + cc[None]).ravel())
                vals.append(blk.ravel())

            add_block(ei, ei, H_ii * freef[ei][:, None, None])
            add_block(ei, ej, H_ij * scale[:, None, None])
            add_block(ej, ei, np.swapaxes(H_ij, 1, 2) * scale[:, None, None])
            add_block(ej, ej, H_jj * freef[ej][:, None, None])
            # gauge diagonal: damping on free vertices, identity (+ damping)
            # on fixed ones (apply_gauge)
            damping = GAUGE_DAMPING + (lam if algorithm == "lm" else 0.0)
            rows.append(diag_idx)
            cols.append(diag_idx)
            vals.append(np.repeat(np.where(free, damping, 1.0 + damping), 6))
            H = sp.coo_matrix(
                (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
                shape=(6 * n, 6 * n),
            ).tocsc()
            dx = spla.spsolve(H, (-b * freef[:, None]).ravel()).reshape(n, 6)
            dx = np.where(free[:, None], dx, 0.0)
            cand = poses @ se3.exp_se3(torch.from_numpy(dx).to(poses.dtype))
            if algorithm != "lm":
                poses = cand
                continue
            chi2_cur = float(_graph_chi2(arrays._replace(poses=poses), delta))
            chi2_new = float(_graph_chi2(arrays._replace(poses=cand), delta))
            if np.isfinite(chi2_new) and chi2_new < chi2_cur:
                poses = cand
                pred = float(np.sum(dx * (lam * dx - b)))
                rho = (chi2_cur - chi2_new) / max(pred, 1e-30)
                lam = max(1e-10, lam * max(1.0 / 3.0, 1.0 - (2 * rho - 1) ** 3))
                nu = 2.0
            else:
                lam = min(1e8, lam * nu)
                nu *= 2.0
                if tol > 0.0 and lam >= 0.5e8:
                    # LM breakdown: rejected at the lambda ceiling
                    self._finish_history(history, chi2_cur)
                    break
            # converged when the step barely moves chi2 either way
            if (
                tol > 0.0
                and np.isfinite(chi2_new)
                and abs(chi2_cur - chi2_new) < tol * max(chi2_cur, 1e-30)
            ):
                self._finish_history(history, min(chi2_cur, chi2_new))
                break
        return np.asarray(history, np.float64), poses.numpy()

    def edge_diagnostics(self) -> Tuple[np.ndarray, np.ndarray]:
        """(robust_weight, chi2) per edge, in the graph's dtype (the
        EdgeErrorSerializer data, map_serializer.cpp:76-93).  Memoized on
        the (structure, poses) versions: converged final-pass rounds query
        the same state again."""
        memo_key = (self._struct_version, self._poses_version)
        if self._diag_memo is not None and self._diag_memo[0] == memo_key:
            w, chi2 = self._diag_memo[1]
            return w.copy(), chi2.copy()
        w, chi2 = edge_robust_weights(self.to_arrays())
        w = w.numpy()[: self._e]
        chi2 = chi2.numpy()[: self._e]
        self._diag_memo = (memo_key, (w.copy(), chi2.copy()))
        return w, chi2

    def remove_outlier_edges(self, weight_threshold: float, n_max: int = -1) -> int:
        """Deactivate robustified edges whose Cauchy weight falls below the
        threshold, worst first (keyframe_graph.cpp:643-674)."""
        w, _ = self.edge_diagnostics()
        candidates = [
            (w[k], k)
            for k in range(self._e)
            if self.edge_active[k] and self.robust[k] and w[k] < weight_threshold
        ]
        candidates.sort()
        if n_max >= 0:
            candidates = candidates[:n_max]
        if candidates:
            self.deactivate_edges([k for _, k in candidates])
        return len(candidates)
