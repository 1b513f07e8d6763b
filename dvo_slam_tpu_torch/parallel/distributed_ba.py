"""Distributed pose-graph bundle adjustment over the ranks of a mesh (port
of ``dvo_slam_tpu.parallel.distributed_ba``).

The per-edge 6x6 Hessian blocks are the natural unit of distribution
(SURVEY.md 2.5, P6: the reference's NormalEquationsLeastSquares::combine
partial-sum merge becomes a sum over the ranks).  Three solvers, each a
fixed number of Gauss-Newton iterations returning ``(graph,
chi2_history)``:

* ``distributed_gauss_newton``: edges sharded over the ranks; each rank
  assembles its edges' dense [N, N, 6, 6] system, one ``all_reduce`` sums
  it with the gradient and chi2; the gauge, the 6N Cholesky solve and the
  pose update run on every rank;
* ``distributed_gauss_newton_cg``: edges sharded, no Hessian: block-Jacobi
  CG whose every iteration sums one [N, 6] partial product (plus one
  [N, 6, 6] preconditioner sum per GN iteration);
* ``distributed_gauss_newton_schur``: the degree-2 chains sharded; each
  rank eliminates its chains, one [S, S, 6, 6] reduced system is summed
  per GN iteration, and the chain updates once as [N, 6].

The solves run in float64 on the mesh's device: the card over NCCL, or the
CPU for a gloo mesh (the port's single-device solver also solves in
float64).  The returned graph holds those float64 poses on that device.
The reference's ``distributed_gauss_newton_jit`` is only a ``jax.jit``
wrapper and has no counterpart.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..models import pose_graph as pg
from ..ops import se3
from .mesh import BATCH_AXIS, Mesh

_EDGE_FIELDS = ("edge_i", "edge_j", "measurements", "information", "edge_mask", "robust")
_SEGMENT_FIELDS = ("seg_edges", "seg_flip", "seg_len", "seg_a", "seg_b", "seg_vert")


def _check_axis(mesh: Mesh, axis: str):
    if axis != mesh.axis:
        raise ValueError(f"mesh axis is {mesh.axis!r}, not {axis!r}")


def _on_mesh(graph: pg.GraphArrays, mesh: Mesh) -> pg.GraphArrays:
    """The graph on the mesh's device, its floating fields in float64."""
    def put(x):
        x = torch.as_tensor(x).to(mesh.device)
        return x.to(torch.float64) if x.is_floating_point() else x

    return pg.GraphArrays(*(put(x) for x in graph))


def _all_reduce(mesh: Mesh):
    """A function that sums a tensor over the mesh's ranks; its ``group``
    tells ``pose_graph.solve_blocks_cg`` which group it reduces over, so
    that on the card over NCCL the CG loop's reduction is captured in its
    CUDA graphs (in the WHILE body where the group's probe admitted it)."""
    def reduce(x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        dist.all_reduce(x, group=mesh.group)
        return x

    reduce.group = mesh.group
    return reduce


def _edge_shard(graph: pg.GraphArrays, mesh: Mesh) -> pg.GraphArrays:
    """This rank's contiguous block of the padded edge storage."""
    e = graph.edge_i.shape[0]
    if e % mesh.size != 0:
        raise ValueError(f"edge capacity {e} not divisible by mesh size {mesh.size}")
    per = e // mesh.size
    lo = mesh.rank * per
    return graph._replace(**{f: getattr(graph, f)[lo: lo + per] for f in _EDGE_FIELDS})


def _run(graph: pg.GraphArrays, iterations: int, step) -> Tuple[pg.GraphArrays, torch.Tensor]:
    """``iterations`` of ``step(poses) -> (dx [N, 6], chi2)``; the update
    is right-multiplicative as in the single solvers."""
    poses, history = graph.poses, []
    for _ in range(iterations):
        dx, chi2 = step(poses)
        poses = poses @ se3.exp_se3(dx)
        history.append(chi2)
    empty = torch.zeros(0, dtype=poses.dtype, device=poses.device)
    return graph._replace(poses=poses), torch.stack(history) if history else empty


def distributed_gauss_newton(graph: pg.GraphArrays, mesh: Mesh, iterations: int = 10,
                             delta: float = pg.CAUCHY_DELTA, axis: str = BATCH_AXIS):
    """GN iterations with edge-sharded blocks and one all-reduce of the
    dense normal equations per iteration.  The padded edge capacity must
    be divisible by the mesh size (``PoseGraph`` capacities are powers of
    two).  Returns (graph, chi2_history)."""
    _check_axis(mesh, axis)
    g = _on_mesh(graph, mesh)
    local = _edge_shard(g, mesh)
    n = g.poses.shape[0]
    free = pg._free(g)

    def step(poses):
        H_ii, H_ij, H_jj, b_i, b_j, chi2 = pg.edge_blocks(local._replace(poses=poses), delta)
        H, b = pg.assemble_blocks(n, local.edge_i, local.edge_j, H_ii, H_ij, H_jj, b_i, b_j)
        # the collective: H, b and chi2 summed over the ranks in one buffer
        packed = torch.cat([H.reshape(-1), b.reshape(-1),
                            pg._masked_sum(chi2, local.edge_mask).reshape(1)])
        packed = _all_reduce(mesh)(packed)
        H = packed[: H.numel()].reshape(H.shape)
        b = packed[H.numel(): -1].reshape(b.shape)
        H_flat, b_flat = pg.apply_gauge(H, b, free)
        dx = pg._solve_scaled(H_flat, -b_flat).reshape(n, 6)
        return torch.where(free[:, None], dx, torch.zeros_like(dx)), packed[-1]

    return _run(g, iterations, step)


def distributed_gauss_newton_cg(graph: pg.GraphArrays, mesh: Mesh, iterations: int = 10,
                                delta: float = pg.CAUCHY_DELTA, axis: str = BATCH_AXIS,
                                cg_iterations: int = 256):
    """Edge-sharded GN whose solve is distributed block-CG: the Hessian is
    never formed; each CG iteration sums one [N, 6] partial product over
    the ranks, and each GN iteration the gradient, chi2 and one
    [N, 6, 6] preconditioner.  On the card over NCCL the CG loop is one
    launch of a CUDA graph whose WHILE body holds that all-reduce, with no
    host read from its start to its result, where the group's probe
    admitted that form (``irls_graph.group_forms``), else chunked graph
    replays with a read of ``active`` after each
    (``pose_graph.solve_blocks_cg``); over gloo, eagerly.  Every rank
    holds the same iterate, so every rank runs the same chunks.  Returns
    (graph, chi2_history)."""
    _check_axis(mesh, axis)
    g = _on_mesh(graph, mesh)
    local = _edge_shard(g, mesh)
    n = g.poses.shape[0]
    free = pg._free(g)
    reduce = _all_reduce(mesh)

    def step(poses):
        H_ii, H_ij, H_jj, b_i, b_j, chi2 = pg.edge_blocks(local._replace(poses=poses), delta)
        packed = reduce(torch.cat([pg._gradient(local, b_i, b_j).reshape(-1),
                                   pg._masked_sum(chi2, local.edge_mask).reshape(1)]))
        b = packed[:-1].reshape(n, 6)
        dx = pg.solve_blocks_cg(n, local.edge_i, local.edge_j, H_ii, H_ij, H_jj, -b, free,
                                iterations=cg_iterations, all_reduce=reduce)
        return torch.where(free[:, None], dx, torch.zeros_like(dx)), packed[-1]

    return _run(g, iterations, step)


def pad_chain_structure(struct: pg.ChainStructure, n_dev: int) -> pg.ChainStructure:
    """Pad the segment axis to a multiple of the mesh size with zero-length
    segments (``schur_chain_solve`` treats seg_len == 0 as inert)."""
    g = struct.seg_len.shape[0]
    extra = -(-g // n_dev) * n_dev - g
    if extra == 0:
        return struct

    def pad0(x):
        a = np.asarray(x)
        return np.pad(a, [(0, extra)] + [(0, 0)] * (a.ndim - 1))

    return struct._replace(**{f: pad0(getattr(struct, f)) for f in _SEGMENT_FIELDS})


def distributed_gauss_newton_schur(graph: pg.GraphArrays, struct: pg.ChainStructure, mesh: Mesh,
                                   iterations: int = 10, delta: float = pg.CAUCHY_DELTA,
                                   axis: str = BATCH_AXIS):
    """Schur-complement distributed BA: the degree-2 chains sharded over the
    ranks, each rank's elimination sweeps over its chains, and per GN
    iteration one reduced [S, S, 6, 6] + [S, 6] all-reduce (S separators,
    independent of the trajectory's length) plus one [N, 6] of the
    back-substituted chain updates; the reduced solve runs on every rank.
    The edge blocks are computed on every rank.  Returns (graph,
    chi2_history)."""
    _check_axis(mesh, axis)
    struct = pad_chain_structure(struct, mesh.size)
    per = struct.seg_len.shape[0] // mesh.size
    lo = mesh.rank * per
    local = struct._replace(**{f: np.asarray(getattr(struct, f))[lo: lo + per]
                               for f in _SEGMENT_FIELDS})
    g = _on_mesh(graph, mesh)
    n = g.poses.shape[0]
    free = pg._free(g)
    reduce = _all_reduce(mesh)

    def step(poses):
        full = g._replace(poses=poses)
        H_ii, H_ij, H_jj, b_i, b_j, chi2 = pg.edge_blocks(full, delta)
        b = pg._gradient(full, b_i, b_j)
        dx = pg.schur_chain_solve(local, n, H_ii, H_ij, H_jj, b, free, all_reduce=reduce)
        return dx, pg._masked_sum(chi2, g.edge_mask)

    return _run(g, iterations, step)
