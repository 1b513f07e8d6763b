"""6-DoF normal-equation solvers and partial-sum merging (port of
``dvo_slam_tpu.ops.least_squares``): ``solve_ldlt`` (the tracker's solve),
``solve_evd`` (eigendecomposition with small-eigenvalue truncation),
``solve_svd`` (minimum-norm solve of the stacked system) and ``combine``
(the merge of partial normal equations).

The Cholesky factorisation runs one column at a time with vector ops:
on CUDA every tensor op is one launch, so a column loop costs ~90
launches where the reference's scalar unroll would cost ~150.  The sums
inside a column are dot products here and sequential scalar sums in the
reference; the two agree to float32 rounding (rtol 1e-5 in the tests).

Systems batch over leading dimensions: ``A [..., 6, 6]``, ``b [..., 6]``.
A batch of B systems (the lockstep multi-stream solve) takes the same
chain of launches as one system; one system [6, 6] takes exactly the
operations it took before batching existed.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_PIVOT_FLOOR = 1e-20


class NormalEquations(NamedTuple):
    """A x = b with A [6, 6] symmetric PSD and b [6]; ``error`` carries the
    accumulated weighted squared residual, ``num_constraints`` the count."""

    A: torch.Tensor
    b: torch.Tensor
    error: torch.Tensor
    num_constraints: torch.Tensor


def combine(a: NormalEquations, b: NormalEquations) -> NormalEquations:
    """Merge two partial accumulations."""
    return NormalEquations(
        A=a.A + b.A,
        b=a.b + b.b,
        error=a.error + b.error,
        num_constraints=a.num_constraints + b.num_constraints,
    )


def _matvec(M, v):
    """M [..., m, k] @ v [..., k] -> [..., m]."""
    if v.dim() == 1:
        return M @ v
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def _dot(a, b):
    """Dot product over the last axis of a [..., k] and b [..., k] -> [...]."""
    if a.dim() == 1:
        return a @ b
    return (a.unsqueeze(-2) @ b.unsqueeze(-1))[..., 0, 0]


def _cholesky_solve_unrolled(A, b, n: int = 6):
    """Cholesky solve of a tiny SPD system (or a batch of them).  Diagonal
    pivots are floored at 1e-20, so a singular system yields large but
    finite steps."""
    L = torch.zeros_like(A)
    for j in range(n):
        s = A[..., j:, j] - _matvec(L[..., j:, :j], L[..., j, :j])
        pivot = torch.sqrt(torch.clamp(s[..., 0], min=_PIVOT_FLOOR))
        L[..., j, j] = pivot
        L[..., j + 1 :, j] = s[..., 1:] / pivot.unsqueeze(-1)
    # forward substitution L y = b
    y = torch.zeros_like(b)
    for i in range(n):
        y[..., i] = (b[..., i] - _dot(L[..., i, :i], y[..., :i])) / L[..., i, i]
    # back substitution L^T x = y
    x = torch.zeros_like(b)
    for i in reversed(range(n)):
        x[..., i] = (y[..., i] - _dot(L[..., i + 1 :, i], x[..., i + 1 :])) / L[..., i, i]
    return x


def solve_ldlt(A, b):
    """Solve the 6x6 system (or a batch [..., 6, 6]) with symmetric Jacobi
    pre-scaling: D^-1/2 A D^-1/2 y = D^-1/2 b, x = D^-1/2 y (equilibration
    recovers the conditioning the original buys with a float64 LDLT)."""
    d = torch.sqrt(torch.clamp(torch.diagonal(A, dim1=-2, dim2=-1), min=_PIVOT_FLOOR))
    d_inv = 1.0 / d
    A_s = A * d_inv[..., :, None] * d_inv[..., None, :]
    b_s = b * d_inv
    y = _cholesky_solve_unrolled(A_s, b_s)
    return y * d_inv


def solve_evd(A, b, rel_threshold=1e-6):
    """Eigendecomposition solve of A x = b (or a batch), dropping the
    eigenvalues at or below ``rel_threshold`` x the largest magnitude:
    unobservable directions are left out instead of amplified."""
    w, V = torch.linalg.eigh(A)
    w_max = torch.amax(w.abs(), dim=-1, keepdim=True)
    keep = w > rel_threshold * w_max
    inv_w = torch.where(keep, 1.0 / torch.where(keep, w, torch.ones_like(w)), torch.zeros_like(w))
    return _matvec(V, inv_w * _matvec(V.transpose(-1, -2), b))


def solve_svd(J, r, w=None):
    """Minimum-norm least-squares solve of J x = -r by SVD, ``J`` [M, 6],
    ``r`` [M], optional weights [M] applied as sqrt(w) row scaling.
    Singular values at or below eps * max(M, 6) x the largest are dropped
    (the cut of ``jnp.linalg.lstsq``)."""
    if w is not None:
        sw = torch.sqrt(w)
        J = J * sw.unsqueeze(-1)
        r = r * sw
    U, s, Vh = torch.linalg.svd(J, full_matrices=False)
    cut = torch.finfo(J.dtype).eps * max(J.shape[-2:]) * torch.amax(s, dim=-1, keepdim=True)
    keep = s > cut
    inv_s = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)), torch.zeros_like(s))
    return _matvec(Vh.transpose(-1, -2), inv_s * _matvec(U.transpose(-1, -2), -r))
