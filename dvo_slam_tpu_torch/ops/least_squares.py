"""6-DoF normal-equation solve (port of ``solve_ldlt`` from
``dvo_slam_tpu.ops.least_squares``).

The Cholesky factorisation runs one column at a time with vector ops:
on CUDA every tensor op is one launch, so a column loop costs ~90
launches where the reference's scalar unroll would cost ~150.  The sums
inside a column are dot products here and sequential scalar sums in the
reference; the two agree to float32 rounding (rtol 1e-5 in the tests).
"""

from __future__ import annotations

import torch

_PIVOT_FLOOR = 1e-20


def _cholesky_solve_unrolled(A, b, n: int = 6):
    """Cholesky solve of a tiny SPD system.  Diagonal pivots are floored at
    1e-20, so a singular system yields large but finite steps."""
    L = torch.zeros_like(A)
    for j in range(n):
        s = A[j:, j] - L[j:, :j] @ L[j, :j]
        pivot = torch.sqrt(torch.clamp(s[0], min=_PIVOT_FLOOR))
        L[j, j] = pivot
        L[j + 1 :, j] = s[1:] / pivot
    # forward substitution L y = b
    y = torch.zeros_like(b)
    for i in range(n):
        y[i] = (b[i] - L[i, :i] @ y[:i]) / L[i, i]
    # back substitution L^T x = y
    x = torch.zeros_like(b)
    for i in reversed(range(n)):
        x[i] = (y[i] - L[i + 1 :, i] @ x[i + 1 :]) / L[i, i]
    return x


def solve_ldlt(A, b):
    """Solve the 6x6 system with symmetric Jacobi pre-scaling:
    D^-1/2 A D^-1/2 y = D^-1/2 b, x = D^-1/2 y (equilibration recovers the
    conditioning the original buys with a float64 LDLT)."""
    d = torch.sqrt(torch.clamp(torch.diagonal(A), min=_PIVOT_FLOOR))
    d_inv = 1.0 / d
    A_s = A * d_inv[:, None] * d_inv[None, :]
    b_s = b * d_inv
    y = _cholesky_solve_unrolled(A_s, b_s)
    return y * d_inv
