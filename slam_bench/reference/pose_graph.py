"""Plain SE(3) pose-graph optimisation: the reference of the SLAM map.

The cost is the program's documented one (the g2o ``EdgeSE3`` model of
Kümmerle et al., "g2o: A General Framework for Graph Optimization", ICRA
2011, as DVO-SLAM uses it): vertices are camera-to-world poses T, updated
on the right (T <- T exp(dx), twist [v, w]); an edge (i, j) with
measurement M and information O has the residual r = log(M^-1 T_i^-1
T_j) and the cost r^T O r, and a robust edge the Cauchy cost d^2 log(1 +
r^T O r / d^2) with d = 5; the first vertex is fixed (the gauge).

It minimises that cost by Levenberg-Marquardt on the dense normal
equations of the free vertices: the Gauss-Newton Hessian of the
IRLS-weighted edges (a robust edge weighs 1 / (1 + chi2 / d^2)), the
residual's Jacobians from the second-order inverse right Jacobian of the
log, Jr^-1(r) = I + ad(r) / 2 + ad(r)^2 / 12, damping lambda diag(H)
(Marquardt's scaling), a step kept only if it lowers the cost, and a run
that stops once a kept step moves no pose by more than ``STEP_TOL``.  The
reference's own C++ (dvo_slam's keyframe graph) minimises the same cost
with g2o's Dogleg; a different descent reaches the same minimum.

Plain ``torch`` in ``dtype`` (float64 by default; the control runs it in
float32), on any device; its SE(3) exponential and logarithm switch to
their series below an angle that suits the precision.  It imports nothing
of the program.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .tracker import _hat, _rigid, inverse

CAUCHY_DELTA = 5.0
MAX_ITERATIONS = 200
STEP_TOL = 1e-12  # metres and radians: a kept step this small has converged
LAMBDA_START = 1e-6
LAMBDA_MAX = 1e12


class Graph(NamedTuple):
    """A pose graph: ``poses`` [N, 4, 4] camera to world, ``fixed`` [N]
    bool (the gauge), and per edge ``i``, ``j`` [E] vertex indices,
    ``measurement`` [E, 4, 4] (T_i^-1 T_j when the edge holds exactly),
    ``information`` [E, 6, 6] and ``robust`` [E] bool."""

    poses: torch.Tensor
    fixed: torch.Tensor
    i: torch.Tensor
    j: torch.Tensor
    measurement: torch.Tensor
    information: torch.Tensor
    robust: torch.Tensor

    def to(self, device=None, dtype=None) -> "Graph":
        f = lambda t: t.to(device=device, dtype=dtype)  # noqa: E731
        d = lambda t: t.to(device=device)  # noqa: E731
        return Graph(f(self.poses), d(self.fixed), d(self.i), d(self.j), f(self.measurement),
                     f(self.information), d(self.robust))


def _small(theta_sq):
    """Where the closed forms give way to their series: below this angle
    squared the closed forms lose more than the series' truncation
    (theta^6), in float64 and in float32 alike."""
    return theta_sq < (1e-6 if theta_sq.dtype == torch.float64 else 1e-2)


def _coefficients(theta_sq):
    """sin(t) / t, (1 - cos t) / t^2, (t - sin t) / t^3, and
    (1 - t sin t / (2 (1 - cos t))) / t^2 (the log's), each from its closed
    form or, for small angles, its series to t^4."""
    small = _small(theta_sq)
    t2 = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    t = torch.sqrt(t2)
    sin, half = torch.sin(t), torch.sin(0.5 * t)
    a = sin / t
    b = 2.0 * half * half / t2
    c = (t - sin) / (t2 * t)
    d = (1.0 - a / (2.0 * b)) / t2
    s2, s4 = theta_sq, theta_sq * theta_sq
    series = (1.0 - s2 / 6.0 + s4 / 120.0, 0.5 - s2 / 24.0 + s4 / 720.0,
              1.0 / 6.0 - s2 / 120.0 + s4 / 5040.0, 1.0 / 12.0 + s2 / 720.0 + s4 / 30240.0)
    return tuple(torch.where(small, x, y) for x, y in zip(series, (a, b, c, d)))


def exp_se3(xi):
    """The rigid transform [..., 4, 4] of a twist [v, w]."""
    v, w = xi[..., :3], xi[..., 3:]
    a, b, c, _ = _coefficients((w * w).sum(-1))
    W = _hat(w)
    W2 = W @ W
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye + a[..., None, None] * W + b[..., None, None] * W2
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    return _rigid(R, (V @ v[..., None])[..., 0])


def log_se3(T):
    """The twist [v, w] of a rigid transform [..., 4, 4]."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    skew = 0.5 * (R - R.transpose(-1, -2))
    s = torch.stack([skew[..., 2, 1], skew[..., 0, 2], skew[..., 1, 0]], -1)
    sin_t = s.norm(dim=-1)
    cos_t = 0.5 * (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0)
    theta = torch.atan2(sin_t, cos_t)
    small = _small(theta * theta)
    factor = torch.where(small, 1.0 + theta * theta / 6.0,
                         theta / torch.where(small, torch.ones_like(sin_t), sin_t))
    w = factor[..., None] * s
    _, _, _, d = _coefficients((w * w).sum(-1))
    W = _hat(w)
    eye = torch.eye(3, dtype=T.dtype, device=T.device)
    V_inv = eye - 0.5 * W + d[..., None, None] * (W @ W)
    return torch.cat([(V_inv @ t[..., None])[..., 0], w], -1)


def residuals(g: Graph, poses: torch.Tensor):
    """(r [E, 6], chi2 [E]) at ``poses``."""
    d = inverse(g.measurement) @ inverse(poses[g.i]) @ poses[g.j]
    r = log_se3(d)
    chi2 = torch.einsum("ea,eab,eb->e", r, g.information, r)
    return r, chi2


def weights(g: Graph, chi2: torch.Tensor, delta: float = CAUCHY_DELTA):
    """The IRLS weight of each edge: Cauchy's 1 / (1 + chi2 / d^2) on a
    robust edge, 1 elsewhere."""
    return torch.where(g.robust, 1.0 / (1.0 + chi2 / (delta * delta)), torch.ones_like(chi2))


def cost(g: Graph, poses: torch.Tensor, delta: float = CAUCHY_DELTA) -> torch.Tensor:
    _, chi2 = residuals(g, poses)
    d2 = delta * delta
    return torch.where(g.robust, d2 * torch.log1p(chi2 / d2), chi2).sum()


def _ad(xi):
    """The small adjoint of a twist [v, w]: [[hat w, hat v], [0, hat w]]."""
    hv, hw = _hat(xi[..., :3]), _hat(xi[..., 3:])
    return torch.cat([torch.cat([hw, hv], -1), torch.cat([torch.zeros_like(hw), hw], -1)], -2)


def _adjoint(T):
    """Ad(T) = [[R, hat(t) R], [0, R]]."""
    R = T[..., :3, :3]
    top = torch.cat([R, _hat(T[..., :3, 3]) @ R], -1)
    return torch.cat([top, torch.cat([torch.zeros_like(R), R], -1)], -2)


def normal_equations(g: Graph, poses: torch.Tensor, delta: float = CAUCHY_DELTA):
    """(H [6N, 6N], b [6N]) of the IRLS-weighted Gauss-Newton step, over
    every vertex (the fixed ones included)."""
    r, chi2 = residuals(g, poses)
    W = weights(g, chi2, delta)[:, None, None] * g.information
    a = _ad(r)
    eye = torch.eye(6, dtype=r.dtype, device=r.device)
    jr_inv = eye + 0.5 * a + (a @ a) / 12.0
    # d r / d dx_j = Jr^-1(r); d r / d dx_i = -Jr^-1(r) Ad(T_j^-1 T_i)
    J_j = jr_inv
    J_i = -jr_inv @ _adjoint(inverse(poses[g.j]) @ poses[g.i])
    n = poses.shape[0]
    H = torch.zeros(n, n, 6, 6, dtype=r.dtype, device=r.device)
    b = torch.zeros(n, 6, dtype=r.dtype, device=r.device)
    for Ja, ia in ((J_i, g.i), (J_j, g.j)):
        b.index_put_((ia,), torch.einsum("eba,ebc,ec->ea", Ja, W, r), accumulate=True)
        for Jb, ib in ((J_i, g.i), (J_j, g.j)):
            H.index_put_((ia, ib), Ja.transpose(-1, -2) @ W @ Jb, accumulate=True)
    return H.permute(0, 2, 1, 3).reshape(6 * n, 6 * n), b.reshape(6 * n)


class Solution(NamedTuple):
    poses: torch.Tensor  # [N, 4, 4]
    iterations: int  # kept and refused steps
    cost: float


def optimize(g: Graph, poses: torch.Tensor = None, max_iterations: int = MAX_ITERATIONS,
             delta: float = CAUCHY_DELTA, step_tol: float = STEP_TOL) -> Solution:
    """Levenberg-Marquardt from ``poses`` (the graph's where None) to the
    cost's minimum: at most ``max_iterations`` steps, ending once a kept
    step moves no pose by more than ``step_tol`` or no step lowers the
    cost at the largest damping."""
    poses = g.poses if poses is None else poses
    free = ~g.fixed
    idx = torch.nonzero(free.repeat_interleave(6)).flatten()
    n = poses.shape[0]
    lam = LAMBDA_START
    current = cost(g, poses, delta)
    it = 0
    for it in range(1, max_iterations + 1):
        H, b = normal_equations(g, poses, delta)
        Hf, bf = H[idx][:, idx], b[idx]
        damped = Hf + lam * torch.diag(torch.diagonal(Hf))
        step = torch.linalg.solve(damped, -bf)
        dx = torch.zeros(6 * n, dtype=poses.dtype, device=poses.device)
        dx[idx] = step
        candidate = poses @ exp_se3(dx.reshape(n, 6))
        new = cost(g, candidate, delta)
        if torch.isfinite(new) and new < current:
            poses, current = candidate, new
            lam = max(lam / 10.0, 1e-12)
            if float(step.abs().max()) <= step_tol:
                break
        else:
            lam *= 10.0
            if lam > LAMBDA_MAX:
                break
    return Solution(poses, it, float(current))


def prune(g: Graph, poses: torch.Tensor, threshold: float, delta: float = CAUCHY_DELTA):
    """The graph without its robust edges whose Cauchy weight at ``poses``
    is below ``threshold`` (the outliers), and the mask of those taken out."""
    _, chi2 = residuals(g, poses)
    out = g.robust & (weights(g, chi2, delta) < threshold)
    keep = ~out
    return Graph(poses, g.fixed, g.i[keep], g.j[keep], g.measurement[keep],
                 g.information[keep], g.robust[keep]), out


def final_pass(g: Graph, rounds: int, iterations: int, threshold: float,
               delta: float = CAUCHY_DELTA):
    """The final optimisation's schedule: ``rounds`` times optimise (at most
    ``iterations`` steps) and take out the outliers.  Returns (poses, the
    kept edges' mask over ``g``'s edges)."""
    kept = torch.ones(g.i.shape[0], dtype=torch.bool, device=g.i.device)
    poses = g.poses
    for _ in range(rounds):
        poses = optimize(g, poses, iterations, delta).poses
        g, out = prune(g, poses, threshold, delta)
        where = torch.nonzero(kept).flatten()
        kept[where[out]] = False
    return poses, kept


def pose_gaps(a: torch.Tensor, b: torch.Tensor):
    """(translation m, rotation rad) [N] between two sets of poses [N, 4, 4],
    each taken relative to its own first vertex: the twist of
    (b_0^-1 b_k)^-1 (a_0^-1 a_k)."""
    ra = inverse(a[:1]) @ a
    rb = inverse(b[:1]) @ b
    d = log_se3(inverse(rb) @ ra)
    return d[..., :3].norm(dim=-1), d[..., 3:].norm(dim=-1)
