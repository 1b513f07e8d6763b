"""Plain dense RGB-D alignment: the reference of the tracker's answers.

Coarse-to-fine IRLS Gauss-Newton on SE(3) with the bivariate
t-distribution (Kerl, Sturm and Cremers, "Robust Odometry Estimation for
RGB-D Cameras", ICRA 2013; "Dense Visual SLAM for RGB-D Cameras", IROS
2013), in the form the program documents and the JAX package holds it to
(a copy of the mathematics of ``dvo_slam_tpu_torch/ops/pyramid.py``,
``ops/residuals.py``, ``ops/interp.py``, ``ops/robust.py``, ``ops/se3.py``
and ``models/dense_tracker.py``'s ``_step`` / ``match_prepared``, written
again as plain tensor code):

* pyramid: intensity 2x2 means, depth every second pixel, central
  differences with clamped borders, depth derivatives gated at 0.3 m;
  reference points: valid depth and derivatives and a non-zero gradient;
* per iteration: warp the reference points by the estimate, bilinear
  sample of the current level depth-buffered at 5 cm, photometric and
  geometric residuals with the occlusion gate, unit weights on a level's
  first iteration and t-distribution weights (dof 5) from the previous
  precision after it, the new 2x2 precision from the weighted scale, the
  log-likelihood, the 6x6 normal equations with the prior mu toward the
  initial guess; a step that raises the negative log-likelihood is
  reverted and ends the level; the level ends when the increment's
  largest entry is at most ``precision`` or at ``max_iterations``.

Pairs are aligned in lockstep, B at a time, each with its own ``done``
flag (a finished pair's state is frozen).  It computes in ``dtype``
(float64 by default).  Contractions are matrix products (the warp through
the 3x4 projection matrix, the normal equations), so that the control,
float32 with TF32 matrix products, rounds where a lower precision would.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

DEPTH_SCALE = 5000.0
MAX_DEPTH_DERIVATIVE_M = 0.3
DEPTH_BUFFER_M = 0.05
SIGMA_FLOOR_I = (0.05 / 255.0) ** 2
SIGMA_FLOOR_Z = 1e-4**2
INFORMATION_SCALE = 0.008 * 0.008


class Settings(NamedTuple):
    """The tracker settings a configuration states (the fields of its
    ``tracker`` group that the alignment reads)."""

    first_level: int
    last_level: int
    max_iterations: int
    precision: float
    mu: float
    dof: float

    @staticmethod
    def from_config(tracker: dict) -> "Settings":
        return Settings(
            first_level=int(tracker["first_level"]),
            last_level=int(tracker["last_level"]),
            max_iterations=int(tracker["max_iterations_per_level"]),
            precision=float(tracker["precision"]),
            mu=float(tracker["mu"]),
            dof=float(tracker["influence_function_param"]),
        )


# --- the control's matrix products ---------------------------------------------

def tf32_round(t):
    """``t`` (float32) rounded to TF32's 10 stored mantissa bits, to nearest
    (what a TF32 matrix product does to its operands)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_matmul(a, b):
    """A float32 matrix product whose operands are rounded to TF32 first:
    the control's products, the same on the CPU and the card."""
    return torch.matmul(tf32_round(a.to(torch.float32)), tf32_round(b.to(torch.float32)))


# --- SE(3), twist [v, w] ----------------------------------------------------

def _hat(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([z, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], z, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], z], -1),
    ], -2)


def _coefficients(theta_sq):
    """sin(t)/t, (1 - cos t)/t^2, (t - sin t)/t^3, with series below 1e-4."""
    theta = torch.sqrt(theta_sq)
    small = theta_sq < 1e-8
    safe = torch.where(small, torch.ones_like(theta), theta)
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(safe) / safe)
    b = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(safe)) / safe**2)
    c = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0, (safe - torch.sin(safe)) / safe**3)
    return a, b, c


def exp_se3(xi):
    v, w = xi[..., :3], xi[..., 3:]
    a, b, c = _coefficients((w * w).sum(-1))
    W = _hat(w)
    W2 = W @ W
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye + a[..., None, None] * W + b[..., None, None] * W2
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    return _rigid(R, (V @ v[..., None])[..., 0])


def log_se3(T):
    R, t = T[..., :3, :3], T[..., :3, 3]
    skew = 0.5 * (R - R.transpose(-1, -2))
    s = torch.stack([skew[..., 2, 1], skew[..., 0, 2], skew[..., 1, 0]], -1)
    sin_t = s.norm(dim=-1)
    cos_t = 0.5 * (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0)
    theta = torch.atan2(sin_t, cos_t)
    small = theta * theta < 1e-8
    factor = torch.where(small, 1.0 + theta * theta / 6.0,
                         theta / torch.where(small, torch.ones_like(sin_t), sin_t))
    w = factor[..., None] * s
    theta_sq = (w * w).sum(-1)
    a, b, _ = _coefficients(theta_sq)
    d = torch.where(theta_sq < 1e-8, 1.0 / 12.0 + theta_sq / 720.0,
                    (1.0 - a / (2.0 * b)) / torch.where(theta_sq < 1e-8,
                                                        torch.ones_like(theta_sq), theta_sq))
    W = _hat(w)
    eye = torch.eye(3, dtype=T.dtype, device=T.device)
    V_inv = eye - 0.5 * W + d[..., None, None] * (W @ W)
    return torch.cat([(V_inv @ t[..., None])[..., 0], w], -1)


def _rigid(R, t):
    top = torch.cat([R, t[..., None]], -1)
    bottom = torch.zeros(top.shape[:-2] + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], -2)


def inverse(T):
    Rt = T[..., :3, :3].transpose(-1, -2)
    return _rigid(Rt, -(Rt @ T[..., :3, 3:])[..., 0])


# --- pyramid ------------------------------------------------------------------

class Level(NamedTuple):
    """One level of B frames: [B, H, W] each; ``fx, fy, ox, oy`` scaled."""

    i: torch.Tensor
    z: torch.Tensor
    idx: torch.Tensor
    idy: torch.Tensor
    zdx: torch.Tensor
    zdy: torch.Tensor
    zvalid: torch.Tensor
    K: tuple


def _diff(img, dim):
    """(img[k + 1], img[k - 1]) along ``dim``, the borders clamped."""
    n = img.shape[dim]
    hi = torch.cat([img.narrow(dim, 1, n - 1), img.narrow(dim, n - 1, 1)], dim)
    lo = torch.cat([img.narrow(dim, 0, 1), img.narrow(dim, 0, n - 1)], dim)
    return hi, lo


def _level(i, z, valid, K):
    ihx, ilx = _diff(i, -1)
    ihy, ily = _diff(i, -2)
    zhx, zlx = _diff(z, -1)
    zhy, zly = _diff(z, -2)
    vhx, vlx = _diff(valid, -1)
    vhy, vly = _diff(valid, -2)
    zdx, zdy = 0.5 * (zhx - zlx), 0.5 * (zhy - zly)
    okx = vhx & vlx & (zdx.abs() <= MAX_DEPTH_DERIVATIVE_M)
    oky = vhy & vly & (zdy.abs() <= MAX_DEPTH_DERIVATIVE_M)
    zero = torch.zeros((), dtype=z.dtype, device=z.device)
    return Level(i=i, z=z, idx=0.5 * (ihx - ilx), idy=0.5 * (ihy - ily),
                 zdx=torch.where(okx, zdx, zero), zdy=torch.where(oky, zdy, zero),
                 zvalid=valid & okx & oky, K=K)


def pyramid(intensity_u8, depth_u16, intrinsics, levels: int, dtype=torch.float64):
    """Levels 0..levels-1 of raw frames [B, H, W] (u8 intensity, u16 depth
    at 1/5000 m, 0 invalid); ``intrinsics`` (fx, fy, ox, oy) of level 0."""
    i = intensity_u8.to(dtype)
    raw = depth_u16.to(torch.int32)
    valid = raw > 0
    z = torch.where(valid, raw.to(dtype) / DEPTH_SCALE, torch.zeros((), dtype=dtype,
                                                                     device=raw.device))
    fx, fy, ox, oy = (float(v) for v in intrinsics)
    out = []
    for level in range(levels):
        s = 0.5**level
        out.append(_level(i, z, valid, (fx * s, fy * s, ox * s, oy * s)))
        h2, w2 = i.shape[-2] // 2, i.shape[-1] // 2
        rows = 0.5 * i[..., 0:2 * h2:2, :] + 0.5 * i[..., 1:2 * h2:2, :]
        i = 0.5 * rows[..., 0:2 * w2:2] + 0.5 * rows[..., 1:2 * w2:2]
        z = z[..., 0:2 * h2:2, 0:2 * w2:2]
        valid = valid[..., 0:2 * h2:2, 0:2 * w2:2]
    return out


# --- one evaluation ---------------------------------------------------------

def _sample(cur: Level, u, v, z_expected):
    """Depth-buffered bilinear sample of the current level's channels
    (i, z, idx, idy, zdx, zdy) at (u, v) [B, N]: a neighbour contributes
    when its depth and derivatives are valid and it lies no more than 5 cm
    in front of ``z_expected``; weights renormalised.  Returns ([B, 6, N],
    valid [B, N])."""
    h, w = cur.i.shape[-2:]
    inside = (u >= 0) & (u < w - 1) & (v >= 0) & (v < h - 1)
    u = u.clamp(0.0, w - 1.001)
    v = v.clamp(0.0, h - 1.001)
    x0, y0 = torch.floor(u), torch.floor(v)
    fx1, fy1 = u - x0, v - y0
    base = (y0.long() * w + x0.long()).clamp(0, h * w - 1)
    chans = torch.stack([cur.i, cur.z, cur.idx, cur.idy, cur.zdx, cur.zdy,
                         cur.zvalid.to(cur.i.dtype)], 1).flatten(2)  # [B, 7, HW]
    acc = 0.0
    wsum = 0.0
    for dy, dx, wgt in ((0, 0, (1 - fx1) * (1 - fy1)), (0, 1, fx1 * (1 - fy1)),
                        (1, 0, (1 - fx1) * fy1), (1, 1, fx1 * fy1)):
        idx = (base + dy * w + dx).clamp(0, h * w - 1)
        nb = torch.gather(chans, 2, idx[:, None, :].expand(-1, chans.shape[1], -1))
        keep = (nb[:, 6] > 0.5) & (nb[:, 1] > z_expected - DEPTH_BUFFER_M)
        wk = wgt * keep.to(wgt.dtype)
        acc = acc + nb[:, :6] * wk[:, None]
        wsum = wsum + wk
    return acc / wsum.clamp(min=1e-6)[:, None], inside & (wsum > 1e-6)


class Evaluation(NamedTuple):
    n: torch.Tensor  # [B] int
    precision: torch.Tensor  # [B, 2, 2]
    ll: torch.Tensor  # [B]
    A: torch.Tensor  # [B, 6, 6]
    b: torch.Tensor  # [B, 6]


def evaluate(ref: Level, cur: Level, T, P_prev, first: bool, dof: float,
             mm=torch.matmul) -> Evaluation:
    """One IRLS evaluation of B pairs at warp T [B, 4, 4]; ``mm`` computes
    every matrix product of the evaluation."""
    fx, fy, ox, oy = ref.K
    B, h, w = ref.i.shape
    dtype, device = ref.i.dtype, ref.i.device
    vs, us = torch.meshgrid(torch.arange(h, dtype=dtype, device=device),
                            torch.arange(w, dtype=dtype, device=device), indexing="ij")
    z = ref.z.flatten(1)
    x = ((us - ox) / fx).flatten()[None] * z
    y = ((vs - oy) / fy).flatten()[None] * z
    pts = torch.stack([x, y, z, torch.ones_like(z)], -1)  # [B, N, 4]
    Kmat = torch.tensor([[fx, 0.0, ox], [0.0, fy, oy], [0.0, 0.0, 1.0]], dtype=dtype,
                        device=device)
    proj = mm(Kmat, T[:, :3, :])  # [B, 3, 4]
    uvw = mm(pts, proj.transpose(1, 2))  # [B, N, 3]
    z_t = uvw[..., 2]
    z_safe = torch.where(z_t > 1e-12, z_t, torch.full_like(z_t, 1e-12))
    sampled, ok = _sample(cur, uvw[..., 0] / z_safe, uvw[..., 1] / z_safe, z_t)
    i_c, z_c, idx_c, idy_c, zdx_c, zdy_c = sampled.unbind(1)

    r_i = (i_c - ref.i.flatten(1)) / 255.0
    r_z = z_c - z_t
    sigma = 0.0012 + 0.0019 * (z - 0.4) ** 2
    sel = ref.zvalid & ((ref.idx != 0) | (ref.idy != 0) | (ref.zdx != 0) | (ref.zdy != 0))
    mask = sel.flatten(1) & ok & (z_t > 1e-12) & (r_z > -20.0 * sigma)
    m = mask.to(dtype)
    r = torch.stack([r_i, r_z], -1) * m[..., None]  # [B, N, 2]
    n = mask.sum(-1)

    if first:
        wts = m
    else:
        d2 = (mm(r, P_prev) * r).sum(-1)
        wts = (dof + 2.0) / (dof + d2) * m
    scale = mm((r * wts[..., None]).transpose(1, 2), r)  # [B, 2, 2]
    scale = scale / (n.to(dtype) - 3.0).clamp(min=1.0)[:, None, None]
    scale = scale + torch.diag(torch.tensor([SIGMA_FLOOR_I, SIGMA_FLOOR_Z], dtype=dtype,
                                            device=device))
    P = torch.linalg.inv(scale)
    d2 = (mm(r, P) * r).sum(-1)
    ll = 0.5 * n.to(dtype) * torch.log(torch.linalg.det(P).clamp(min=1e-38)) \
        - 0.5 * (dof + 2.0) * (torch.log1p(d2 / dof) * m).sum(-1)

    # Jacobians at the reference points: the image gradients (the mean of
    # the two frames' for intensity, the current frame's for depth) through
    # the projection's derivative, minus the depth row of the transform's
    zr = torch.where(z.abs() > 1e-12, z, torch.full_like(z, 1e-12))
    iz = 1.0 / zr
    zero = torch.zeros_like(iz)
    jw0 = torch.stack([iz, zero, -x * iz * iz, -x * y * iz * iz, 1.0 + x * x * iz * iz,
                       -y * iz], -1)
    jw1 = torch.stack([zero, iz, -y * iz * iz, -(1.0 + y * y * iz * iz), x * y * iz * iz,
                       x * iz], -1)
    jz = torch.stack([zero, zero, torch.ones_like(iz), y, -x, zero], -1)
    gix = (0.5 * (idx_c + ref.idx.flatten(1)) * (fx / 255.0))[..., None]
    giy = (0.5 * (idy_c + ref.idy.flatten(1)) * (fy / 255.0))[..., None]
    J = torch.stack([gix * jw0 + giy * jw1,
                     (zdx_c * fx)[..., None] * jw0 + (zdy_c * fy)[..., None] * jw1 - jz],
                    2) * m[..., None, None]  # [B, N, 2, 6]
    PJ = mm(P[:, None], J).flatten(1, 2)  # [B, 2N, 6]
    WJ = (wts[..., None, None] * J).flatten(1, 2)
    A = mm(WJ.transpose(1, 2), PJ)
    A = 0.5 * (A + A.transpose(1, 2))
    Pr = mm(r, P.transpose(1, 2)).reshape(B, -1, 1)
    b = -mm(WJ.transpose(1, 2), Pr)[..., 0]
    return Evaluation(n=n, precision=P, ll=ll, A=A, b=b)


# --- the solve ----------------------------------------------------------------

def _sel(cond, new, old):
    return torch.where(cond.reshape(cond.shape + (1,) * (new.dim() - cond.dim())), new, old)


def align_level(s: Settings, ref: Level, cur: Level, x, T, initial, P, mm=torch.matmul):
    """The IRLS loop of one level for B pairs; returns the final state
    (x, T, initial, inc_applied, precision, A) and the iterations [B]."""
    B = x.shape[0]
    dtype, device = x.dtype, x.device
    eye6 = torch.eye(6, dtype=dtype, device=device)
    inc_applied = exp_se3(x)
    error = torch.full((B,), math.inf, dtype=dtype, device=device)
    A_keep = eye6.expand(B, 6, 6)
    iterations = torch.zeros(B, dtype=torch.int64, device=device)
    done = torch.zeros(B, dtype=torch.bool, device=device)
    first = True
    while not bool(done.all()):
        inc = exp_se3(x)
        T_new = inc @ T
        initial_new = inverse(inc) @ initial
        e = evaluate(ref, cur, T_new, P, first, s.dof, mm)
        first = False
        reject = (e.n < 6) | ~(-e.ll < error)
        A = e.A + s.mu * eye6
        b = e.b + s.mu * log_se3(initial_new)
        x_new = torch.linalg.solve(A, b[..., None])[..., 0]
        converged = x_new.abs().amax(-1) <= s.precision
        exceeded = iterations + 1 >= s.max_iterations
        step = ~done & ~reject
        x = _sel(step, x_new, x)
        T = _sel(step, T_new, T)
        initial = _sel(step, initial_new, initial)
        inc_applied = _sel(step, inc, inc_applied)
        P = _sel(step, e.precision, P)
        error = _sel(step, -e.ll, error)
        A_keep = _sel(step, A, A_keep)
        iterations = iterations + (~done).to(iterations.dtype)
        done = done | reject | converged | exceeded
    return x, T, initial, inc_applied, P, A_keep, iterations


class Alignment(NamedTuple):
    transformation: torch.Tensor  # [B, 4, 4] current camera in the reference frame
    information: torch.Tensor  # [B, 6, 6]
    iterations: torch.Tensor  # [B, levels] coarse first


def align(s: Settings, ref_levels, cur_levels, init=None, mm=torch.matmul) -> Alignment:
    """Align B current frames to B reference frames (pyramids from
    :func:`pyramid`); ``init`` [B, 4, 4] is the guess of the result (the
    current camera in the reference frame), the identity where None.  ``mm``
    computes the evaluations' matrix products."""
    B = ref_levels[0].i.shape[0]
    dtype, device = ref_levels[0].i.dtype, ref_levels[0].i.device
    guess = (torch.eye(4, dtype=dtype, device=device).expand(B, 4, 4) if init is None
             else inverse(init.to(dtype)))
    x = log_se3(guess)
    T = torch.eye(4, dtype=dtype, device=device).expand(B, 4, 4)
    initial = guess
    P = torch.eye(2, dtype=dtype, device=device).expand(B, 2, 2)
    its = []
    A = None
    for level in range(s.first_level, s.last_level - 1, -1):
        _, T, initial, inc_applied, P, A, it = align_level(
            s, ref_levels[level], cur_levels[level], x, T, initial, P, mm)
        x = log_se3(inc_applied)
        its.append(it)
    return Alignment(transformation=inverse(T), information=A * INFORMATION_SCALE,
                     iterations=torch.stack(its, -1))


def relative_gap(T_a, T_b):
    """(translation gap in metres, rotation gap in radians) [B] between two
    relative poses [B, 4, 4]: the twist of T_b^-1 T_a."""
    d = log_se3(inverse(T_b) @ T_a)
    return d[..., :3].norm(dim=-1), d[..., 3:].norm(dim=-1)
