"""Robust weighting statistics for the bivariate (r_I, r_Z) residuals
(port of ``dvo_slam_tpu.ops.robust``): the bivariate t-distribution of the
production path, and the univariate influence functions (Huber, Tukey, t)
and scale estimators (normal, MAD) of the reference's registry, which the
tracker's modular path reads.

Every function of the modular path takes an optional leading [B] axis:
residuals [..., N, 2], masks [..., N], precisions [..., 2, 2]; the sums
and the median run over the pixel axis of each stream.
"""

from __future__ import annotations

import torch

TDIST_DOF = 5.0  # TDistributionScaleEstimator::DEFAULT_DOF

# Variance floors added to the 2x2 scale matrix before inversion: inert on
# real sensor data (std 0.05/255 gray levels, 0.1 mm), they keep the
# float32 inversion well conditioned when a variance goes to zero.  The
# fused kernel's in-kernel precision uses the same floors, bit for bit.
SIGMA_FLOOR_INTENSITY = (0.05 / 255.0) ** 2
SIGMA_FLOOR_DEPTH = 1e-4**2


def precision_from_scale(sigma):
    """Invert the 2x2 scale matrix (or a batch [..., 2, 2]) with variance
    floors, by the explicit adjugate formula."""
    s00 = sigma[..., 0, 0] + SIGMA_FLOOR_INTENSITY
    s01 = sigma[..., 0, 1]
    s10 = sigma[..., 1, 0]
    s11 = sigma[..., 1, 1] + SIGMA_FLOOR_DEPTH
    det = torch.clamp(s00 * s11 - s01 * s10, min=1e-30)
    inv = torch.stack(
        [torch.stack([s11, -s01], dim=-1), torch.stack([-s10, s00], dim=-1)], dim=-2
    )
    return inv / det[..., None, None]


def mahalanobis_sq(residuals, precision, mean=None):
    """Per-residual squared Mahalanobis distance r^T P r ([..., N, 2] ->
    [..., N]), of ``residuals - mean`` where a mean is given."""
    if mean is not None:
        residuals = residuals - mean
    return torch.einsum("...ni,...ij,...nj->...n", residuals, precision, residuals)


def tdist_weights(residuals, precision, mask, dof: float = TDIST_DOF):
    """IRLS weights w = (dof + 2) / (dof + r^T P r) of the bivariate
    t-distribution, zero outside ``mask``."""
    d2 = mahalanobis_sq(residuals, precision)
    w = torch.full_like(d2, dof + 2.0) / (dof + d2)  # one rounding, as the reference
    return torch.where(mask, w, torch.zeros_like(w))


def tdist_log_likelihood_cm(residuals_cm, precision, mask, dof: float = TDIST_DOF):
    """Complete-data t-distribution log-likelihood with channel-major
    residuals [2, N]:
      0.5 n log det(P) - 0.5 (dof + 2) sum_i log(1 + r^T P r / dof)."""
    r_i, r_z = residuals_cm[0], residuals_cm[1]
    p00, p01, p11 = precision[0, 0], precision[0, 1], precision[1, 1]
    d2 = r_i * (p00 * r_i + p01 * r_z) + r_z * (p01 * r_i + p11 * r_z)
    n = mask.sum().to(r_i.dtype)
    log_terms = torch.where(mask, torch.log1p(d2 / dof), torch.zeros_like(d2))
    det = p00 * p11 - p01 * p01
    logdet = torch.log(torch.clamp(det, min=1e-38))
    return 0.5 * n * logdet - 0.5 * (dof + 2.0) * torch.sum(log_terms)


def tdist_scale(residuals, weights, num_valid, dof: float = TDIST_DOF):
    """Weighted 2x2 scale matrix Sigma = 1/(n-3) sum_i w_i r_i r_i^T (zero
    mean; masked residuals are zero, so the plain sum is the masked one)."""
    outer = torch.einsum("...ni,...nj->...ij", residuals * weights.unsqueeze(-1), residuals)
    denom = torch.clamp(num_valid.to(residuals.dtype) - 3.0, min=1.0)
    return outer / denom[..., None, None]


def tdist_log_likelihood(residuals, precision, mask, dof: float = TDIST_DOF):
    """Complete-data t-distribution log-likelihood with channel-last
    residuals [..., N, 2]:
      0.5 n log det(P) - 0.5 (dof + 2) sum_i log(1 + r^T P r / dof)."""
    n = mask.sum(dim=-1).to(residuals.dtype)
    d2 = mahalanobis_sq(residuals, precision)
    # a tensor divisor: the same rounding on the card as on the CPU (see
    # camera.unproject)
    log_terms = torch.where(mask, torch.log1p(d2 / torch.full_like(d2, dof)), torch.zeros_like(d2))
    det = precision[..., 0, 0] * precision[..., 1, 1] - precision[..., 0, 1] * precision[..., 1, 0]
    logdet = torch.log(torch.clamp(det, min=1e-38))
    return 0.5 * n * logdet - 0.5 * (dof + 2.0) * torch.sum(log_terms, dim=-1)


def tdist_fixed_point(residuals, mask, num_iters: int = 10, dof: float = TDIST_DOF):
    """The standalone fixed-point iteration for the t-distribution scale,
    from the unit scale (the tracker interleaves one step per Gauss-Newton
    iteration instead)."""
    num_valid = mask.sum(dim=-1, dtype=torch.int32)
    sigma = torch.eye(2, dtype=residuals.dtype, device=residuals.device).expand(
        residuals.shape[:-2] + (2, 2))
    for _ in range(num_iters):
        w = tdist_weights(residuals, precision_from_scale(sigma), mask, dof)
        sigma = tdist_scale(residuals, w, num_valid, dof)
    return sigma


def huber_weights(x, k: float = 1.345):
    """Huber influence: 1 inside k, k/|x| outside."""
    ax = x.abs()
    # a full tensor over a tensor: one rounding (a scalar over a tensor is
    # a reciprocal and a product in PyTorch)
    return torch.where(ax < k, torch.ones_like(ax), torch.full_like(ax, k) / torch.clamp(ax, min=1e-12))


def tukey_weights(x, b: float = 4.685):
    """Tukey biweight: (1 - (x/b)^2)^2 inside b, 0 outside."""
    ax = x.abs()
    t = 1.0 - (ax / torch.full_like(ax, b)) ** 2
    return torch.where(ax <= b, t * t, torch.zeros_like(t))


def tdist_weights_1d(x, dof: float = TDIST_DOF):
    """Univariate t-distribution influence (dof + 1) / (dof + x^2)."""
    return torch.full_like(x, dof + 1.0) / (dof + x * x)


def normal_scale(x, mask):
    """Unbiased standard deviation of the masked entries of ``x`` [..., N]."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    n = torch.clamp(mask.sum(dim=-1).to(x.dtype), min=2.0)
    mean = torch.sum(torch.where(mask, x, zero), dim=-1) / n
    var = torch.sum(torch.where(mask, (x - mean.unsqueeze(-1)) ** 2, zero), dim=-1) / (n - 1.0)
    return torch.sqrt(var)


def mad_scale(x, mask):
    """Median absolute deviation of the masked entries of ``x`` [..., N],
    scaled by 1.4826 for normal consistency (an exact sort where the
    original approximates the median by a histogram)."""
    big = torch.full((), float("inf"), dtype=x.dtype, device=x.device)
    n = mask.sum(dim=-1)
    med = _masked_median(torch.where(mask, x, big), n)
    abs_dev = torch.where(mask, (x - med.unsqueeze(-1)).abs(), big)
    return 1.4826 * _masked_median(abs_dev, n)


def _masked_median(x, n):
    """Entry n // 2 of the sorted last axis of ``x`` [..., N] (the masked
    entries pushed to +inf): the upper median for an even count, as the
    original indexes it (``torch.median`` would take the lower one)."""
    s = torch.sort(x, dim=-1).values
    idx = torch.clamp(torch.div(n, 2, rounding_mode="floor"), 0, s.shape[-1] - 1)
    return torch.gather(s, -1, idx.to(torch.int64).unsqueeze(-1)).squeeze(-1)
