"""Robust t-distribution statistics for the bivariate (r_I, r_Z) residuals
(port of the t-distribution part of ``dvo_slam_tpu.ops.robust``).

Huber/Tukey weights and the normal/MAD scale estimators belong to the
modular oracle path, which this slice does not port.
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
    """Invert the 2x2 scale matrix with variance floors, by the explicit
    adjugate formula."""
    s00 = sigma[0, 0] + SIGMA_FLOOR_INTENSITY
    s01 = sigma[0, 1]
    s10 = sigma[1, 0]
    s11 = sigma[1, 1] + SIGMA_FLOOR_DEPTH
    det = torch.clamp(s00 * s11 - s01 * s10, min=1e-30)
    inv = torch.stack([torch.stack([s11, -s01]), torch.stack([-s10, s00])])
    return inv / det


def mahalanobis_sq(residuals, precision):
    """Per-residual squared Mahalanobis distance r^T P r ([N, 2] -> [N])."""
    return torch.einsum("ni,ij,nj->n", residuals, precision, residuals)


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
