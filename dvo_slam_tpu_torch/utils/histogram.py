"""Histogram utilities (port of ``dvo_slam_tpu.utils.histogram``): the
reference's 1-D histogram, its bin-centre median and its entropy, for
diagnostics and tests (the MAD scale estimator sorts instead,
``ops/robust.py``)."""

from __future__ import annotations

import torch


def compute_histogram(data, mask, bins: int, min_value: float, max_value: float):
    """1-D float32 histogram [bins] of the masked entries of ``data``."""
    scale = bins / (max_value - min_value)
    idx = torch.clamp(((data - min_value) * scale).to(torch.int32), 0, bins - 1)
    hist = torch.zeros(bins, dtype=torch.float32, device=data.device)
    return hist.index_add_(0, idx.reshape(-1).to(torch.int64),
                           mask.to(torch.float32).reshape(-1))


def median_from_histogram(hist, min_value: float, max_value: float):
    """Bin-centre median: the centre of the first bin whose cumulative
    count reaches half the total."""
    total = torch.sum(hist)
    cdf = torch.cumsum(hist, dim=0)
    median_bin = torch.argmax((cdf >= 0.5 * total).to(torch.int32))
    width = (max_value - min_value) / hist.shape[0]
    return min_value + (median_bin.to(torch.float32) + 0.5) * width


def entropy_from_histogram(hist):
    """Shannon entropy of the histogram in bits."""
    total = torch.clamp(torch.sum(hist), min=1e-12)
    p = hist / total
    terms = torch.where(p > 0, -p * torch.log2(torch.clamp(p, min=1e-30)), torch.zeros_like(p))
    return torch.sum(terms)
