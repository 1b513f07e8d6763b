"""Carry state between the reference and the port.

The system has no learned weights: its state is pyramids, prepared
frames and tracking results.  These helpers take the reference's
NamedTuples (any array that ``numpy.asarray`` accepts, JAX arrays
included) and return the port's, or bring a port result back to NumPy.
They import nothing of JAX: conversion goes through NumPy.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .models.dense_tracker import (
    IterationStats,
    LevelStats,
    PreparedFrame,
    TrackingResult,
)
from .ops.pyramid import PyramidLevel


def _to_tensor(a, device) -> Optional[torch.Tensor]:
    if a is None:
        return None
    return torch.from_numpy(np.array(a)).to(device)


def _to_numpy(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def levels_from_numpy(levels: Sequence, device="cpu"):
    """Reference ``PyramidLevel`` tuple (None entries kept) -> the port's."""
    return tuple(
        None if lv is None else PyramidLevel(*(_to_tensor(f, device) for f in lv))
        for lv in levels
    )


def prepared_from_numpy(prepared, device="cpu") -> PreparedFrame:
    """Reference ``PreparedFrame`` -> the port's: the fused path's
    selection masks, refpacks and quad tables (the reference's levels and
    acceleration tensors are not carried: the fused path never reads them)."""
    tensors = lambda entries: tuple(_to_tensor(a, device) for a in entries)  # noqa: E731
    return PreparedFrame(
        sel=tensors(prepared.sel),
        refpack=tensors(prepared.refpack),
        quad=tensors(prepared.quad),
    )


def result_to_numpy(result: TrackingResult) -> TrackingResult:
    """A port ``TrackingResult`` with every tensor as a NumPy array."""
    return TrackingResult(
        transformation=_to_numpy(result.transformation),
        information=_to_numpy(result.information),
        neg_log_likelihood=_to_numpy(result.neg_log_likelihood),
        level_stats=tuple(
            LevelStats(*(_to_numpy(f) for f in s)) for s in result.level_stats
        ),
        iteration_stats=tuple(
            IterationStats(*(_to_numpy(f) for f in s)) for s in result.iteration_stats
        ),
    )
