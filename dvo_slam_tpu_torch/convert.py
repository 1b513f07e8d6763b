"""Carry state between the reference and the port.

The system has no learned weights: its state is configs, pyramids,
prepared frames and tracking results.  These helpers take the reference's
NamedTuples (any array that ``numpy.asarray`` accepts, JAX arrays
included) and return the port's, or bring a port result back to NumPy.
The configs move both ways by field name and enum member name.  Nothing
here imports JAX or the reference package: conversion goes through NumPy,
and the caller hands ``config_to_reference`` the reference's config module.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Sequence

import numpy as np
import torch

from . import config as _config
from .models.dense_tracker import (
    IterationStats,
    LevelStats,
    PreparedFrame,
    TrackingResult,
)
from .ops.pyramid import PyramidLevel


def _convert_config(value, module):
    """A config dataclass (nested ones included) or enum member rebuilt from
    the same-named classes of ``module``; other values as they are.  A field
    or member that ``module`` lacks raises."""
    if dataclasses.is_dataclass(value):
        cls = getattr(module, type(value).__name__)
        return cls(**{
            f.name: _convert_config(getattr(value, f.name), module)
            for f in dataclasses.fields(value)
        })
    if isinstance(value, enum.Enum):
        return getattr(module, type(value).__name__)[value.name]
    return value


def config_to_reference(cfg, reference_config):
    """The port's ``TrackerConfig``/``KeyframeConfig``/``GraphConfig``/
    ``SlamConfig`` as the classes of ``reference_config``, the reference's
    config module."""
    return _convert_config(cfg, reference_config)


def config_from_reference(cfg):
    """A reference config (any of the four classes) as the port's."""
    return _convert_config(cfg, _config)


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
