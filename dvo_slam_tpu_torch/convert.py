"""Carry state between the reference and the port.

The system has no learned weights: its state is configs, pyramids,
frames, prepared frames, pose graphs and tracking results.  These helpers
take the reference's objects (any array that ``numpy.asarray`` accepts,
JAX arrays included) and return the port's, or bring a port result back
to NumPy.
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
from . import default_device
from .models.dense_tracker import (
    IterationStats,
    LevelStats,
    PreparedFrame,
    TrackingResult,
)
from .models.evaluation import RestoredEvaluation, evaluation_state
from .models.frames import Frame, Keyframe
from .models.pose_graph import PoseGraph
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


def levels_from_numpy(levels: Sequence, device=None):
    """Reference ``PyramidLevel`` tuple (None entries kept) -> the port's,
    on the card unless ``device`` names another (``default_device``)."""
    device = default_device(device)
    return tuple(
        None if lv is None else PyramidLevel(*(_to_tensor(f, device) for f in lv))
        for lv in levels
    )


def prepared_from_numpy(prepared, device=None) -> PreparedFrame:
    """Reference ``PreparedFrame`` -> the port's: the selection masks,
    refpacks, quad tables and acceleration tensors (the reference's levels
    are not carried: the port reads the reference level from the refpack),
    on the card unless ``device`` names another (``default_device``)."""
    device = default_device(device)
    tensors = lambda entries: tuple(_to_tensor(a, device) for a in entries)  # noqa: E731
    return PreparedFrame(
        sel=tensors(prepared.sel),
        refpack=tensors(prepared.refpack),
        quad=tensors(prepared.quad),
        accel=tensors(prepared.accel),
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


def frame_from_reference(frame, device=None) -> Frame:
    """Reference ``Frame`` -> the port's (its levels and timestamp; the
    prepared cache is not carried), on the card unless ``device`` names
    another (``default_device``)."""
    return Frame(levels=levels_from_numpy(frame.levels, device), timestamp=frame.timestamp)


def keyframe_from_reference(keyframe, device=None) -> Keyframe:
    """Reference ``Keyframe`` -> the port's: its id, frame
    (``frame_from_reference``), pose (float64) and evaluation, whose running
    statistics come across as a ``RestoredEvaluation`` (None stays None)."""
    state = evaluation_state(keyframe.evaluation)
    return Keyframe(
        id=keyframe.id,
        frame=frame_from_reference(keyframe.frame, device),
        pose=np.array(keyframe.pose, np.float64),
        evaluation=None if state is None else RestoredEvaluation(state),
    )


# the container's storage: per-vertex and per-edge arrays, then the rest
_VERTEX_ARRAYS = ("poses", "fixed")
_EDGE_ARRAYS = ("edge_i", "edge_j", "measurements", "information", "edge_active", "robust",
                "edge_level")


def pose_graph_from_reference(graph) -> PoseGraph:
    """Reference ``PoseGraph`` -> the port's: a copy of its arrays (at their
    capacity), dtype, vertex keys and edge index, in a fresh container (its
    caches and memos empty), so that the same graph goes into both
    packages' solvers."""
    out = PoseGraph(dtype=graph.dtype)
    for name in _VERTEX_ARRAYS + _EDGE_ARRAYS:
        setattr(out, name, np.array(getattr(graph, name)))
    out._n, out._e = graph.num_vertices, graph.num_edges
    out._vertex_ids = dict(graph._vertex_ids)
    out._edge_index = {pair: list(edges) for pair, edges in graph._edge_index.items()}
    return out


def pose_graph_to_numpy(graph) -> dict:
    """Either package's ``PoseGraph`` as NumPy copies of its used storage:
    ``keys`` (vertex keys in index order), the vertex arrays [:n] and the
    edge arrays [:e]."""
    n, e = graph.num_vertices, graph.num_edges
    keys = sorted(graph._vertex_ids, key=graph._vertex_ids.get)
    out = {"keys": keys}
    out.update({name: np.array(getattr(graph, name)[:n]) for name in _VERTEX_ARRAYS})
    out.update({name: np.array(getattr(graph, name)[:e]) for name in _EDGE_ARRAYS})
    return out
