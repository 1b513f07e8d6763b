"""Tracking-result quality statistics for the keyframe policy and loop
voting (port of ``dvo_slam_tpu.models.evaluation``, NumPy).

The reference's TrackingResultEvaluation hierarchy
(dvo_slam/src/tracking_result_evaluation.cpp:26-62): a running
first/average of a scalar quality value per keyframe, with ratio queries
used by the keyframe-switch criterion (keyframe_tracker.cpp:105-121) and
the loop-proposal entropy voter (constraint_proposal_voter.cpp:101-121).
"""

from __future__ import annotations

import numpy as np

from .dense_tracker import TrackingResult


class TrackingResultEvaluation:
    """Running first/average statistic; subclasses define value(r)."""

    def __init__(self, first_result: TrackingResult):
        self._first = self.value(first_result)
        self._average = self._first
        self._n = 1.0

    def value(self, r: TrackingResult) -> float:
        raise NotImplementedError

    def add(self, r: TrackingResult):
        self._average += self.value(r)
        self._n += 1.0

    def ratio_with_first(self, r: TrackingResult) -> float:
        return self.value(r) / self._first

    def ratio_with_average(self, r: TrackingResult) -> float:
        # reference: value(r) / average_ * n_ (tracking_result_evaluation.cpp:40)
        return self.value(r) / self._average * self._n


class LogLikelihoodEvaluation(TrackingResultEvaluation):
    """value = -Result.LogLikelihood (the front end's default,
    keyframe_tracker.cpp:98)."""

    def value(self, r: TrackingResult) -> float:
        return -float(r.neg_log_likelihood)


class NormalizedLogLikelihoodEvaluation(TrackingResultEvaluation):
    """value = -LogLikelihood / valid constraints."""

    def value(self, r: TrackingResult) -> float:
        n = max(int(r.last_level.valid_constraints), 1)
        return -float(r.neg_log_likelihood) / n


class EntropyEvaluation(TrackingResultEvaluation):
    """value = log det(Information), the 'entropy' variant."""

    def value(self, r: TrackingResult) -> float:
        sign, logdet = np.linalg.slogdet(np.asarray(r.information, np.float64))
        return float(logdet) if sign > 0 else -np.inf


_EVAL_KINDS = {
    "loglik": lambda r: -float(r.neg_log_likelihood),
    "normalized": lambda r: -float(r.neg_log_likelihood)
    / max(int(r.last_level.valid_constraints), 1),
    "entropy": lambda r: EntropyEvaluation.value(None, r),
}


def evaluation_kind(evaluation) -> str:
    """Serialization tag for an evaluation object (checkpoint/resume).  A
    RestoredEvaluation carries its original kind, so a save->load->save
    cycle keeps entropy/normalized evaluations."""
    kind = getattr(evaluation, "_kind", None)
    if kind is not None:
        return kind
    name = type(evaluation).__name__
    if "Normalized" in name:
        return "normalized"
    if "Entropy" in name:
        return "entropy"
    return "loglik"  # LogLikelihoodEvaluation and the streaming replay twin


def evaluation_state(evaluation):
    """(kind, first, average, n) of any evaluation object, or None."""
    if evaluation is None:
        return None
    return {
        "kind": evaluation_kind(evaluation),
        "first": float(evaluation._first),
        "average": float(evaluation._average),
        "n": float(evaluation._n),
    }


class RestoredEvaluation:
    """A TrackingResultEvaluation rebuilt from checkpointed running
    statistics; it answers like the class it was saved from, so the
    loop-closure entropy voter can keep voting against a restored
    keyframe's history."""

    def __init__(self, state: dict):
        self._first = state["first"]
        self._average = state["average"]
        self._n = state["n"]
        self._kind = state["kind"]  # survives re-checkpointing
        self._value = _EVAL_KINDS[state["kind"]]

    def value(self, r) -> float:
        return self._value(r)

    def add(self, r):
        self._average += self.value(r)
        self._n += 1.0

    # the streaming replay's API
    def add_value(self, v: float):
        self._average += v
        self._n += 1.0

    def ratio_with_first(self, r) -> float:
        return self.value(r) / self._first

    def ratio_with_average(self, r) -> float:
        return self.value(r) / self._average * self._n
