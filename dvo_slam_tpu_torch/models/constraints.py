"""Loop-closure constraint proposals and their two-stage validation (port
of ``dvo_slam_tpu.models.constraints``).

The reference's constraints subsystem (dvo_slam/src/constraints/*):
candidate keyframe pairs become ConstraintProposals, validated by a coarse
single-level screen and a fine full-pyramid refinement with voter-based
accept/reject (built at keyframe_graph.cpp:500-522).  The reference fans
proposals across TBB threads with thread-local trackers
(keyframe_graph.cpp:555-593); here a wave is one ``TwoStageMatcher`` call
(two lockstep solves on the card) and the voting runs on the host.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..config import GraphConfig, TrackerConfig
from ..ops.camera import Intrinsics
from ..utils import timers
from .dense_tracker import TrackingResult
from .evaluation import TrackingResultEvaluation
from .frames import BatchedMatcher, Frame, Keyframe, TwoStageMatcher
from .local_tracker import result_is_nan


@dataclass
class Vote:
    """Reference: ConstraintProposal::Vote (constraint_proposal.h)."""

    accept: bool
    score: float = 0.0
    reason: str = ""


@dataclass
class ConstraintProposal:
    """Candidate loop edge (constraint_proposal.h/cpp).  ``initial_pose`` is
    in result/pose space (current-in-reference), the inverse of the warp
    the reference stores in its InitialTransformation slot."""

    reference: Keyframe
    current: Keyframe
    initial_pose: np.ndarray
    result: Optional[TrackingResult] = None
    votes: List[Vote] = field(default_factory=list)

    @property
    def total_score(self) -> float:
        return sum(v.score for v in self.votes)

    @property
    def accept(self) -> bool:
        return all(v.accept for v in self.votes)

    @property
    def reject(self) -> bool:
        return any(not v.accept for v in self.votes)

    def same_frames(self, other: "ConstraintProposal") -> bool:
        a = (self.reference.id, self.current.id)
        b = (other.reference.id, other.current.id)
        return a == b or a == b[::-1]

    def inverse(self) -> "ConstraintProposal":
        return ConstraintProposal(
            reference=self.current,
            current=self.reference,
            initial_pose=np.linalg.inv(self.initial_pose),
        )

    @staticmethod
    def with_identity(reference: Keyframe, current: Keyframe) -> "ConstraintProposal":
        return ConstraintProposal(reference, current, np.eye(4))

    @staticmethod
    def with_relative(reference: Keyframe, current: Keyframe) -> "ConstraintProposal":
        """Initialize from the graph poses: reference.pose^{-1} current.pose
        (the warp current.pose^{-1} reference.pose of
        constraint_proposal.cpp:44)."""
        init = np.linalg.inv(reference.pose) @ current.pose
        return ConstraintProposal(reference, current, init)


def validation_tracker_config(base: TrackerConfig) -> TrackerConfig:
    """Stage-1 coarse screen config: the coarsest level only (the
    reference's levels 3->3, configureValidationTracking,
    keyframe_graph.cpp:829-837, relative to the base config).  Built from
    ``TrackerConfig()`` defaults as the reference builds it, so the base
    config's ``kernel_backend`` and ``depth_buffered_sampling`` do not
    reach the wave (the defaults, "auto" and on, run the kernel on the
    card)."""
    return dataclasses.replace(
        TrackerConfig(),
        first_level=base.first_level,
        last_level=base.first_level,
        precision=base.precision,
        use_initial_estimate=True,
        mu=base.mu,
        intensity_derivative_threshold=base.intensity_derivative_threshold,
        depth_derivative_threshold=base.depth_derivative_threshold,
    )


def constraint_tracker_config(base: TrackerConfig) -> TrackerConfig:
    """Stage-2 fine refinement config: the full pyramid down to the base
    config's finest level (the reference's 3->1, keyframe_graph.cpp:
    819-828), so that the entropy-ratio voter compares log-likelihoods
    solved down to the same level as the keyframe's tracking average.
    ``TrackerConfig()`` defaults elsewhere, as
    :func:`validation_tracker_config`."""
    return dataclasses.replace(
        TrackerConfig(),
        first_level=base.first_level,
        last_level=base.last_level,
        precision=base.precision,
        use_initial_estimate=True,
        mu=base.mu,
        intensity_derivative_threshold=base.intensity_derivative_threshold,
        depth_derivative_threshold=base.depth_derivative_threshold,
    )


def _constraint_ratio(r: TrackingResult) -> float:
    pixels = max(int(r.last_level.valid_pixels), 1)
    return int(r.last_level.valid_constraints) / pixels


class ConstraintProposalValidator:
    """Two-stage proposal validation (constraint_proposal_validator.cpp:
    69-160).

    Stage 1 (coarse, keep all): voters odometry-reject, NaN, constraint
    ratio, entropy ratio (coarse), cross-validation (forward and backward
    agreement).  Stage 2 (fine, keep the best per pair): NaN, constraint
    ratio, entropy ratio (fine).  ``use_fused_wave`` (default) computes
    both stages in one ``TwoStageMatcher`` wave; off, the staged matchers
    run stage by stage (the oracle)."""

    # prepared-artifact budget, in frames: keyframes recur across waves,
    # and the cache is evicted least recently validated first, after a wave
    MAX_CACHED_FRAMES = 32

    def __init__(self, intrinsics: Intrinsics, graph_cfg: GraphConfig,
                 tracker_cfg: TrackerConfig):
        self.cfg = graph_cfg
        fine_cfg = constraint_tracker_config(tracker_cfg)
        coarse_cfg = validation_tracker_config(tracker_cfg)
        # stage 1 reads stage 2's prepared artifacts (the configs differ
        # only in which levels they solve)
        self.stage2_matcher = BatchedMatcher(fine_cfg, intrinsics)
        self.stage1_matcher = BatchedMatcher(coarse_cfg, intrinsics, artifact_cfg=fine_cfg)
        self.use_fused_wave = True
        self.two_stage = TwoStageMatcher(coarse_cfg, fine_cfg, intrinsics)
        self._lru: Dict[int, object] = {}  # id(frame) -> frame, insertion-ordered

    def _retain(self, frames):
        """Keep the wave's frames' prepared artifacts; evict the least
        recently validated beyond the budget (keyframe Frames live in the
        graph for good, the artifact cache must not)."""
        for f in frames:
            self._lru.pop(id(f), None)
            self._lru[id(f)] = f
        while len(self._lru) > self.MAX_CACHED_FRAMES:
            _, old = next(iter(self._lru.items()))
            del self._lru[id(old)]
            self.stage1_matcher.evict(old)
            self.stage2_matcher.evict(old)

    def validate(self, proposals: List[ConstraintProposal]) -> List[ConstraintProposal]:
        """One validation wave (span ``dvo.graph.wave``): the accepted
        proposals, at most one per frame pair."""
        touched = {id(f): f for p in proposals for f in (p.reference.frame, p.current.frame)}
        with timers.span("dvo.graph.wave"):
            try:
                if self.use_fused_wave and proposals:
                    proposals = self._validate_fused(proposals)
                else:
                    proposals = self._stage1(proposals)
                    proposals = self._stage2(proposals)
            finally:
                self._retain(touched.values())
        return proposals

    def warm_up(self, reference: Frame, current: Frame):
        """Run a wave of each size a validation can launch (1 to
        ``TwoStageMatcher.MAX_PAIRS`` pairs, B = 2 to 2 MAX_PAIRS streams) on
        one frame pair, so that every wave's graphs are captured before a
        session needs them.  The results are dropped."""
        request = (reference, current, None)
        for n in range(1, self.two_stage.MAX_PAIRS + 1):
            self.two_stage.match_pairs([request] * n)

    def _validate_fused(self, proposals: List[ConstraintProposal]) -> List[ConstraintProposal]:
        """Both stages from one wave: the staged path's voting on results
        whose stage-2 matches were seeded by their direction's stage-1
        transformation, what _update_initials feeds the staged stage 2."""
        quads = self.two_stage.match_pairs(
            [(p.reference.frame, p.current.frame, p.initial_pose) for p in proposals]
        )
        pairs = []
        stage2_result = {}
        for p, (r1f, r1b, r2f, r2b) in zip(proposals, quads):
            inv = p.inverse()
            p.result, p.votes = r1f, []
            inv.result, inv.votes = r1b, []
            pairs.append((p, inv))
            stage2_result[id(p)] = r2f
            stage2_result[id(inv)] = r2b
        survivors = self._stage1_vote(pairs)
        for p in survivors:
            p.result, p.votes = stage2_result[id(p)], []
        return self._stage2_vote(survivors)

    # -- stages -----------------------------------------------------------
    def _match_all(self, matcher: BatchedMatcher, proposals):
        results = matcher.match_many(
            [(p.reference.frame, p.current.frame, p.initial_pose) for p in proposals]
        )
        for p, r in zip(proposals, results):
            p.result = r
            p.votes = []

    def _stage1(self, proposals: List[ConstraintProposal]) -> List[ConstraintProposal]:
        if not proposals:
            return []
        # cross-validation: add the inverse of every proposal
        pairs = [(p, p.inverse()) for p in proposals]
        self._match_all(self.stage1_matcher, proposals + [inv for _, inv in pairs])
        return self._stage1_vote(pairs)

    def _stage1_vote(self, pairs) -> List[ConstraintProposal]:
        """Stage-1 voting and removal over matched (forward, backward)
        pairs."""
        inverse_of = {}
        for a, b in pairs:
            inverse_of[id(a)] = b
            inverse_of[id(b)] = a
        all_props = [p for fb in pairs for p in fb]
        for p in all_props:
            self._vote(p, [
                self._vote_odometry,
                self._vote_nan,
                lambda q: self._vote_ratio(q, self.cfg.min_equation_system_constraint_ratio),
                lambda q: self._vote_entropy(q, self.cfg.new_constraint_min_entropy_ratio_coarse),
                lambda q: self._vote_cross_validation(q, inverse_of[id(q)]),
            ])
        # remove the worse half of each forward/backward pair
        # (CrossValidationVoter::removeAdditionalProposals,
        # constraint_proposal_voter.cpp:48-65)
        removed = set()
        for fwd, bwd in pairs:
            worse = bwd if (fwd.total_score >= bwd.total_score and fwd.accept) else fwd
            removed.add(id(worse))
        survivors = [p for p in all_props if id(p) not in removed and not p.reject]
        self._update_initials(survivors)
        return survivors

    def _stage2(self, proposals: List[ConstraintProposal]) -> List[ConstraintProposal]:
        if not proposals:
            return []
        self._match_all(self.stage2_matcher, proposals)
        return self._stage2_vote(proposals)

    def _stage2_vote(self, proposals: List[ConstraintProposal]) -> List[ConstraintProposal]:
        """Stage-2 voting and keep-best."""
        for p in proposals:
            self._vote(p, [
                self._vote_nan,
                lambda q: self._vote_ratio(q, self.cfg.min_equation_system_constraint_ratio),
                lambda q: self._vote_entropy(q, self.cfg.new_constraint_min_entropy_ratio_fine),
            ])
        proposals = [p for p in proposals if not p.reject]
        proposals = self._keep_best(proposals)
        self._update_initials(proposals)
        return proposals

    @staticmethod
    def _vote(p: ConstraintProposal, voters):
        for voter in voters:
            p.votes.append(voter(p))
            if not p.votes[-1].accept:
                break  # early abort (constraint_proposal_validator.cpp:155-158)

    @staticmethod
    def _keep_best(proposals: List[ConstraintProposal]) -> List[ConstraintProposal]:
        """One proposal per frame pair, the highest total score
        (constraint_proposal_validator.cpp:104-130)."""
        out: List[ConstraintProposal] = []
        for p in proposals:
            for i, q in enumerate(out):
                if p.same_frames(q):
                    if p.total_score > q.total_score:
                        out[i] = p
                    break
            else:
                out.append(p)
        return out

    @staticmethod
    def _update_initials(proposals):
        """Feed each stage's estimate to the next as its initial pose
        (constraint_proposal_validator.cpp:95-100)."""
        for p in proposals:
            p.initial_pose = np.asarray(p.result.transformation, np.float64)

    # -- voters -----------------------------------------------------------
    @staticmethod
    def _vote_odometry(p: ConstraintProposal) -> Vote:
        is_odo = abs(p.reference.id - p.current.id) <= 1
        return Vote(not is_odo, reason=f"OdometryConstraint {is_odo}")

    @staticmethod
    def _vote_nan(p: ConstraintProposal) -> Vote:
        nan = result_is_nan(p.result)
        return Vote(not nan, reason=f"NaNResult {nan}")

    @staticmethod
    def _vote_ratio(p: ConstraintProposal, threshold: float) -> Vote:
        ratio = _constraint_ratio(p.result)
        return Vote(ratio >= threshold, reason=f"ConstraintRatio {ratio:.3f}")

    @staticmethod
    def _vote_entropy(p: ConstraintProposal, threshold: float) -> Vote:
        evaluation: TrackingResultEvaluation = p.reference.evaluation
        if evaluation is None:
            return Vote(False, reason="no evaluation")
        ratio = evaluation.ratio_with_average(p.result)
        return Vote(ratio >= threshold, score=ratio, reason=f"Entropy {ratio:.3f}")

    @staticmethod
    def _vote_cross_validation(p: ConstraintProposal, inverse: "ConstraintProposal",
                               threshold: float = 1.0) -> Vote:
        """Forward and backward estimates must compose to about the identity
        (constraint_proposal_voter.cpp:67-89)."""
        T_f = np.asarray(p.result.transformation, np.float64)
        T_b = np.asarray(inverse.result.transformation, np.float64)
        diff = np.linalg.norm((T_b @ T_f)[:3, 3])
        return Vote(diff <= threshold, reason=f"CrossValidation {diff:.3f}")
