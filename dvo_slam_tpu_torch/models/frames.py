"""Frame and keyframe records and batched alignment (port of
``dvo_slam_tpu.models.frames``: ``Frame``, ``Keyframe``, ``stack_frames``,
the host-side result, ``BatchedMatcher`` and ``TwoStageMatcher``).

The reference runs concurrent alignments (the dual keyframe/odometry
match, loop-closure waves) as one ``vmap`` of ``match_prepared``.  Here
they are one lockstep call of ``match_prepared`` on stacked [B, ...]
artifacts: every op of an iteration runs once for the B pairs, and on the
card the evaluation is one call of the batched folded kernel.  A wave of n
requests runs at B = n; one request runs the one-stream path; a
validation wave of n pairs runs at B = 2n.  The reference's power-of-two
buckets, padded slots, chunking past 16 and fixed-size prepare chunks keep
XLA's compile set closed; eager PyTorch has no compile set, so they are
not ported.

Frames are prepared once (per level the selection mask, the refpack and
the quad table, or on the modular path the acceleration tensor:
``prepare_frame``) and the artifacts cached on the Frame under the
matcher's (config, intrinsics) key, so a keyframe matched against every
incoming frame never recomputes them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import default_device
from ..config import TrackerConfig
from ..ops import se3
from ..ops.camera import Intrinsics
from ..ops.pyramid import PyramidLevel, build_pyramid, convert_raw_depth
from .dense_tracker import PreparedFrame, TrackingResult, match_prepared, prepare_frame


def _on_device(a, device) -> torch.Tensor:
    """An array or tensor as a tensor on ``device`` (no copy where it is one)."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.ascontiguousarray(a))
    return a.to(device)


@dataclass
class Frame:
    """A device-resident RGB-D frame pyramid with host metadata."""

    levels: Tuple[PyramidLevel, ...]
    timestamp: float

    @staticmethod
    def from_arrays(
        intensity, depth, valid, timestamp: float, num_levels: int, device=None
    ) -> "Frame":
        """From float intensity, depth in meters and a validity mask, on the
        card unless ``device`` names another (``default_device``)."""
        device = default_device(device)
        return Frame(
            levels=build_pyramid(
                _on_device(intensity, device).to(torch.float32),
                _on_device(depth, device).to(torch.float32),
                _on_device(valid, device).to(torch.bool),
                num_levels,
            ),
            timestamp=timestamp,
        )

    @staticmethod
    def from_raw(
        intensity_u8,
        depth_u16,
        timestamp: float,
        num_levels: int,
        prepare_for: Optional[Tuple[TrackerConfig, Intrinsics]] = None,
        device=None,
    ) -> "Frame":
        """From raw camera arrays (u8 intensity, u16 depth at 1/5000 m):
        the raw bytes go to the device and are converted there.
        ``prepare_for=(cfg, intrinsics)`` also prepares the solver artifacts
        and fills the frame's prepared cache under that key, so that the
        tracker's first match of the frame finds them."""
        device = default_device(device)
        depth, valid = convert_raw_depth(_on_device(depth_u16, device))
        levels = build_pyramid(
            _on_device(intensity_u8, device).to(torch.float32), depth, valid, num_levels
        )
        frame = Frame(levels=levels, timestamp=timestamp)
        if prepare_for is not None:
            cfg, intrinsics = prepare_for
            frame.__dict__["_prepared"] = {
                (cfg, intrinsics): prepare_frame(cfg, intrinsics, levels)
            }
        return frame


@dataclass
class Keyframe:
    """Keyframe record (reference: dvo_slam keyframe.h:36-55)."""

    id: int
    frame: Frame
    pose: np.ndarray  # [4, 4] world pose
    evaluation: Any = None

    @property
    def timestamp(self) -> float:
        return self.frame.timestamp


def stack_frames(frames: Sequence[Frame]) -> Tuple[Optional[PyramidLevel], ...]:
    """Stack per-frame pyramids into batched pyramids (leading dim = batch)."""
    return tuple(
        None if levels[0] is None else PyramidLevel(*(torch.stack(f) for f in zip(*levels)))
        for levels in zip(*(f.levels for f in frames))
    )


class HostLevelStats(NamedTuple):
    """Host-side copy of one pyramid level's statistics."""

    valid_pixels: int
    valid_constraints: int
    iterations: int
    termination: int


class HostTrackingResult(NamedTuple):
    """Host-side tracking result, decoded from one flat download.

    ``TrackingResult``'s interface with NumPy fields, so that the keyframe
    policy and graph insertion never touch the device again.
    ``level_stats`` covers every solved level, coarse first (the
    reference's Stats::Levels, dense_tracking.h:108-123)."""

    transformation: np.ndarray  # [4, 4]
    information: np.ndarray  # [6, 6]
    neg_log_likelihood: float
    level_stats: Tuple[HostLevelStats, ...]  # coarse -> fine

    @property
    def last_level(self) -> HostLevelStats:
        """Finest solved level (keyframe_tracker.cpp:165-168)."""
        return self.level_stats[-1]

    def is_nan(self) -> bool:
        return bool(np.isnan(self.transformation).any())


# flat layout: 16 (T) + 36 (info) + 1 (nll) + 4 per solved level
_FLAT_BASE = 53


def _flatten_result(r: TrackingResult) -> torch.Tensor:
    """A result as float32 [..., 53 + 4 * levels] on its device."""
    batch = tuple(r.transformation.shape[:-2])
    f32 = torch.float32
    stats = [torch.stack([f.to(f32).expand(batch) for f in s], dim=-1) for s in r.level_stats]
    return torch.cat(
        [
            r.transformation.reshape(batch + (16,)).to(f32),
            r.information.reshape(batch + (36,)).to(f32),
            r.neg_log_likelihood.reshape(batch + (1,)).to(f32),
            *stats,
        ],
        dim=-1,
    )


def _decode_result(flat: np.ndarray) -> HostTrackingResult:
    n_levels = (flat.shape[0] - _FLAT_BASE) // 4
    levels = tuple(
        HostLevelStats(
            valid_pixels=int(flat[_FLAT_BASE + 4 * i]),
            valid_constraints=int(flat[_FLAT_BASE + 4 * i + 1]),
            iterations=int(flat[_FLAT_BASE + 4 * i + 2]),
            termination=int(flat[_FLAT_BASE + 4 * i + 3]),
        )
        for i in range(n_levels)
    )
    return HostTrackingResult(
        transformation=flat[:16].reshape(4, 4).astype(np.float64),
        information=flat[16:52].reshape(6, 6).astype(np.float64),
        neg_log_likelihood=float(flat[52]),
        level_stats=levels,
    )


def _stack_levels(entries: Sequence[Tuple[Optional[torch.Tensor], ...]], cfg: TrackerConfig):
    """The requests' artifacts stacked [B, ...] at each level of ``cfg``'s
    solve range that holds them; None elsewhere."""
    return tuple(
        torch.stack(per_level)
        if cfg.last_level <= level <= cfg.first_level and per_level[0] is not None else None
        for level, per_level in enumerate(zip(*entries))
    )


# the artifacts of each role: the reference frame's, the current frame's
# (the quad table on the fused path, the acceleration tensor on the modular)
REF_FIELDS = ("sel", "refpack")
CUR_FIELDS = ("quad", "accel")


def _stack_role(prepared: Sequence[PreparedFrame], fields, cfg: TrackerConfig) -> PreparedFrame:
    """The requests' artifacts of one role (``fields``) stacked [B, ...]."""
    none = (None,) * len(prepared[0].sel)
    return PreparedFrame(**{
        field: _stack_levels([getattr(p, field) for p in prepared], cfg) if field in fields else none
        for field in PreparedFrame._fields
    })


class BatchedMatcher:
    """Batched dense alignment with a per-frame prepared-artifact cache.

    ``match_many([(ref, cur, init), ...])`` aligns n pairs in one lockstep
    ``match_prepared`` call on stacked [n, ...] artifacts and copies one
    flat [n, 53 + 4 * levels] float32 tensor to the host.  This is the
    engine of the dual keyframe/odometry match (n = 2) and of loop-closure
    waves.  The artifacts are stacked copies: the dual match's two
    requests share the current frame, whose quad table (or acceleration
    tensor) is then stacked twice (the folded kernel takes contiguous
    [B, 32, N] tables).
    """

    def __init__(
        self,
        cfg: TrackerConfig,
        intrinsics: Intrinsics,
        artifact_cfg: Optional[TrackerConfig] = None,
    ):
        """``artifact_cfg``: prepare frames under this config instead of
        ``cfg`` (default ``cfg``).  Per-level artifacts are the same for
        configs that share thresholds and backend, so a matcher that solves
        a sub-range of levels can read a finer config's artifacts."""
        self.cfg = cfg
        self.intrinsics = intrinsics
        self.artifact_cfg = cfg if artifact_cfg is None else artifact_cfg
        if (
            self.artifact_cfg.first_level < cfg.first_level
            or self.artifact_cfg.last_level > cfg.last_level
        ):
            raise ValueError(
                "artifact_cfg level range must cover the match config's: "
                f"artifacts {self.artifact_cfg.last_level}.."
                f"{self.artifact_cfg.first_level} vs match "
                f"{cfg.last_level}..{cfg.first_level}"
            )
        self._prep_key = (self.artifact_cfg, intrinsics)

    def prepared(self, frame: Frame) -> PreparedFrame:
        """The frame's cached solver artifacts (prepared on first use).  The
        cache lives on the Frame, keyed by (artifact_cfg, intrinsics), so
        its device memory goes with the frame."""
        cache = frame.__dict__.setdefault("_prepared", {})
        if self._prep_key not in cache:
            cache[self._prep_key] = prepare_frame(self.artifact_cfg, self.intrinsics, frame.levels)
        return cache[self._prep_key]

    def evict(self, frame: Frame):
        """Release this matcher's cached artifacts of a frame (a keyframe
        that retires from active tracking)."""
        frame.__dict__.get("_prepared", {}).pop(self._prep_key, None)

    def match_many(
        self,
        requests: Sequence[Tuple[Frame, Frame, Optional[np.ndarray]]],
    ) -> List[HostTrackingResult]:
        """Align [(reference, current, initial_pose_or_None), ...]: one
        ``match_prepared`` call, one device-to-host copy."""
        if not requests:
            return []
        refs = [self.prepared(r[0]) for r in requests]
        curs = [self.prepared(r[1]) for r in requests]
        device = refs[0].refpack[self.cfg.first_level].device
        inits = torch.from_numpy(np.stack([
            np.eye(4, dtype=np.float32) if r[2] is None else np.asarray(r[2], np.float32)
            for r in requests
        ])).to(device)
        if len(requests) == 1:
            result = match_prepared(self.cfg, self.intrinsics, refs[0], curs[0], inits[0])
        else:
            ref_b = _stack_role(refs, REF_FIELDS, self.cfg)
            cur_b = _stack_role(curs, CUR_FIELDS, self.cfg)
            result = match_prepared(self.cfg, self.intrinsics, ref_b, cur_b, inits)
        flat = _flatten_result(result).reshape(len(requests), -1).cpu().numpy()  # one copy
        return [_decode_result(row) for row in flat]

    def match(self, ref: Frame, cur: Frame, initial=None) -> HostTrackingResult:
        return self.match_many([(ref, cur, initial)])[0]


class TwoStageMatcher:
    """The validation wave: per frame pair the coarse forward and backward
    screens and the fine forward and backward refinements, each seeded by
    its own direction's coarse result (constraint_proposal_validator.cpp:
    69-160 runs the two stages as separate tracker passes with the host in
    between).  Stage 1's voting only selects which direction's stage-2
    solve to keep, so the device computes stage 2 for both directions and
    the host votes on the results.

    n pairs run as two lockstep ``match_prepared`` calls at B = 2n (the
    forward references and the backward ones stacked together): the coarse
    config seeded by ``init`` and, for the backward stream, its inverse
    (in float32 on the device, as the reference's wave inverts it); then
    the fine config seeded on the device by the coarse transforms.  One
    copy to the host at the end.  Artifacts are prepared once under the
    fine config and read by the coarse solve (``BatchedMatcher``'s
    ``artifact_cfg``).  Each frame serves both roles, so its refpack and
    quad table are stacked copies (the folded kernel takes contiguous
    [B, 32, N] tables).
    """

    # pairs per wave: the bound on the stacked copies (a wave of more pairs
    # runs in chunks, as the reference's does past 8)
    MAX_PAIRS = 8

    def __init__(self, coarse_cfg: TrackerConfig, fine_cfg: TrackerConfig, intrinsics: Intrinsics):
        self.coarse_cfg = coarse_cfg
        self.fine_cfg = fine_cfg
        self.intrinsics = intrinsics
        # artifact owner: prepares and evicts under the fine config's key
        self.artifacts = BatchedMatcher(fine_cfg, intrinsics)
        BatchedMatcher(coarse_cfg, intrinsics, artifact_cfg=fine_cfg)  # checks the level ranges
        # flat width of one coarse result (for the host decode)
        self._f1 = _FLAT_BASE + 4 * (coarse_cfg.first_level - coarse_cfg.last_level + 1)

    def match_pairs(
        self,
        requests: Sequence[Tuple[Frame, Frame, Optional[np.ndarray]]],
    ) -> List[Tuple[HostTrackingResult, HostTrackingResult, HostTrackingResult,
                    HostTrackingResult]]:
        """[(ref, cur, init), ...] -> [(s1_fwd, s1_bwd, s2_fwd, s2_bwd)], the
        stage-2 results seeded by their direction's stage-1 transformation
        (the validator's feed-forward)."""
        if not requests:
            return []
        if len(requests) > self.MAX_PAIRS:
            out = []
            for s in range(0, len(requests), self.MAX_PAIRS):
                out.extend(self.match_pairs(requests[s: s + self.MAX_PAIRS]))
            return out
        n = len(requests)
        refs = [self.artifacts.prepared(r[0]) for r in requests]
        curs = [self.artifacts.prepared(r[1]) for r in requests]
        device = refs[0].refpack[self.fine_cfg.first_level].device
        inits = torch.from_numpy(np.stack([
            np.eye(4, dtype=np.float32) if r[2] is None else np.asarray(r[2], np.float32)
            for r in requests
        ])).to(device)
        # streams 0..n-1 forward (ref -> cur), n..2n-1 backward (cur -> ref)
        ref_b = _stack_role(refs + curs, REF_FIELDS, self.fine_cfg)
        cur_b = _stack_role(curs + refs, CUR_FIELDS, self.fine_cfg)
        seeds = torch.cat([inits, se3.inverse(inits)])
        coarse = match_prepared(self.coarse_cfg, self.intrinsics, ref_b, cur_b, seeds)
        fine = match_prepared(self.fine_cfg, self.intrinsics, ref_b, cur_b, coarse.transformation)
        flat = torch.cat([_flatten_result(coarse), _flatten_result(fine)], dim=-1)
        flat = flat.cpu().numpy()  # one copy for both stages and directions
        f1 = self._f1
        return [
            (_decode_result(flat[k, :f1]), _decode_result(flat[n + k, :f1]),
             _decode_result(flat[k, f1:]), _decode_result(flat[n + k, f1:]))
            for k in range(n)
        ]
