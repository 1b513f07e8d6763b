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

import itertools
import threading
from collections import Counter
from dataclasses import dataclass, field
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import default_device
from ..config import TrackerConfig
from ..ops import ingest, se3
from ..ops.camera import Intrinsics
from ..ops.pyramid import PyramidLevel, build_acceleration, build_pyramid, convert_raw_depth
from ..utils import timers
from .dense_tracker import FLAT_BASE as _FLAT_BASE
from .dense_tracker import PreparedFrame, _resolve_backend, match_prepared_flat, prepare_frame

# the process's frame identifiers: the spans of one frame's ingest and update
# carry its number (``utils/timers``)
_FRAME_IDS = itertools.count()

# the evaluations the lockstep matches ran while the span recorder was on,
# by (pyramid level, streams B, distinct frames read as reference, distinct
# frames read only as current): a level's iterations are those of its
# slowest stream, since the B streams step together
batch_evaluations: Counter = Counter()
_evaluations_lock = threading.Lock()


def _count_evaluations(cfg: TrackerConfig, streams: Sequence[Tuple["Frame", "Frame"]],
                       results: Sequence["HostTrackingResult"]):
    """Count a lockstep match of the (reference, current) ``streams``."""
    if not timers.enabled():
        return
    refs = {id(ref) for ref, _ in streams}
    key = (len(results), len(refs), len({id(cur) for _, cur in streams} - refs))
    with _evaluations_lock:
        for j, stats in enumerate(zip(*(r.level_stats for r in results))):
            batch_evaluations[(cfg.first_level - j, *key)] += max(s.iterations for s in stats)


def _on_device(a, device) -> torch.Tensor:
    """An array or tensor as a tensor on ``device`` (no copy where it is one).
    A copy from host memory to the card does not wait for the stream: the
    driver stages pageable bytes before the call returns."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.ascontiguousarray(a))
    return a.to(device, non_blocking=True)


@dataclass
class Frame:
    """A device-resident RGB-D frame pyramid with host metadata and the
    frame's number in the process (``frame_id``)."""

    levels: Tuple[PyramidLevel, ...]
    timestamp: float
    frame_id: int = field(default_factory=lambda: next(_FRAME_IDS))

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
        tracker's first match of the frame finds them.

        The frame goes through :func:`ingest_raw` as one frame: on a card
        two launches, and a raw frame the kernels do not take (``ops/ingest
        .check_raw``: [H, W] u8 intensity, u16 or int32 depth) raises
        ValueError; elsewhere the plain chain, with the same bits.  Spans:
        ``dvo.ingest`` around ``ingest_raw``'s."""
        device = default_device(device)
        frame_id = new_frame_id()
        with timers.span("dvo.ingest", frame=frame_id):
            levels, prepared = ingest_raw(intensity_u8, depth_u16, num_levels, prepare_for,
                                          device)
            frame = Frame(levels=levels, timestamp=timestamp, frame_id=frame_id)
            if prepare_for is not None:
                frame.__dict__["_prepared"] = {tuple(prepare_for): prepared}
        return frame


def new_frame_id() -> int:
    """A new number from the process's frame identifiers (``Frame.frame_id``)."""
    return next(_FRAME_IDS)


def ingest_raw(intensity_u8, depth_u16, num_levels: int,
               prepare_for: Optional[Tuple[TrackerConfig, Intrinsics]], device,
               streams: Optional[int] = None, skip_below: int = 0):
    """Raw frames (u8 intensity, u16 or int32 depth at 1/5000 m) as their
    pyramid levels and, with ``prepare_for=(cfg, intrinsics)``, the prepared
    artifacts of the solve range: (levels, prepared or None).  One frame
    ([H, W] channels) by default; with ``streams`` B a rig's B frames, each
    channel a sequence of B [H, W] host arrays, an array [B, H, W] or a
    tensor [B, H, W], and every output [B, ...] as a batched pyramid and a
    batched ``PreparedFrame`` hold them.  Levels below ``skip_below`` are
    None (``build_pyramid``'s).

    The raw frames go to the device as :func:`_stage` puts them there.  On a
    card the kernels' route (:func:`_ingest_kernels`: two launches, whatever
    B); elsewhere the plain chain, ``convert_raw_depth`` -> ``build_pyramid``
    -> ``prepare_frame`` (spans ``dvo.ingest.upload``, ``.pyramid``,
    ``.prepare``), which the kernels match bit for bit."""
    device = torch.device(device)
    if device.type == "cuda":
        return _ingest_kernels(intensity_u8, depth_u16, num_levels, prepare_for, device,
                               streams, skip_below)
    with timers.span("dvo.ingest.upload"):
        raw_i, raw_d = _stage((intensity_u8, depth_u16), device, streams)
        depth, valid = convert_raw_depth(raw_d)
        intensity = raw_i.to(torch.float32)
    with timers.span("dvo.ingest.pyramid"):
        levels = build_pyramid(intensity, depth, valid, num_levels, skip_below=skip_below)
    prepared = None
    if prepare_for is not None:
        with timers.span("dvo.ingest.prepare"):
            prepared = prepare_frame(*prepare_for, levels)
    return levels, prepared


def _stage(channels, device, streams: Optional[int]) -> List[torch.Tensor]:
    """The raw channels on ``device``: one frame's [H, W] or, with
    ``streams`` B, a rig's [B, H, W] (each channel then a sequence of B
    [H, W] frames, an array or a tensor).  A tensor already on the device is
    taken as it is, made contiguous only where a frame's rows are not (a
    rig's frames may lie apart, as a time slice of a [B, T, H, W] sequence
    does).  From host memory each camera's frame is copied into its plane
    of a new tensor by a copy that does not wait for the stream: the CUDA driver
    stages pageable bytes before the call returns."""
    out = []
    for a in channels:
        if isinstance(a, torch.Tensor) and a.device.type == device.type:
            out.append(a if ingest.rows_contiguous(a) else a.contiguous())
            continue
        frames = [a] if streams is None else list(a)
        if len(frames) != (streams or 1):
            raise ValueError(f"ingest: {len(frames)} frames for {streams} streams")
        frames = [f if isinstance(f, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(f))
                  for f in frames]
        lead = () if streams is None else (streams,)
        raw = torch.empty(lead + tuple(frames[0].shape), dtype=frames[0].dtype, device=device)
        for plane, f in zip(raw.unbind(0) if lead else (raw,), frames):
            plane.copy_(f, non_blocking=True)
        out.append(raw)
    return out


def _ingest_kernels(intensity_u8, depth_u16, num_levels: int,
                    prepare_for: Optional[Tuple[TrackerConfig, Intrinsics]], device,
                    streams: Optional[int] = None, skip_below: int = 0):
    """:func:`ingest_raw`'s route on a card: (levels, the prepared artifacts
    or None).  The raw frames' upload (span ``dvo.ingest.stage``), then the
    two kernels (``dvo.ingest.kernel``, whose events time the card's
    ingest), whatever ``streams``, with no synchronisation; the outputs are
    views of two arenas (``ops/ingest.arena_layout``).  On the modular backend kernel B writes
    no quad table and the acceleration tensors come from
    ``build_acceleration`` over kernel A's levels, as ``prepare_frame``
    builds them.  The kernels' counters (``ingest_cuda.pyramid_launches``,
    ``.pack_launches``) count the route; ``prepare_frame.calls`` does not
    move."""
    with timers.span("dvo.ingest.stage"):
        raw_i, raw_d = _stage((intensity_u8, depth_u16), device, streams)
    ingest.check_raw(raw_i, raw_d, streams is not None)
    solve, modular, pack = None, False, None
    if prepare_for is not None:
        cfg, intrinsics = prepare_for
        modular = _resolve_backend(cfg, device) == "xla"
        solve = (cfg.last_level, cfg.first_level)
    layout = ingest.arena_layout(tuple(raw_i.shape[-2:]), num_levels, solve, not modular,
                                 streams, skip_below)
    if solve is not None:
        pack = ingest.pack_args(layout, intrinsics, cfg.intensity_derivative_threshold,
                                cfg.depth_derivative_threshold)
    ref, cur = ingest.new_arenas(layout, raw_i.device)
    levels, sel, refpack, quad = ingest.arena_views(layout, ref, cur)
    with timers.span("dvo.ingest.kernel", device=True):
        ingest.ingest_cuda(raw_i, raw_d, layout, ref, cur, pack)
    if prepare_for is None:
        return levels, None
    accel = tuple(build_acceleration(lv) if modular and solve[0] <= k <= solve[1] else None
                  for k, lv in enumerate(levels))
    return levels, PreparedFrame(sel=sel, refpack=refpack, quad=quad, accel=accel)


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
    ``match_prepared_flat`` call on stacked [n, ...] artifacts and copies
    one flat [n, 53 + 4 * levels] float32 tensor to the host (on the card
    a match graph's pinned row: one launch and one wait).  This is the
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
        ``match_prepared_flat`` call, one device-to-host copy."""
        if not requests:
            return []
        refs = [self.prepared(r[0]) for r in requests]
        curs = [self.prepared(r[1]) for r in requests]
        inits = np.stack([
            np.eye(4, dtype=np.float32) if r[2] is None else np.asarray(r[2], np.float32)
            for r in requests
        ])
        if len(requests) == 1:
            flat = match_prepared_flat(self.cfg, self.intrinsics, refs[0], curs[0], inits[0],
                                       host=True)
        else:
            with timers.span("dvo.match.setup"):
                ref_b = _stack_role(refs, REF_FIELDS, self.cfg)
                cur_b = _stack_role(curs, CUR_FIELDS, self.cfg)
            flat = match_prepared_flat(self.cfg, self.intrinsics, ref_b, cur_b, inits, host=True)
        results = [_decode_result(row) for row in flat.reshape(len(requests), -1)]  # one copy
        _count_evaluations(self.cfg, [r[:2] for r in requests], results)
        return results

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

    n pairs run as two lockstep ``match_prepared_flat`` calls at B = 2n
    (the forward references and the backward ones stacked together): the
    coarse config seeded by ``init`` and, for the backward stream, its
    inverse (in float32 on the device, as the reference's wave inverts it);
    then the fine config seeded on the device by the coarse transforms (the
    first 16 entries of the coarse result rows, a copy of their own).  One
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
        coarse = match_prepared_flat(self.coarse_cfg, self.intrinsics, ref_b, cur_b, seeds)
        fine = match_prepared_flat(self.fine_cfg, self.intrinsics, ref_b, cur_b,
                                   coarse[:, :16].reshape(2 * n, 4, 4))
        flat = torch.cat([coarse, fine], dim=-1).cpu().numpy()  # one copy, both stages
        f1 = self._f1
        coarse = [_decode_result(row) for row in flat[:, :f1]]
        fine = [_decode_result(row) for row in flat[:, f1:]]
        streams = [r[:2] for r in requests] + [(r[1], r[0]) for r in requests]
        _count_evaluations(self.coarse_cfg, streams, coarse)
        _count_evaluations(self.fine_cfg, streams, fine)
        return [(coarse[k], coarse[n + k], fine[k], fine[n + k]) for k in range(n)]
