"""Streaming SLAM front end: the keyframe tracking loop with no per-frame
host decision (port of ``dvo_slam_tpu.models.streaming``).

The reference's front end is a per-frame host loop (LocalTracker::update,
local_tracker.cpp:157-216, driven at camera rate).  Here the steady-state
loop — pyramid build, prepare, the dual keyframe/odometry match, the
keyframe-accept policy and the keyframe switch itself — runs on device
tensors, frame after frame, and nothing of its outcome comes back to the
host until the whole sequence (or chunk) is done:

  * the carried state holds the keyframe's and the last frame's prepared
    reference artifacts; switching keyframes is a ``torch.where`` over
    them (the device form of the reference's pointer swap,
    local_tracker.cpp:200-213);
  * the accept criteria (keyframe_tracker.cpp:105-195) are float32
    arithmetic on the match statistics, with 0-d boolean tensors for
    ``accept``, ``diverged`` and ``force`` ([B] tensors when B streams run
    in lockstep, the reference's vmapped front end);
  * each frame writes one row of a preallocated [T, 130] float32 record
    tensor (the flags, both rewritten results, the pose), copied to the
    host once.

The reference runs this loop as one ``lax.scan``; eager PyTorch runs it as
a Python loop over the same step.  On the card nothing inside a frame is
read back: each IRLS level is one while-graph launch
(``dense_tracker.graph_irls_level``), so the record copy is the chunk's
only read.  On the CPU the eager loop reads its ``done`` flags once per
lockstep iteration (``dense_tracker.read_done``).

The host then replays the recorded decisions through the
``LocalMap``/``KeyframeGraph`` back end (``_ReplayFeeder``): the graph
bookkeeping, loop-closure search, validation waves and optimization are
per-keyframe work that the reference itself runs on a background thread
(keyframe_graph.cpp:401-432, SURVEY.md 2.5 P5), so the replay consumes the
records without deciding anything again.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import default_device, native
from ..config import SlamConfig
from ..ops.camera import Intrinsics
from ..ops.pyramid import build_pyramid, convert_raw_depth
from .dense_tracker import PreparedFrame, match_prepared, prepare_frame, ref_artifacts
from .frames import Frame
from .keyframe_graph import KeyframeGraph
from .local_map import LocalMap

# Per-result flat block: 16 (T) + 36 (info) + 1 (nll) + 2 (n, pixels)
_RES = 55
# One frame's record: 4 flags (accept, diverged, forced, entropy ratio), the
# keyframe and odometry results, the frame's pose
RECORD_WIDTH = 4 + 2 * _RES + 16


class _State(NamedTuple):
    """The front end's carried state; every tensor on the device."""

    kf: PreparedFrame  # the keyframe's reference-role artifacts
    last: PreparedFrame  # the last frame's
    kf_pose: torch.Tensor  # [4, 4] keyframe world pose
    last_pose: torch.Tensor  # [4, 4] last frame world pose
    last_to_kf: torch.Tensor  # [4, 4] policy state (keyframe_tracker.cpp:123-158)
    last_kf_estimate: torch.Tensor  # [4, 4] warm start for the keyframe match
    eval_first: torch.Tensor  # [] first -nll of the current local map


def _flat_res(T, info, nll, n, pixels):
    """One result as a [..., 55] block (a leading stream axis kept)."""
    f32 = torch.float32
    return torch.cat([
        T.flatten(-2),
        info.flatten(-2),
        nll[..., None],
        n.to(f32)[..., None],
        pixels.to(f32)[..., None],
    ], dim=-1)


class FrameRecord(NamedTuple):
    """Host-side decode of one frame's record."""

    accept: bool
    diverged: bool
    forced: bool
    entropy_ratio: float
    kf_T: np.ndarray
    kf_info: np.ndarray
    kf_nll: float
    kf_n: int
    kf_pixels: int
    odo_T: np.ndarray
    odo_info: np.ndarray
    odo_nll: float
    odo_n: int
    odo_pixels: int
    pose: np.ndarray


def _decode(row: np.ndarray) -> FrameRecord:
    k = row[4: 4 + _RES]
    o = row[4 + _RES: 4 + 2 * _RES]
    return FrameRecord(
        accept=bool(row[0] > 0.5),
        diverged=bool(row[1] > 0.5),
        forced=bool(row[2] > 0.5),
        entropy_ratio=float(row[3]),
        kf_T=k[:16].reshape(4, 4).astype(np.float64),
        kf_info=k[16:52].reshape(6, 6).astype(np.float64),
        kf_nll=float(k[52]),
        kf_n=int(k[53]),
        kf_pixels=int(k[54]),
        odo_T=o[:16].reshape(4, 4).astype(np.float64),
        odo_info=o[16:52].reshape(6, 6).astype(np.float64),
        odo_nll=float(o[52]),
        odo_n=int(o[53]),
        odo_pixels=int(o[54]),
        pose=row[4 + 2 * _RES:].reshape(4, 4).astype(np.float64),
    )


def host_reduce_ingest(intensity_u8, depth_u16, levels: int):
    """Exact host-side reduction of camera frames [..., H, W] to pyramid
    level ``levels``: intensity as a lossless u16 4^k-scaled 2x2 mean (four
    u8 summands per step fit u16 up to k=3), depth as the reference's
    subsample decimation (a stride-2 slice).

    Why: the benchmark operating point solves levels 3->1
    (dense_tracking_config.cpp:27-42 + benchmark.yaml), so level-0 pixels
    are read exactly once, by the L0->L1 downsample.  Uploading them costs
    bytes the solve never reads: the reduction sends a quarter of the
    pixels per level dropped.  Bit-exact: the device path's float32 mean of
    u8 values and the u16 sum / 4^k give identical floats.

    Frame stacks [T, H, W] take the native C++ reduction where it built
    (``dvo_slam_tpu_torch.native``), else this NumPy form, bit-equal; the
    path taken and the reason are kept in ``host_reduce_ingest.last_path``
    (``"native"`` or ``"numpy"``) and ``host_reduce_ingest.last_reason``.
    """
    if levels > 3:
        # the u16 block sums bound the depth: 255 * 4^3 = 16320 < 65535,
        # one more level would silently wrap
        raise ValueError(f"host_reduce_ingest supports levels <= 3, got {levels}")
    reason = "levels < 1" if levels < 1 else "not a [T, H, W] stack"
    if intensity_u8.ndim == 3 and levels >= 1:
        try:  # C++ path: two threads
            out = native.reduce_ingest_native(intensity_u8, depth_u16, levels)
            host_reduce_ingest.last_path, host_reduce_ingest.last_reason = "native", None
            return out
        except Exception as e:  # the NumPy form (also the parity reference in tests)
            reason = f"{type(e).__name__}: {e}"
    host_reduce_ingest.last_path, host_reduce_ingest.last_reason = "numpy", reason
    return reduce_ingest_numpy(intensity_u8, depth_u16, levels)


host_reduce_ingest.last_path = None
host_reduce_ingest.last_reason = None


def reduce_ingest_numpy(intensity_u8, depth_u16, levels: int):
    """The NumPy form of :func:`host_reduce_ingest` (its path where the
    native extension is unavailable, and the oracle of the C++ one)."""
    i = intensity_u8.astype(np.uint16)
    d = depth_u16
    for _ in range(levels):
        # floor-halved dims, like the device pyramid (odd trailing
        # row/column never reaches the next level on either path)
        h2, w2 = i.shape[-2] // 2, i.shape[-1] // 2
        i = i[..., : 2 * h2, : 2 * w2]
        i = (
            i[..., 0::2, 0::2] + i[..., 0::2, 1::2]
            + i[..., 1::2, 0::2] + i[..., 1::2, 1::2]
        )
        d = d[..., : 2 * h2: 2, : 2 * w2: 2]
    return i, d


def _where(cond, a, b):
    """``torch.where`` with per-stream flags ``cond`` [...] broadcast over
    the trailing dimensions of ``a`` / ``b`` (either may lack the stream
    axis); 0-d flags select as ``torch.where`` does."""
    trailing = max(a.dim(), b.dim()) - cond.dim()
    return torch.where(cond.reshape(cond.shape + (1,) * trailing), a, b)


def _stream_of(prepared: PreparedFrame, i: int) -> PreparedFrame:
    """Stream ``i`` of a batched PreparedFrame."""
    return PreparedFrame(*(tuple(None if x is None else x[i] for x in role) for role in prepared))


def _widen(t: torch.Tensor) -> torch.Tensor:
    """uint16 camera data as int32 (exact), since PyTorch has few uint16
    kernels; other dtypes as they are."""
    return t.to(torch.int32) if t.dtype == torch.uint16 else t


def make_streaming_frontend(cfg: SlamConfig, intrinsics: Intrinsics,
                            ingest_level: int = 0, chunked: bool = False):
    """The whole-sequence keyframe front end on device tensors.

    Returns ``run(intensity [T,H,W], depth [T,H,W], force [T] bool,
    init_T [4,4]) -> records [T, 130]`` float32 on the inputs' device —
    rows 0/1 cover the bootstrap frames (keyframe_tracker.cpp:227-246).
    The inputs are raw camera frames on the device: u8 (or u16) intensity,
    u16 (or int32) depth at 1/5000 m.

    B streams in lockstep (the reference's ``jax.vmap`` of this function,
    ``parallel/dp_slam.py:68-71``): ``intensity``/``depth`` [B, T, H, W],
    ``force`` [B, T], ``init_T`` [B, 4, 4] -> records [B, T, 130].  Each
    frame makes one ``match_prepared`` call at 2B (every stream's keyframe
    reference, then every stream's last frame, against each stream's
    current quad table stacked twice); the flags are [B] tensors and a
    finished stream's IRLS carry freezes as in the lockstep tracker.  The
    bootstrap matches and the pose products run stream by stream, so
    stream b's records are bit-equal to that stream's one-stream run.

    With ``ingest_level`` = L > 0 the inputs are the
    :func:`host_reduce_ingest` products (u16, intensity scaled 4^L) and
    the solve runs on the physically identical shifted pyramid —
    bit-exact results.

    With ``chunked`` = True returns ``(run_first, run_cont)`` for the
    pipelined driver (see ``StreamingSLAM.track_sequence``'s
    ``pipeline_chunk``): ``run_first`` also returns the carried state,
    ``run_cont(state, intensity, depth, force) -> (state, records)``
    advances it over further chunks.
    """
    tcfg = cfg.tracker
    kcfg = cfg.keyframe
    if ingest_level:
        if ingest_level > tcfg.last_level:
            raise ValueError(
                f"ingest_level {ingest_level} would drop levels the "
                f"solve reads (last_level {tcfg.last_level})"
            )
        intrinsics = intrinsics.at_level(ingest_level)
        tcfg = dataclasses.replace(
            tcfg,
            first_level=tcfg.first_level - ingest_level,
            last_level=tcfg.last_level - ingest_level,
        )
    iscale = 1.0 / (4.0 ** ingest_level)
    f32 = torch.float32

    def build(iu, du):
        depth, valid = convert_raw_depth(_widen(du))
        intensity = _widen(iu).to(f32)
        return build_pyramid(
            intensity * iscale if ingest_level else intensity,
            depth, valid, tcfg.num_levels, skip_below=tcfg.last_level,
        )

    def prep(levels):
        return prepare_frame(tcfg, intrinsics, levels)

    def match(ref, cur, init):
        return match_prepared(tcfg, intrinsics, ref, cur, init)

    def res_of(r):
        return (
            r.transformation,
            r.information,
            r.neg_log_likelihood,
            r.last_level.valid_constraints,
            r.last_level.valid_pixels,
        )

    def norm3(T):
        """|t| of a pose's translation, float32, as jnp.linalg.norm sums it."""
        t = T[..., :3, 3]
        return torch.sqrt(torch.sum(t * t, dim=-1))

    def streams(state):
        """The stream count B of a carried state, 0 for one stream."""
        return state.kf_pose.shape[0] if state.kf_pose.dim() == 3 else 0

    def join(b, x, y):
        """Two roles into one batch: [2, ...] for one stream, [2B, ...]
        (every stream's first role, then every stream's second) for B."""
        return torch.cat([x, y]) if b else torch.stack([x, y])

    def stack2(b, xs, ys):
        return tuple(None if x is None else join(b, x, y) for x, y in zip(xs, ys))

    def compose(b, A, B):
        """Pose products stream by stream: a batched [B, 4, 4] product
        rounds otherwise than the one-stream [4, 4] one."""
        return torch.stack([A[i] @ B[i] for i in range(b)]) if b else A @ B

    def halves(b, x):
        """A dual match's result split into its two roles."""
        return (x[:b], x[b:]) if b else (x[0], x[1])

    def select(accept, a, b):
        return tuple(None if x is None else _where(accept, x, y) for x, y in zip(a, b))

    def finite(T):
        """Per stream: every entry of a [..., 4, 4] pose finite."""
        return torch.isfinite(T).flatten(-2).all(-1)

    def step(state: _State, iu, du, force_flag):
        device = state.kf_pose.device
        b = streams(state)
        batch = state.kf_pose.shape[:-2]
        eye = torch.eye(4, dtype=f32, device=device)
        info_reset = torch.eye(6, dtype=f32, device=device) * (0.008 * 0.008)
        cur = prep(build(iu, du))
        # the dual keyframe/odometry match as one lockstep solve at B = 2
        # (2B for B streams: the reference's tbb::parallel_invoke,
        # local_tracker.cpp:180-185, under its vmap over streams): the two
        # level loops run together, the batched folded kernel once per
        # iteration.  The reference's vmap takes the current frame's quad
        # table unbatched; the kernel takes contiguous [B, 32, N] tables,
        # so it is stacked twice (frames.BatchedMatcher.match_many)
        eyes = eye.expand(batch + (4, 4))
        init_kf = state.last_kf_estimate if tcfg.use_initial_estimate else eyes
        none = (None,) * len(cur.quad)
        ref_b = PreparedFrame(sel=stack2(b, state.kf.sel, state.last.sel),
                              refpack=stack2(b, state.kf.refpack, state.last.refpack),
                              quad=none, accel=none)
        cur_b = PreparedFrame(sel=none, refpack=none, quad=stack2(b, cur.quad, cur.quad),
                              accel=stack2(b, cur.accel, cur.accel))
        r = match(ref_b, cur_b, join(b, init_kf, eyes))
        (kf_T, odo_T), (kf_info, odo_info), (kf_nll, odo_nll), (kf_n, odo_n), (kf_pix, odo_pix) = (
            halves(b, x) for x in res_of(r))

        nan = ~(finite(kf_T) & finite(odo_T))
        force = force_flag | nan

        # criterion 1: entropy ratio vs the map's first frame (:105-121)
        ratio = -kf_nll / state.eval_first
        c1 = ratio > kcfg.min_entropy_ratio

        # criterion 2: divergence rejection with result rewriting (:123-158)
        diverged = (norm3(odo_T) > 0.1) | (norm3(kf_T) > 1.5 * kcfg.max_translational_distance)
        odo_T = _where(diverged, eye, odo_T)
        odo_info = _where(diverged, info_reset, odo_info)
        kf_T = _where(diverged, state.last_to_kf, kf_T)

        # criterion 3: translational distance on the rewritten result (:160-163)
        c3 = norm3(kf_T) < kcfg.max_translational_distance

        # criterion 4: constraint ratio (:165-168)
        c4 = (kf_n.to(f32) / torch.clamp(kf_pix.to(f32), min=1.0)
              > kcfg.min_equation_system_constraint_ratio)

        accept = c1 & ~diverged & c3 & c4 & ~force

        # keyframe switch: on reject the old last frame becomes the new
        # keyframe and `cur` starts the new map seeded by the odometry
        # result (local_tracker.cpp:200-213; NaN -> identity reset :141-148).
        # The carry holds only the reference-role artifacts: the next dual
        # match never reads a carried quad table.
        switch_T = _where(finite(odo_T), odo_T, eye)
        new_state = _State(
            kf=PreparedFrame(sel=select(accept, state.kf.sel, state.last.sel),
                             refpack=select(accept, state.kf.refpack, state.last.refpack),
                             quad=none, accel=none),
            last=ref_artifacts(cur),
            kf_pose=_where(accept, state.kf_pose, state.last_pose),
            last_pose=_where(accept, compose(b, state.kf_pose, kf_T),
                             compose(b, state.last_pose, switch_T)),
            last_to_kf=_where(accept, kf_T, switch_T),
            last_kf_estimate=_where(accept, kf_T, switch_T),
            eval_first=torch.where(accept, state.eval_first, -odo_nll),
        )
        record = torch.cat([
            torch.stack([accept.to(f32), diverged.to(f32), force.to(f32), ratio], dim=-1),
            _flat_res(kf_T, kf_info, kf_nll, kf_n, kf_pix),
            _flat_res(odo_T, odo_info, odo_nll, odo_n, odo_pix),
            new_state.last_pose.flatten(-2),
        ], dim=-1)
        return new_state, record

    def bootstrap(intensity, depth, init_T, records):
        """Frames 0 and 1: the second frame initializes the first local map
        (keyframe_tracker.cpp:227-246 -> local_tracker.cpp:127-155) with
        one single-stream match (one per stream for B streams); writes
        record rows 0 and 1."""
        device = intensity.device
        b = intensity.shape[0] if intensity.dim() == 4 else 0
        eye = torch.eye(4, dtype=f32, device=device)
        f0 = prep(build(intensity[..., 0, :, :], depth[..., 0, :, :]))
        f1 = prep(build(intensity[..., 1, :, :], depth[..., 1, :, :]))
        if b:
            # one one-stream match per stream, as each stream's solo run
            # makes it: the batched 6x6 solve and pose products round
            # otherwise than the one-stream ones (ROADMAP C), and every
            # later frame's warm start comes from this result
            T0, info0, nll0, n0, pix0 = (torch.stack(x) for x in zip(*(
                res_of(match(_stream_of(f0, i), _stream_of(f1, i), None))
                for i in range(b))))
        else:
            T0, info0, nll0, n0, pix0 = res_of(match(f0, f1, None))
        ok0 = finite(T0)
        T0m = _where(ok0, T0, eye)
        init_T = init_T.to(device=device, dtype=f32)
        state = _State(
            kf=ref_artifacts(f0),
            last=ref_artifacts(f1),
            kf_pose=init_T,
            last_pose=compose(b, init_T, T0m),
            last_to_kf=T0,
            last_kf_estimate=T0,
            eval_first=-nll0,
        )
        batch = init_T.shape[:-2]
        zeros = torch.zeros(batch + (_RES,), dtype=f32, device=device)
        records[..., 0, :] = torch.cat([torch.zeros(batch + (4,), dtype=f32, device=device),
                                        zeros, zeros, init_T.flatten(-2)], dim=-1)
        records[..., 1, :] = torch.cat([
            torch.tensor([1.0, 0.0, 0.0, 1.0], dtype=f32, device=device).expand(batch + (4,)),
            _flat_res(T0m, _where(ok0, info0, torch.eye(6, dtype=f32, device=device)),
                      nll0, n0, pix0),
            zeros,
            state.last_pose.flatten(-2),
        ], dim=-1)
        return state

    def scan(state, intensity, depth, force, records, start):
        """``step`` over frames [start, T) of the inputs, one record row
        each; nothing is read back."""
        for k in range(start, intensity.shape[-3]):
            state, records[..., k, :] = step(
                state, intensity[..., k, :, :], depth[..., k, :, :], force[..., k])
        return state

    def new_records(intensity):
        return torch.empty(intensity.shape[:-2] + (RECORD_WIDTH,), dtype=f32,
                           device=intensity.device)

    def run_first(intensity, depth, force, init_T):
        records = new_records(intensity)
        state = bootstrap(intensity, depth, init_T, records)
        return scan(state, intensity, depth, force, records, 2), records

    def run(intensity, depth, force, init_T):
        return run_first(intensity, depth, force, init_T)[1]

    def run_cont(state, intensity, depth, force):
        records = new_records(intensity)
        return scan(state, intensity, depth, force, records, 0), records

    if not chunked:
        return run
    return run_first, run_cont


class _StubFrame:
    """Timestamp-only stand-in for intermediate frames in the replayed
    LocalMap (the reference also only keeps vertices + timestamps for
    non-keyframe frames, keyframe_graph.cpp:759-772)."""

    __slots__ = ("timestamp", "index", "levels")

    def __init__(self, timestamp: float, index: int):
        self.timestamp = timestamp
        self.index = index
        self.levels = None


class _ReplayEvaluation:
    """LogLikelihoodEvaluation reconstructed from recorded values
    (tracking_result_evaluation.cpp:26-62 semantics)."""

    def __init__(self, first_value: float):
        self._first = first_value
        self._average = first_value
        self._n = 1.0

    def add_value(self, v: float):
        self._average += v
        self._n += 1.0

    # the voters' interface (constraint_proposal_voter.cpp:101-121)
    def value(self, r) -> float:
        return -float(r.neg_log_likelihood)

    def ratio_with_first(self, r) -> float:
        return self.value(r) / self._first

    def ratio_with_average(self, r) -> float:
        return self.value(r) / self._average * self._n


class StreamingSLAM:
    """Batch SLAM driver: the device front end + the replayed back end.

    ``track_sequence`` runs the whole front end on the device, then replays
    the recorded per-frame decisions through the standard KeyframeGraph
    (loop closures, optimization schedules and all).  Frames live on
    ``device``: the card unless the caller names another
    (``default_device``).
    """

    def __init__(self, intrinsics: Intrinsics, cfg: Optional[SlamConfig] = None,
                 ingest_level: Optional[int] = None, device=None):
        """``ingest_level``: pyramid level the host pre-reduces camera
        frames to before upload (:func:`host_reduce_ingest`).  Default: the
        tracker's last solved level, at most 3 — never upload pixels the
        solve cannot read (bit-exact).  Pass 0 to upload raw
        full-resolution frames."""
        self.cfg = cfg or SlamConfig()
        self.intrinsics = intrinsics
        self.device = default_device(device)
        self.ingest_level = (
            min(self.cfg.tracker.last_level, 3)  # u16-sum bound, see
            if ingest_level is None else ingest_level  # host_reduce_ingest
        )
        self._run = make_streaming_frontend(self.cfg, intrinsics, ingest_level=self.ingest_level)
        self._chunked = None
        self.graph = KeyframeGraph(intrinsics, self.cfg.graph, self.cfg.tracker)
        self.records: List[FrameRecord] = []

    def reset(self):
        """Fresh SLAM state: replaces the keyframe graph but keeps the
        validator and its prepared-artifact caches (a tracker restarting on
        a new sequence)."""
        # don't leak the old optimizer worker; a captured worker error is
        # discarded with the graph (reset is the documented recovery path
        # after a poisoned back end — it must not re-raise the failure)
        self.graph.shutdown(raise_errors=False)
        self.graph = KeyframeGraph(
            self.intrinsics, self.cfg.graph, self.cfg.tracker,
            validator=self.graph.validator,
        )
        self.records = []

    def _upload(self, intensity_u8, depth_u16):
        """Camera arrays [T, H, W] to the device, reduced on the host to the
        ingest level first."""
        if self.ingest_level:
            intensity_u8, depth_u16 = host_reduce_ingest(
                intensity_u8, depth_u16, self.ingest_level)
        # np.require copies only arrays that are not contiguous or not
        # writable (the native reduction returns read-only buffers)
        return tuple(torch.from_numpy(np.require(a, requirements=("C", "W"))).to(self.device)
                     for a in (intensity_u8, depth_u16))

    def _init_T(self, initial):
        init = np.eye(4, dtype=np.float32) if initial is None else np.asarray(initial, np.float32)
        return torch.from_numpy(init).to(self.device)

    def track_frontend(self, intensity_u8, depth_u16, initial=None, force_last=True):
        """Run only the device front end; returns (records, poses [T,4,4]).

        This is the throughput-critical path; the back end consumes the
        records afterwards (the reference's optimizer-thread split,
        SURVEY.md 2.5 P5).  The records come to the host in one copy.
        """
        t = intensity_u8.shape[0]
        force = np.zeros(t, bool)
        if force_last:
            force[-1] = True  # benchmark_slam.cpp:477-481
        d_iu, d_du = self._upload(np.asarray(intensity_u8), np.asarray(depth_u16))
        raw = self._run(d_iu, d_du, torch.from_numpy(force).to(self.device),
                        self._init_T(initial)).cpu().numpy()
        records = [_decode(raw[i]) for i in range(t)]
        poses = np.stack([r.pose for r in records])
        return records, poses

    def track_sequence(
        self,
        intensity_u8,
        depth_u16,
        timestamps,
        initial=None,
        force_last=True,
        finish=True,
        pipeline_chunk: Optional[int] = None,
    ):
        """Front end + replayed back end; returns online poses [T, 4, 4].

        ``pipeline_chunk`` = C runs the pipelined form: the front end runs
        in C-frame chunks whose state carries over, and chunk k's records
        are copied, decoded and fed to the back end (whose worker thread
        runs the validation waves) once chunk k+1 has been run, so the
        back end's work overlaps the front end's.  Records are bit-identical
        to the monolithic form; None keeps the single-run form."""
        if pipeline_chunk is not None and pipeline_chunk < 2:
            # the first chunk must hold the two bootstrap frames
            raise ValueError(
                f"pipeline_chunk must be >= 2 (the first chunk holds the "
                f"two bootstrap frames), got {pipeline_chunk}"
            )
        if pipeline_chunk is None or intensity_u8.shape[0] <= pipeline_chunk:
            records, poses = self.track_frontend(intensity_u8, depth_u16, initial, force_last)
            self.records = records
            self._replay(records, intensity_u8, depth_u16, timestamps)
        else:
            records, poses = self._track_pipelined(
                intensity_u8, depth_u16, timestamps, initial, force_last, pipeline_chunk,
            )
            self.records = records
        if finish:
            self.graph.final_optimization()
        return poses

    def _chunked_runs(self):
        """The chunked front end, made once (eager PyTorch has no
        per-shape program, so one pair serves every chunk size)."""
        if self._chunked is None:
            self._chunked = make_streaming_frontend(
                self.cfg, self.intrinsics, ingest_level=self.ingest_level, chunked=True)
        return self._chunked

    def _track_pipelined(self, intensity_u8, depth_u16, timestamps, initial, force_last, chunk):
        run_first, run_cont = self._chunked_runs()
        t = intensity_u8.shape[0]
        t_pad = -(-t // chunk) * chunk
        force = np.zeros(t_pad, bool)
        if force_last:
            force[t - 1] = True  # the padded tail rides with force off
        iu_np, du_np = np.asarray(intensity_u8), np.asarray(depth_u16)
        feeder = _ReplayFeeder(self, iu_np, du_np, timestamps)
        records: List[FrameRecord] = []

        def chunk_arrays(s):
            e = min(s + chunk, t)
            iu_c, du_c = iu_np[s:e], du_np[s:e]
            if e - s < chunk:  # pad with repeats of the last real frame
                reps = chunk - (e - s)
                iu_c = np.concatenate([iu_c, np.repeat(iu_c[-1:], reps, 0)])
                du_c = np.concatenate([du_c, np.repeat(du_c[-1:], reps, 0)])
            return self._upload(iu_c, du_c)

        def consume(raw_handle, s):
            raw = raw_handle.cpu().numpy()  # one copy per chunk
            for k in range(min(chunk, t - s)):
                rec = _decode(raw[k])
                records.append(rec)
                feeder.feed(rec)

        pending = None
        state = None
        for s in range(0, t_pad, chunk):
            d_i, d_d = chunk_arrays(s)
            d_f = torch.from_numpy(force[s: s + chunk]).to(self.device)
            if s == 0:
                state, raw = run_first(d_i, d_d, d_f, self._init_T(initial))
            else:
                state, raw = run_cont(state, d_i, d_d, d_f)
            if pending is not None:
                consume(*pending)  # chunk s has run: chunk s - C feeds the back end
            pending = (raw, s)
        consume(*pending)
        feeder.finish()
        poses = np.stack([r.pose for r in records])
        return records, poses

    def _frame(self, intensity_u8, depth_u16, timestamps, i) -> Frame:
        # raw u8/u16 upload of the full-resolution frame; u16/5000 + validity
        # conversion on the device (convert_raw_depth).  Every frame built
        # here is a keyframe: its first consumer is a loop-closure validation
        # wave, so the validator's (fine-config) solver artifacts are
        # prepared with it, under the validator's cache key.
        from .constraints import constraint_tracker_config

        return Frame.from_raw(
            np.asarray(intensity_u8[i]),
            np.asarray(depth_u16[i]),
            timestamps[i],
            self.cfg.tracker.num_levels,
            prepare_for=(constraint_tracker_config(self.cfg.tracker), self.intrinsics),
            device=self.device,
        )

    def _replay(self, records, intensity_u8, depth_u16, timestamps):
        """Rebuild the local maps / keyframe graph from the records —
        every decision comes from the front end, nothing is re-decided."""
        feeder = _ReplayFeeder(self, intensity_u8, depth_u16, timestamps)
        for rec in records:
            feeder.feed(rec)
        feeder.finish()

    def trajectory(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.graph.trajectory()


class _ReplayFeeder:
    """Incremental consumer of front-end records: the replay state machine
    fed one record at a time, so the pipelined driver can hand each chunk's
    records to the (worker-threaded) back end while the front end runs the
    next chunk.  Results are identical to the batch loop — the machine is
    strictly forward."""

    def __init__(self, slam: "StreamingSLAM", intensity_u8, depth_u16, timestamps):
        self.slam = slam
        self.mk = lambda i: slam._frame(intensity_u8, depth_u16, timestamps, i)
        self.timestamps = timestamps
        self.kcfg = slam.cfg.keyframe
        self._i = 0
        self._kf_index = 0
        self._prev_pose = None
        self.local_map: Optional[LocalMap] = None
        self.evaluation: Optional[_ReplayEvaluation] = None

    def feed(self, rec: FrameRecord):
        i = self._i
        self._i += 1
        if i == 0:
            self._first_pose = rec.pose
        elif i == 1:
            self.local_map = LocalMap.create(self.mk(0), self._first_pose)
            self.local_map.add_frame(_StubFrame(self.timestamps[1], 1))
            self.local_map.add_keyframe_measurement(rec.kf_T, rec.kf_info)
            self.evaluation = _ReplayEvaluation(-rec.kf_nll)
        else:
            # the entropy criterion's add() side effect fires whenever its
            # vote passes — even on frames other criteria reject; the host
            # loop runs all criteria before branching
            # (keyframe_tracker.cpp:105-121, local_tracker.cpp:192)
            if rec.entropy_ratio > self.kcfg.min_entropy_ratio:
                self.evaluation.add_value(-rec.kf_nll)
            if rec.accept:
                self.local_map.add_frame(_StubFrame(self.timestamps[i], i))
                self.local_map.add_odometry_measurement(rec.odo_T, rec.odo_info)
                self.local_map.add_keyframe_measurement(rec.kf_T, rec.kf_info)
            else:
                new_kf_index = getattr(self.local_map.current_frame, "index", self._kf_index)
                self.local_map.evaluation = self.evaluation
                # the completed map's current frame must be a real frame:
                # it becomes the next keyframe in the graph
                self.local_map.current_frame = self.mk(new_kf_index)
                self.slam.graph.add(self.local_map)
                # the new map anchors at the previous frame's pose
                # (local_tracker.cpp:200-213)
                self.local_map = LocalMap.create(self.mk(new_kf_index), self._prev_pose)
                self.local_map.add_frame(_StubFrame(self.timestamps[i], i))
                self.local_map.add_keyframe_measurement(
                    rec.odo_T if np.isfinite(rec.odo_T).all() else np.eye(4),
                    rec.odo_info,
                )
                self.evaluation = _ReplayEvaluation(-rec.odo_nll)
                self._kf_index = new_kf_index
        self._prev_pose = rec.pose

    def finish(self):
        """Flush the tail map (KeyframeTracker.finish semantics)."""
        if self.local_map is not None and self.local_map.num_frames > 0:
            self.local_map.evaluation = self.evaluation
            idx = getattr(self.local_map.current_frame, "index", self._kf_index)
            self.local_map.current_frame = self.mk(idx)
            self.slam.graph.add(self.local_map)
            self.local_map = None
