"""Multi-stream dense odometry: many RGB-D camera streams per card (port
of ``dvo_slam_tpu.parallel.multistream``).

One 640x480 stream leaves the card idle most of the time: every solver
iteration is a few hundred small kernels.  B independent streams that
advance in lockstep share one set of kernels on [B, ...] tensors per
iteration and one loop over a [B] done mask (``match_prepared`` on
batched prepared frames: on the card each level one while-graph launch
around the batched folded kernel, on the CPU one read of the mask per
iteration).  A stream that has converged keeps its
estimate while the others iterate, as in the reference's vmapped
``lax.while_loop``, so each stream's iterations, terminations and poses
are those of its single-stream solve.

Two schedules, as in the reference:
  * ``lockstep``: all streams together (the live multi-camera shape);
  * ``sequential``: the streams one after another through the
    single-stream tracker (``match_pyramids``), for batch reprocessing.
The reference's two lockstep forms are this one batched form here: its
standalone-table form (the fused backends, with a switch from the Pallas
kernel to the XLA twin under ``vmap`` that works around the TPU and has
no counterpart: CUDA tensors take the batched kernel) and
``_track_streams_vmapped`` (the modular backend: ``match_prepared`` on
batched frames prepared for it runs the modular evaluation on [B, ...]
tensors, a finished stream's carry frozen as on the fused path).

With a mesh each rank tracks its contiguous B / world streams and one
all-gather returns every stream's results to every rank (the reference's
``shard_map`` with ``out_specs=P(axis)``).

Input is camera-native u8 intensity / u16 depth [B, T, H, W] (u16 may
arrive widened to int32, as ``odometry.upload_sequence`` sends it).  A live
rig hands its B cameras' frames over one rig frame at a time:
:class:`LockstepTracker` (``make_frames_raw`` + ``update``), which the
lockstep schedule runs frame after frame.  On the card a rig frame's B raw
frames become their pyramids and prepared tables in one upload and two
launches of the ingest kernels (``ops/ingest``), off the card through the
plain chain.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import default_device
from ..config import TrackerConfig
from ..models.dense_tracker import (FLAT_BASE, PreparedFrame, match_prepared_flat,
                                    match_pyramids, ref_artifacts, result_from_row)
from ..models.frames import ingest_raw, new_frame_id
from ..odometry import build_frame
from ..ops.camera import Intrinsics
from ..utils import timers
from .mesh import BATCH_AXIS, Mesh, shard_leading_axis

SCHEDULES = ("lockstep", "sequential")


class StreamTracks(NamedTuple):
    """What the multi-stream trackers return.  Levels run coarse to fine
    (``cfg.first_level`` down to ``cfg.last_level``)."""

    poses: torch.Tensor  # [B, T-1, 4, 4] pose of frame t+1 in frame 0's camera
    iterations: torch.Tensor  # [B, T-1, levels] int32 solver iterations per level
    termination: torch.Tensor  # [B, T-1, levels] int32 termination code per level
    loop_iterations: int  # solver loop iterations this rank ran


def host_frames(intensity_u8, depth_u16):
    """NumPy frames as host tensors (u16 depth widened to int32); tensors
    as they are."""
    if isinstance(intensity_u8, np.ndarray):
        intensity_u8 = torch.from_numpy(intensity_u8)
    if isinstance(depth_u16, np.ndarray):
        depth_u16 = torch.from_numpy(depth_u16.astype(np.int32))
    return intensity_u8, depth_u16


def as_frames(intensity_u8, depth_u16, device=None):
    """Frames as tensors (NumPy u16 depth widened to int32) on ``device``.
    With no ``device``, NumPy frames go to the card, which raises where
    there is none (``default_device``; ``device="cpu"`` asks for the CPU),
    and tensors stay where they are."""
    from_host = isinstance(intensity_u8, np.ndarray) or isinstance(depth_u16, np.ndarray)
    intensity_u8, depth_u16 = host_frames(intensity_u8, depth_u16)
    if device is not None or from_host:
        device = default_device(device)
        intensity_u8, depth_u16 = intensity_u8.to(device), depth_u16.to(device)
    return intensity_u8, depth_u16


def _level_counts(result):
    """A result's per-level iterations and terminations, stacked on the
    last axis (device tensors: no read-back)."""

    def stack(field):
        return torch.stack([getattr(s, field) for s in result.level_stats], dim=-1)

    return stack("iterations"), stack("termination")


class RigFrame(NamedTuple):
    """One frame of a rig: its B streams' prepared artifacts ([B, ...]),
    its timestamp and its number among the process's frames (the spans of
    its ingest and update carry it)."""

    prepared: PreparedFrame
    timestamp: float
    frame_id: int


class LockstepTracker:
    """B camera streams tracked frame to frame in lockstep, one rig frame at
    a time: per stream the reference's accumulation with a constant-velocity
    warm start (the previous relative pose), each frame's artifacts prepared
    once, as the current frame now and as the reference frame next, and one
    ``match_prepared`` of the B pairs a rig frame (on the card one launch of
    the match graph around kernel 1b at B).

    ``make_frames_raw(intensity_u8, depth_u16, stamp)`` takes the B frames
    of each channel as a sequence of [H, W] host arrays, an array [B, H, W]
    or a tensor [B, H, W] (``frames.ingest_raw``: on the card one upload
    and two launches, levels below ``cfg.last_level`` not built);
    ``update(frame)`` returns each stream's accumulated pose [B, 4, 4]
    (float32 on the device, widened to float64 on the host) after one wait
    for the card; ``step(frame)`` does the device work of ``update`` and
    returns without one.  ``last_result`` is the last match's
    ``TrackingResult`` on the host (its ``level_stats`` [B] per level);
    ``reset()`` starts every stream again from the identity and keeps the
    counts.

    Spans: ``dvo.ingest`` (around ``ingest_raw``'s) and ``dvo.rig.update``,
    each with the rig frame's id.  Counts (``counts()``,
    always on): the rig frames updated and, by pyramid level, the lockstep
    loop's stream-steps (B times the loop's iterations, which run until the
    slowest stream is done) and the streams' own iterations."""

    def __init__(self, cfg: TrackerConfig, intrinsics: Intrinsics, streams: int, device=None):
        self.cfg, self.intrinsics, self.streams = cfg, intrinsics, int(streams)
        self.device = default_device(device)
        levels = range(cfg.first_level, cfg.last_level - 1, -1)
        self._counts = {"frames": 0, "stream_steps": dict.fromkeys(levels, 0),
                        "iterations": dict.fromkeys(levels, 0)}
        self.reset()

    def reset(self):
        eye = torch.eye(4, dtype=torch.float32, device=self.device).expand(self.streams, 4, 4)
        self.reference: Optional[PreparedFrame] = None
        self.pose, self.rel = eye, eye
        self.last_result = None

    def make_frames_raw(self, intensity_u8, depth_u16, stamp: float) -> RigFrame:
        frame_id = new_frame_id()
        with timers.span("dvo.ingest", frame=frame_id):
            _, prepared = ingest_raw(intensity_u8, depth_u16, self.cfg.num_levels,
                                     (self.cfg, self.intrinsics), self.device, self.streams,
                                     self.cfg.last_level)
        return RigFrame(prepared, float(stamp), frame_id)

    def step(self, frame: RigFrame):
        """Track ``frame`` on the device: (the poses [B, 4, 4], the match's
        flat result row [B, 53 + 4 levels], None for the first frame)."""
        row = None
        if self.reference is not None:
            row = match_prepared_flat(self.cfg, self.intrinsics, self.reference, frame.prepared,
                                      self.rel)
            self.rel = row[:, :16].reshape(self.streams, 4, 4)
            self.pose = self.pose @ self.rel
        self.reference = ref_artifacts(frame.prepared)
        return self.pose, row

    def update(self, frame: RigFrame) -> np.ndarray:
        with timers.span("dvo.rig.update", frame=frame.frame_id):
            pose, row = self.step(frame)
            self._counts["frames"] += 1
            if row is None:
                return pose.cpu().numpy().astype(np.float64)
            host = torch.cat([pose.reshape(self.streams, 16), row], dim=1).cpu()
            self.last_result = result_from_row(host[:, 16:])
            its = host[:, 16 + FLAT_BASE:].reshape(self.streams, -1, 4)[..., 2].to(torch.int64)
            for j, level in enumerate(self._counts["iterations"]):
                self._counts["stream_steps"][level] += self.streams * int(its[:, j].max())
                self._counts["iterations"][level] += int(its[:, j].sum())
            return host[:, :16].reshape(self.streams, 4, 4).numpy().astype(np.float64)

    def counts(self) -> Dict[str, object]:
        """``frames``; ``stream_steps`` and ``iterations`` by pyramid level
        (coarse first), since the tracker was made."""
        c = self._counts
        return {"frames": c["frames"], "stream_steps": dict(c["stream_steps"]),
                "iterations": dict(c["iterations"])}


def _track_streams(cfg: TrackerConfig, intrinsics: Intrinsics, intensity_u8, depth_u16):
    """Lockstep: [B, T, H, W] -> ``StreamTracks``, one ``LockstepTracker``
    step a frame, with no read-back."""
    batch, frames = intensity_u8.shape[:2]
    tracker = LockstepTracker(cfg, intrinsics, batch, device=intensity_u8.device)
    poses, iterations, terminations = [], [], []
    for t in range(frames):
        pose, row = tracker.step(tracker.make_frames_raw(intensity_u8[:, t], depth_u16[:, t], t))
        if row is None:
            continue
        poses.append(pose)
        counts = row[:, FLAT_BASE:].reshape(batch, -1, 4).to(torch.int32)
        iterations.append(counts[..., 2])
        terminations.append(counts[..., 3])
    iterations = torch.stack(iterations, dim=1)
    # the loop runs each level until its slowest stream is done
    loop = int(iterations.amax(dim=0).sum())
    return StreamTracks(torch.stack(poses, dim=1), iterations,
                        torch.stack(terminations, dim=1), loop)


def _track_one_stream(cfg: TrackerConfig, intrinsics: Intrinsics, intensity_u8, depth_u16):
    """One stream [T, H, W] through the single-stream tracker ->
    (poses [T-1, 4, 4], iterations [T-1, levels], terminations [T-1,
    levels])."""
    device = intensity_u8.device
    eye = torch.eye(4, dtype=torch.float32, device=device)
    prev = build_frame(cfg, intensity_u8[0], depth_u16[0])
    pose, rel = eye, eye
    poses, iterations, terminations = [], [], []
    for t in range(1, intensity_u8.shape[0]):
        cur = build_frame(cfg, intensity_u8[t], depth_u16[t])
        result = match_pyramids(cfg, intrinsics, prev, cur, rel)
        rel = result.transformation
        pose = pose @ rel
        poses.append(pose)
        its, terms = _level_counts(result)
        iterations.append(its)
        terminations.append(terms)
        prev = cur
    return torch.stack(poses), torch.stack(iterations), torch.stack(terminations)


def _track_streams_sequential(cfg: TrackerConfig, intrinsics: Intrinsics, intensity_u8, depth_u16):
    """Sequential: the streams one after another through the single-stream
    tracker -> ``StreamTracks``."""
    per_stream = [
        _track_one_stream(cfg, intrinsics, intensity_u8[b], depth_u16[b])
        for b in range(intensity_u8.shape[0])
    ]
    poses, iterations, terminations = (torch.stack(f) for f in zip(*per_stream))
    return StreamTracks(poses, iterations, terminations, int(iterations.sum()))


def _all_gather(local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    parts = [torch.empty_like(local) for _ in range(mesh.size)]
    dist.all_gather(parts, local.contiguous(), group=mesh.group)
    return torch.cat(parts)


def make_multistream_tracker(
    cfg: TrackerConfig,
    intrinsics: Intrinsics,
    mesh: Optional[Mesh] = None,
    axis: str = BATCH_AXIS,
    schedule: str = "lockstep",
    device=None,
):
    """Multi-stream tracker: ``run(intensity_u8 [B, T, H, W], depth_u16
    [B, T, H, W]) -> poses [B, T-1, 4, 4]``; ``run.tracks`` takes the same
    arguments and returns the whole ``StreamTracks``.

    Without a mesh the streams run on ``device``: by default tensors where
    they are and NumPy frames on the card (``as_frames``).  With a mesh,
    every rank passes all B streams (B divisible by the world size),
    tracks its contiguous B / world on ``mesh.device`` and gets every
    stream's results; ``loop_iterations`` is then this rank's own count."""
    if schedule == "lockstep":
        inner = _track_streams
    elif schedule == "sequential":
        inner = _track_streams_sequential
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    if mesh is not None and axis != mesh.axis:
        raise ValueError(f"mesh axis is {mesh.axis!r}, not {axis!r}")

    def tracks(intensity_u8, depth_u16) -> StreamTracks:
        if mesh is None:
            return inner(cfg, intrinsics, *as_frames(intensity_u8, depth_u16, device))
        # the rank's streams only go to its device
        local_frames = shard_leading_axis(host_frames(intensity_u8, depth_u16), mesh, axis)
        local = inner(cfg, intrinsics, *as_frames(*local_frames, mesh.device))
        return StreamTracks(
            *(_all_gather(f, mesh) for f in local[:3]), loop_iterations=local.loop_iterations
        )

    def run(intensity_u8, depth_u16) -> torch.Tensor:
        return tracks(intensity_u8, depth_u16).poses

    run.tracks = tracks
    return run
