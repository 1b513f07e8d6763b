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
arrive widened to int32, as ``odometry.upload_sequence`` sends it).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import default_device
from ..config import TrackerConfig
from ..models.dense_tracker import match_prepared, match_pyramids, prepare_frame, ref_artifacts
from ..odometry import build_frame
from ..ops.camera import Intrinsics
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


def _track_streams(cfg: TrackerConfig, intrinsics: Intrinsics, intensity_u8, depth_u16):
    """Lockstep: [B, T, H, W] -> ``StreamTracks``.  Per stream, the
    reference's frame-to-frame accumulation with a constant-velocity warm
    start; each frame's artifacts are prepared once, for all B streams, and
    serve as the current frame now and as the reference frame next."""
    batch, frames = intensity_u8.shape[:2]
    device = intensity_u8.device
    eye = torch.eye(4, dtype=torch.float32, device=device).expand(batch, 4, 4)
    prev = ref_artifacts(
        prepare_frame(cfg, intrinsics, build_frame(cfg, intensity_u8[:, 0], depth_u16[:, 0]))
    )
    pose, rel = eye, eye
    poses, iterations, terminations = [], [], []
    for t in range(1, frames):
        cur = prepare_frame(cfg, intrinsics, build_frame(cfg, intensity_u8[:, t], depth_u16[:, t]))
        result = match_prepared(cfg, intrinsics, prev, cur, rel)
        rel = result.transformation
        pose = pose @ rel
        poses.append(pose)
        its, terms = _level_counts(result)
        iterations.append(its)
        terminations.append(terms)
        prev = ref_artifacts(cur)
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
