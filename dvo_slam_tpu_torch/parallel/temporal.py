"""Temporal (sequence-parallel) odometry: one long stream cut into chunks
that are tracked as the streams of the multi-stream tracker (port of
``dvo_slam_tpu.parallel.temporal``).

Frame-to-frame odometry is a chain of relative poses, and relative poses
over disjoint chunks are independent: split a T-frame stream into C chunks
that overlap by one frame, track every chunk at once (the chunk axis is the
multi-stream tracker's stream axis, sharded over the ranks of a mesh), and
compose absolute poses afterwards.  The result matches the sequential
trajectory to solver tolerance: the constant-velocity warm start is
unavailable at chunk boundaries, and that difference carries through each
chunk's later warm starts.
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import TrackerConfig
from ..ops.camera import Intrinsics
from .mesh import BATCH_AXIS, Mesh
from .multistream import as_frames, host_frames, make_multistream_tracker


def chunk_sequence(intensity_u8, depth_u16, num_chunks: int) -> Tuple:
    """[T, H, W] -> ([C, L+1, H, W] intensity, depth) chunks overlapping by
    one frame (NumPy arrays or tensors).

    T-1 relative poses split as evenly as equal chunk lengths allow; the
    tail chunk is padded by repeating its last frame (self-matches solve to
    the identity and drop out in composition)."""
    t = intensity_u8.shape[0]
    if t < 2:
        raise ValueError("need at least 2 frames")
    rel = t - 1  # relative poses to estimate
    per = -(-rel // num_chunks)  # ceil
    idx = np.minimum(
        np.arange(num_chunks)[:, None] * per + np.arange(per + 1)[None, :], t - 1
    )  # [C, per+1], clamped repeats at the tail
    if isinstance(intensity_u8, torch.Tensor):
        index = torch.from_numpy(idx).to(intensity_u8.device)
        return intensity_u8[index], depth_u16[index.to(depth_u16.device)]
    return intensity_u8[idx], depth_u16[idx]


def compose_chunks(chunk_abs: np.ndarray, total_rel: int) -> np.ndarray:
    """[C, L, 4, 4] per-chunk absolute poses (pose of chunk-frame j+1 in
    chunk-frame 0's camera) -> [total_rel, 4, 4] stream-absolute poses.

    Each chunk's final pose re-anchors the next chunk; padded tail steps
    (self-matches, the identity) are dropped by the total_rel cutoff."""
    c, l = chunk_abs.shape[:2]
    out = np.empty((total_rel, 4, 4))
    base = np.eye(4)
    k = 0
    for ci in range(c):
        for j in range(l):
            if k >= total_rel:
                break
            out[k] = base @ chunk_abs[ci, j]
            k += 1
        base = base @ chunk_abs[ci, l - 1]
    return out


def _first_ranks(mesh: Mesh, n: int) -> Optional[Mesh]:
    """A mesh over the first ``n`` ranks of ``mesh`` (None on the ranks
    outside it).  Every rank of ``mesh`` must call this: creating a process
    group is collective."""
    ranks = list(range(n))
    if mesh.group is not None:
        ranks = [dist.get_global_rank(mesh.group, r) for r in ranks]
    group = dist.new_group(ranks)
    if mesh.rank >= n:
        return None
    return Mesh(group=group, axis=mesh.axis, rank=mesh.rank, size=n, device=mesh.device)


def make_temporal_tracker(
    cfg: TrackerConfig,
    intrinsics: Intrinsics,
    mesh: Optional[Mesh] = None,
    num_chunks: Optional[int] = None,
    axis: str = BATCH_AXIS,
    device=None,
):
    """Sequence-parallel tracker: ``run(intensity_u8 [T, H, W], depth_u16
    [T, H, W]) -> absolute poses [T-1, 4, 4]`` (float64 NumPy, frame t+1 in
    frame 0's camera).  ``num_chunks`` defaults to the mesh size (or 1).
    Without a mesh the chunks run on ``device``: by default tensors where
    they are and NumPy frames on the card (``as_frames``); with one, on
    each rank's ``mesh.device``.

    When the mesh size does not divide ``num_chunks``, the chunks run on the
    first n ranks, n the largest divisor that fits, as the reference
    shrinks its mesh; every rank calls ``run`` and gets the whole
    trajectory (the first rank broadcasts it to the others)."""
    if num_chunks is None:
        num_chunks = mesh.size if mesh is not None else 1
    run_mesh, shrunk = mesh, False
    if mesh is not None and num_chunks % mesh.size != 0:
        n = mesh.size
        while num_chunks % n != 0:
            n -= 1
        warnings.warn(
            f"num_chunks={num_chunks} not divisible by mesh size {mesh.size}; "
            f"shrinking to the first {n} ranks"
        )
        run_mesh, shrunk = _first_ranks(mesh, n), True
    tracker = None
    if mesh is None or run_mesh is not None:
        tracker = make_multistream_tracker(cfg, intrinsics, run_mesh, axis)

    def run(intensity_u8, depth_u16) -> np.ndarray:
        if mesh is None:
            intensity_u8, depth_u16 = as_frames(intensity_u8, depth_u16, device)
        else:  # chunked on the host; each rank's chunks go to its device
            intensity_u8, depth_u16 = host_frames(intensity_u8, depth_u16)
        t = int(intensity_u8.shape[0])
        chunks_i, chunks_d = chunk_sequence(intensity_u8, depth_u16, num_chunks)
        if tracker is not None:
            abs_in_chunk = tracker(chunks_i, chunks_d)
        else:
            abs_in_chunk = torch.empty(
                (num_chunks, chunks_i.shape[1] - 1, 4, 4), dtype=torch.float32, device=mesh.device
            )
        if shrunk:
            src = 0 if mesh.group is None else dist.get_global_rank(mesh.group, 0)
            dist.broadcast(abs_in_chunk, src=src, group=mesh.group)
        # the multi-stream tracker returns per-chunk ABSOLUTE poses (relative
        # to the chunk's frame 0); compose the chunk bases on the host
        return compose_chunks(abs_in_chunk.cpu().numpy().astype(np.float64), t - 1)

    return run
