"""Multi-process runtime: process-group start-up and host-level work
partition (port of ``dvo_slam_tpu.parallel.distributed``).

``initialize`` wraps ``torch.distributed.init_process_group``;
``HostWorkPartition`` assigns host-level work (ingest shards, keyframe
ownership) by rank, off the device path.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..models import irls_graph
from .mesh import rank_device
from .sharded_alignment import while_probe


def initialize(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
) -> bool:
    """Initialise the process group (idempotent); returns whether more
    than one rank is active.

    With no arguments, reads ``MASTER_ADDR``/``MASTER_PORT`` (the
    rendezvous, ``tcp://addr:port``), ``WORLD_SIZE`` and ``RANK``.  The
    rank runs on its card (``mesh.rank_device``) and raises where none is
    visible; only ``device="cpu"`` starts a CPU rank.  The backend is
    ``nccl`` for a card and ``gloo`` for the CPU, unless it is named; a
    rank on a card first makes it the current device.  Each group started
    here is a new generation of ``irls_graph.group_key``: no CUDA graph of
    an earlier group is replayed on it.  A NCCL group on the card then
    chooses, once, the form of the loops whose graphs hold its collectives
    (the pixel-sharded level, block-CG over the ranks): every rank builds
    the probe of ``sharded_alignment.while_probe`` (a while graph whose
    body holds the group's all-reduces and kernel 2's clustered launch),
    and the group's loops run as while graphs where CUDA admitted and ran
    it, else host-polled; ``irls_graph.stats()["group_forms"]`` reports
    the form, with CUDA's refusal where there was one."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if init_method is None:
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
        if not addr or not port:
            raise ValueError(
                "initialize: give init_method or set MASTER_ADDR and MASTER_PORT"
            )
        init_method = f"tcp://{addr}:{port}"
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    device = rank_device(rank, device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank
    )
    irls_graph.new_generation()
    if device.type == "cuda" and backend == "nccl":
        while_probe(device)
    return world_size > 1


def shutdown() -> None:
    """Destroy the process group, if one is initialised.  First the CUDA
    graphs captured over it (the pixel-sharded level's and block-CG's,
    whose collectives keep its communicator baked in, their while graphs
    too) are released, once the card has finished what it queued, and its
    probed form is dropped."""
    if dist.is_initialized():
        tag = irls_graph.group_key()
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        irls_graph.release(where=lambda key: tag in key)
        irls_graph.forget_group(tag)
        dist.destroy_process_group()


@dataclasses.dataclass(frozen=True)
class HostWorkPartition:
    """Deterministic host-level ownership by rank."""

    process_id: int
    num_processes: int

    @staticmethod
    def current() -> "HostWorkPartition":
        if dist.is_initialized():
            return HostWorkPartition(dist.get_rank(), dist.get_world_size())
        return HostWorkPartition(0, 1)

    def owns_keyframe(self, keyframe_id: int) -> bool:
        """Keyframe ownership for loop-closure search fan-out: each rank
        searches/validates proposals only for its keyframes, then the
        accepted edges are all-gathered into every rank's graph replica."""
        return keyframe_id % self.num_processes == self.process_id

    def frame_shard(self, num_frames: int) -> Tuple[int, int]:
        """Contiguous [start, stop) ingest range for this rank (batch
        reprocessing / dataset sweep mode)."""
        per = -(-num_frames // self.num_processes)
        start = min(self.process_id * per, num_frames)
        return start, min(start + per, num_frames)

    def local_items(self, items: Sequence) -> List:
        return [x for i, x in enumerate(items) if i % self.num_processes == self.process_id]
