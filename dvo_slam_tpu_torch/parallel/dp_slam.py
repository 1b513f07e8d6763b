"""Data-parallel end-to-end SLAM over the ranks of a mesh (port of
``dvo_slam_tpu.parallel.dp_slam``).

The reference's whole-pipeline contract is one sequence through front end,
loop closure and final optimization (dvo_benchmark/src/benchmark_slam.cpp:
352-525).  Its data-parallel form runs B independent sequences: the
streaming front end (``models/streaming``) over all B streams at once,
the stream axis cut over the mesh (the reference's ``jax.vmap`` under a
``P(batch)`` sharding), then every stream's back end (keyframe graph,
validation waves, final optimization) replays that stream's records.

Here each rank takes its contiguous block of B / world streams to its own
card and runs them in lockstep through the front end's stream axis (one
``match_prepared`` call at 2 x block per frame); then it replays the back
ends of its own streams, as the reference's comment has each host drive
its own chip on multi-host hardware.  One all-gather of the online poses
and one of the optimized trajectories give every rank every stream's
result.  Without a mesh all B streams run in lockstep on one device.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import default_device
from ..config import SlamConfig
from ..models.streaming import StreamingSLAM, _decode, host_reduce_ingest, make_streaming_frontend
from ..ops.camera import Intrinsics
from .mesh import Mesh


class DataParallelSLAM:
    """B-sequence end-to-end SLAM, the streams cut over a mesh.

    ``track_sequences(iu8 [B,T,H,W], du16 [B,T,H,W], timestamps [T])``
    runs the lockstep front end over this rank's streams, replays each of
    them through its own ``KeyframeGraph`` back end and final optimization,
    and returns every stream's online poses [B, T, 4, 4]; ``trajectories()``
    returns every stream's optimized (stamps, poses).  ``slams`` holds the
    ``StreamingSLAM`` of this rank's own streams only (all B without a
    mesh): a back end lives on the rank that tracked its stream.

    Streams run on ``mesh.device`` with a mesh, else on ``device`` (the
    card unless the caller names another, ``default_device``).
    """

    def __init__(self, intrinsics: Intrinsics, cfg: Optional[SlamConfig] = None,
                 mesh: Optional[Mesh] = None, ingest_level: Optional[int] = None, device=None):
        self.cfg = cfg or SlamConfig()
        self.intrinsics = intrinsics
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else default_device(device)
        self.ingest_level = (
            min(self.cfg.tracker.last_level, 3) if ingest_level is None else ingest_level
        )
        self._front = make_streaming_frontend(self.cfg, intrinsics, ingest_level=self.ingest_level)
        self.slams: List[StreamingSLAM] = []
        self._trajectories: List[Tuple[np.ndarray, np.ndarray]] = []

    def _block(self, b: int) -> range:
        """This rank's contiguous streams of ``b`` (all of them without a mesh)."""
        if self.mesh is None:
            return range(b)
        if b % self.mesh.size:
            raise ValueError(
                f"batch {b} must be a multiple of the mesh size {self.mesh.size} "
                f"(one or more whole streams per rank)"
            )
        per = b // self.mesh.size
        return range(self.mesh.rank * per, (self.mesh.rank + 1) * per)

    def track_sequences(self, intensity_u8, depth_u16, timestamps, force_last: bool = True,
                        finish: bool = True) -> np.ndarray:
        iu8 = np.asarray(intensity_u8)
        du16 = np.asarray(depth_u16)
        b, t = iu8.shape[:2]
        block = self._block(b)
        local_i, local_d = iu8[block.start: block.stop], du16[block.start: block.stop]
        n = len(block)
        force = np.zeros((n, t), bool)
        if force_last:
            force[:, -1] = True  # benchmark_slam.cpp:477-481
        init = np.broadcast_to(np.eye(4, dtype=np.float32), (n, 4, 4))

        if self.ingest_level:
            iu_r, du_r = host_reduce_ingest(local_i.reshape((-1,) + iu8.shape[2:]),
                                            local_d.reshape((-1,) + du16.shape[2:]),
                                            self.ingest_level)
            iu_r = iu_r.reshape((n, t) + iu_r.shape[1:])
            du_r = du_r.reshape((n, t) + du_r.shape[1:])
        else:
            iu_r, du_r = local_i, local_d

        def put(a):
            # np.require copies only what is not contiguous or not writable
            return torch.from_numpy(np.require(a, requirements=("C", "W"))).to(self.device)

        # this rank's streams in lockstep; one copy of their [n, T, 130] records
        raw = self._front(put(iu_r), put(du_r), put(force), put(init)).cpu().numpy()

        # per-stream back ends: replay + loop closure + final pass
        self.shutdown()
        self.slams = []
        poses = np.zeros((n, t, 4, 4))
        for s in range(n):
            slam = StreamingSLAM(self.intrinsics, self.cfg, ingest_level=self.ingest_level,
                                 device=self.device)
            records = [_decode(raw[s, i]) for i in range(t)]
            slam.records = records
            slam._replay(records, local_i[s], local_d[s], timestamps)
            if finish:
                slam.graph.final_optimization()
            else:
                slam.graph.wait_for_queue()
            poses[s] = np.stack([r.pose for r in records])
            self.slams.append(slam)
        self._trajectories = [s.trajectory() for s in self.slams]
        if self.mesh is None:
            return poses
        # every stream's results on every rank, in stream order
        parts = [torch.empty((n, t, 4, 4), dtype=torch.float64, device=self.device)
                 for _ in range(self.mesh.size)]
        dist.all_gather(parts, torch.from_numpy(poses).to(self.device), group=self.mesh.group)
        gathered = [None] * self.mesh.size
        dist.all_gather_object(gathered, self._trajectories, group=self.mesh.group)
        self._trajectories = [tr for part in gathered for tr in part]
        return torch.cat(parts).cpu().numpy()

    def trajectories(self) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Every stream's optimized (stamps, poses) from its back end."""
        return list(self._trajectories)

    def shutdown(self):
        for s in self.slams:
            s.graph.shutdown()
