"""The 1-D rank mesh of the multi-rank paths (port of
``dvo_slam_tpu.parallel.mesh``).

The reference builds a JAX ``Mesh`` over devices.  Here a mesh is the
initialised ``torch.distributed`` process group seen from one rank: its
group, axis name, rank, size and the rank's device.  It is a small
``NamedTuple`` rather than a ``DeviceMesh``, because the CUDA tests run two
gloo ranks on one card, which a ``DeviceMesh`` (one device per rank) does
not describe.  There is no mesh without a process group: a one-rank run
initialises one too, so the collectives are always on the path.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

BATCH_AXIS = "batch"


class Mesh(NamedTuple):
    group: Optional[object]  # the process group (None: the default group)
    axis: str
    rank: int
    size: int
    device: torch.device


def rank_device(rank: int, device=None) -> torch.device:
    """Rank r's device.  By default, and for ``device="cuda"``, the card
    ``cuda:(r % device_count)``: raises where no card is visible.  A device
    with an index (``"cuda:0"``: several ranks on one card) or ``"cpu"``
    is taken as it is named."""
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda" or device.index is not None:
            return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"rank {rank}: no CUDA device is visible; the multi-rank paths run on "
            'the card by default (pass device="cpu" for a CPU mesh over gloo)'
        )
    return torch.device("cuda", rank % torch.cuda.device_count())


def make_mesh(n_devices: Optional[int] = None, axis: str = BATCH_AXIS, device=None) -> Mesh:
    """1-D mesh over the ranks of the initialised process group.
    ``n_devices``, when given, must be the world size.  Each rank's device
    is its card (``rank_device``), which raises where there is none; only
    ``device="cpu"`` gives a CPU mesh."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh: no process group; call parallel.distributed.initialize() first"
        )
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh: {n_devices} devices asked, the process group has {size} ranks")
    rank = dist.get_rank()
    return Mesh(group=None, axis=axis, rank=rank, size=size, device=rank_device(rank, device))


def replicated(tree, mesh: Mesh):
    """Every rank holds the whole value: the identity."""
    del mesh
    return tree


def local_block(x: torch.Tensor, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """This rank's contiguous block of ``x`` along ``dim``, after zero
    padding that axis to a multiple of the mesh size (the reference's
    ``jnp.pad`` then ``P(None, axis)`` cut for ``dim=1``)."""
    n = x.shape[dim]
    per = -(-n // mesh.size)
    pad = [0, 0] * (x.dim() - 1 - dim) + [0, per * mesh.size - n]
    x = F.pad(x, pad)
    return x.narrow(dim, mesh.rank * per, per).contiguous()


def shard_leading_axis(tree, mesh: Mesh, axis: str = BATCH_AXIS):
    """Every tensor leaf of a (nested) tuple cut to this rank's contiguous
    slice of its leading axis, which the mesh size must divide; ``None``
    leaves stay ``None``."""
    if axis != mesh.axis:
        raise ValueError(f"shard_leading_axis: mesh axis is {mesh.axis!r}, not {axis!r}")
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        if tree.shape[0] % mesh.size:
            raise ValueError(
                f"shard_leading_axis: leading axis {tree.shape[0]} does not divide "
                f"over {mesh.size} ranks"
            )
        per = tree.shape[0] // mesh.size
        return tree[mesh.rank * per : (mesh.rank + 1) * per]
    items = [shard_leading_axis(t, mesh, axis) for t in tree]
    return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
