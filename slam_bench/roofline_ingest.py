"""The least work of one ingest of raw RGB-D frames (``csrc/ingest.cu``'s
kernels A and B, one launch each for a frame or a rig's B frames), counted
from what the ingest must read and write: each byte of the raw frames read
once (u8 intensity and u16 depth), and each byte of kernel A's outputs (per
stored pyramid level and pixel, six float32 fields and two bool masks) and
of kernel B's (per pixel of the solve range, the bool selection, the
refpack's 8 float32 rows and, on the fused path, the quad table's 32)
written once.  Kernel B's reads of kernel A's fields are left out: a single
kernel need not make them.  The bound is the bytes over the card's peak
bandwidth (``roofline``); the operations, a few per value, are far below
the float32 peak.
"""

from __future__ import annotations

from slam_bench import roofline

RAW_BYTES_PER_PIXEL = 1 + 2  # u8 intensity, u16 depth
LEVEL_BYTES_PER_PIXEL = 6 * 4 + 2  # intensity, depth, four gradients; valid, zvalid
SOLVE_BYTES_PER_PIXEL = 1 + 8 * 4  # sel, refpack
QUAD_BYTES_PER_PIXEL = 32 * 4


def _pixels(shape, levels) -> int:
    return sum(h * w for h, w in (roofline.level_shape(shape, k) for k in levels))


def ingest_bytes(shape, num_levels: int, solve, streams: int, skip_below: int = 0,
                 quad: bool = True) -> int:
    """Bytes of one ingest of ``streams`` frames of level-0 ``shape`` with
    levels ``skip_below`` .. ``num_levels`` - 1 stored and the solve range
    ``solve`` = (last, first) prepared."""
    h, w = shape
    solve_px = _pixels(shape, range(solve[0], solve[1] + 1))
    per_stream = (RAW_BYTES_PER_PIXEL * h * w
                  + LEVEL_BYTES_PER_PIXEL * _pixels(shape, range(skip_below, num_levels))
                  + (SOLVE_BYTES_PER_PIXEL + (QUAD_BYTES_PER_PIXEL if quad else 0)) * solve_px)
    return streams * per_stream


def ingest_bound_s(shape, num_levels: int, solve, streams: int, skip_below: int = 0,
                   quad: bool = True) -> float:
    """The least time one ingest of ``streams`` frames can take on the card."""
    return (ingest_bytes(shape, num_levels, solve, streams, skip_below, quad)
            / roofline.H100_PEAK_BYTES_PER_S)
