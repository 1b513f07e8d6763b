"""Peaks of the card and the least work of one tracker evaluation, counted
from the algorithm's inputs at a level's shape (never from the program's
own layouts), so that a roofline share keeps its meaning when the program
changes how it stores its tables.

One IRLS evaluation of a pyramid level of H x W pixels (N = H W) must
read, once each at 4 bytes a value: the reference frame's intensity and
depth and their image gradients (intensity x / y, depth x / y: six
images) and the current frame's intensity and depth (two images), and
write the 6 x 6 normal equations (A and b, 42 values) once.  Its
operations, per pixel, are those of the method, counted as below
(``FLOPS_PER_PIXEL``); the bound is the larger of bytes over the peak
bandwidth and operations over the peak float32 rate.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 80GB data sheet: HBM3 bandwidth and float32 (non-tensor)
# rate, at the card's 700 W power limit.
H100_PEAK_BYTES_PER_S = 3.35e12
H100_PEAK_FLOAT32_PER_S = 67e12

BYTES_PER_VALUE = 4
INPUT_IMAGES = 8  # reference i, z, di/dx, di/dy, dz/dx, dz/dy; current i, z
OUTPUT_VALUES = 42  # A (36) and b (6)

# operations per reference pixel of one evaluation
FLOPS_PER_PIXEL = (
    18  # transform the point: 3x3 rotation and translation
    + 6  # project: two divisions, two products, two sums
    + 12  # bilinear weights and the depth-buffer tests of four neighbours
    + 6 * 8  # six sampled channels (i, z, and the current frame's four gradients), four taps
    + 8  # residuals and the occlusion gate
    + 8  # t-distribution weight from the previous precision
    + 6  # scale sums (w r r^T, three entries)
    + 24  # Jacobian rows of the projection at the point
    + 36  # the two 6-vector Jacobians (gradient blend, depth row)
    + 2 * 78  # Gram of the weighted Jacobians: three 6x6 blocks' 78 distinct products, multiply-add
    + 2 * 24  # right-hand sides: four 6-vectors times residuals, multiply-add
    + 6  # log-likelihood term at the new precision
)


def evaluation_bytes(height: int, width: int) -> int:
    return INPUT_IMAGES * BYTES_PER_VALUE * height * width + OUTPUT_VALUES * BYTES_PER_VALUE


def evaluation_flops(height: int, width: int) -> int:
    return FLOPS_PER_PIXEL * height * width


def evaluation_bound_s(height: int, width: int) -> float:
    """The least time one evaluation can take on the card."""
    return max(evaluation_bytes(height, width) / H100_PEAK_BYTES_PER_S,
               evaluation_flops(height, width) / H100_PEAK_FLOAT32_PER_S)


def level_shape(shape, level: int):
    """(H, W) of pyramid level ``level`` of frames of ``shape`` (each level
    halves, rounding down)."""
    h, w = shape
    for _ in range(level):
        h, w = h // 2, w // 2
    return h, w
