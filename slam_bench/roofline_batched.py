"""The least work of one lockstep tracker evaluation of B streams (kernel
1b, ``fused_stats.cu``'s two launches on a grid of (blocks, B)), counted
as ``roofline`` counts one stream, from the algorithm's inputs at the
level's shape: each distinct frame read once, with its six reference
images (intensity, depth and their gradients) where some stream takes it
as its reference, else with its two current images (intensity and
depth), which the six hold; each stream writing its own normal equations
once.  The dual match (two references, one current frame) reads 14
images, a validation pair's forward and backward streams (each frame
both) 12.
"""

from __future__ import annotations

from slam_bench import roofline

REFERENCE_IMAGES = 6  # intensity, depth, di/dx, di/dy, dz/dx, dz/dy
CURRENT_IMAGES = roofline.INPUT_IMAGES - REFERENCE_IMAGES  # intensity, depth


def evaluation_bytes(height: int, width: int, batch: int, references: int,
                     currents: int) -> int:
    """``references``: the distinct frames some stream takes as its
    reference; ``currents``: those taken only as a current frame."""
    images = REFERENCE_IMAGES * references + CURRENT_IMAGES * currents
    return (images * height * width + batch * roofline.OUTPUT_VALUES) * roofline.BYTES_PER_VALUE


def evaluation_flops(height: int, width: int, batch: int) -> int:
    return batch * roofline.evaluation_flops(height, width)


def evaluation_bound_s(height: int, width: int, batch: int, references: int,
                       currents: int) -> float:
    """The least time one evaluation of ``batch`` streams can take on the
    card."""
    return max(evaluation_bytes(height, width, batch, references, currents)
               / roofline.H100_PEAK_BYTES_PER_S,
               evaluation_flops(height, width, batch) / roofline.H100_PEAK_FLOAT32_PER_S)
