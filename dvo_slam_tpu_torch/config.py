"""Configuration: the reference's dataclasses, re-exported.

``dvo_slam_tpu.config`` is plain frozen dataclasses and enums (it imports
only ``dataclasses`` and ``enum``), so the port uses it as it is: one
definition of ``TrackerConfig`` and the benchmark operating point for both
packages.  ``TrackerConfig.kernel_backend`` reads, in the port: ``auto``
takes the CUDA kernel for CUDA tensors and the plain twin for CPU tensors;
``pallas`` (the kernel) and ``fused`` (the twin) force one; ``xla``, the
modular oracle path, is not ported.
"""

from dvo_slam_tpu.config import (
    GraphConfig,
    InfluenceFunction,
    KeyframeConfig,
    ScaleEstimator,
    SlamConfig,
    TrackerConfig,
    benchmark_config,
)

__all__ = [
    "GraphConfig",
    "InfluenceFunction",
    "KeyframeConfig",
    "ScaleEstimator",
    "SlamConfig",
    "TrackerConfig",
    "benchmark_config",
]
