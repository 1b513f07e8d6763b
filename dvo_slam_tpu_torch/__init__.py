"""dvo_slam_tpu_torch — the PyTorch/CUDA port of dvo_slam_tpu.

This package runs the dense-alignment main path of ``dvo_slam_tpu`` (one
coarse-to-fine t-distribution IRLS Gauss-Newton alignment of two RGB-D
frames) in PyTorch.  Module and function names mirror the JAX package,
which stays the reference: each port function is held against its
same-named counterpart by the parity tests in ``tests/test_torch_*.py``.

The one Pallas kernel on this path, ``fused_stats_pallas``, is a CUDA C++
kernel for Hopper (``csrc/fused_stats.cu``), built with ``nvcc`` at first
use; its plain-PyTorch twin is the CPU path and the kernel's oracle.

This package imports ``torch`` and never ``jax``.
"""

from .config import (
    InfluenceFunction,
    ScaleEstimator,
    SlamConfig,
    TrackerConfig,
    benchmark_config,
)

__version__ = "0.1.0"

__all__ = [
    "InfluenceFunction",
    "ScaleEstimator",
    "SlamConfig",
    "TrackerConfig",
    "benchmark_config",
]
