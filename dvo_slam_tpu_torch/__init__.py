"""dvo_slam_tpu_torch — the PyTorch/CUDA port of dvo_slam_tpu.

This package runs the dense-alignment main path of ``dvo_slam_tpu`` (one
coarse-to-fine t-distribution IRLS Gauss-Newton alignment of two RGB-D
frames) in PyTorch, with frame-to-frame odometry, B camera streams in
lockstep, temporal chunking and the multi-rank alignments on
``torch.distributed``.  Module and function names mirror the JAX package,
which stays the reference: each port function is held against its
same-named counterpart by the parity tests in ``tests/test_torch_*.py``.

Every Pallas kernel of the reference is a CUDA C++ kernel for Hopper
(``csrc/fused_stats.cu``, ``csrc/table_copy.cu``), built with ``nvcc`` at
first use; each has a plain-PyTorch version, the CPU path and the kernel's
oracle.

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
