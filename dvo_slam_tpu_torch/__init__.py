"""dvo_slam_tpu_torch — the PyTorch/CUDA port of dvo_slam_tpu.

This package runs the dense-alignment main path of ``dvo_slam_tpu`` (one
coarse-to-fine t-distribution IRLS Gauss-Newton alignment of two RGB-D
frames) in PyTorch, with frame-to-frame odometry, B camera streams in
lockstep, temporal chunking, the multi-rank alignments on
``torch.distributed``, and the SLAM system: the tracking front end
(``models/frames``, ``local_map``, ``local_tracker``, ``camera_tracker``),
the back end (``pose_graph``, ``constraints``, ``keyframe_graph``,
``keyframe_tracker``), the batch front end (``models/streaming``) and the
drivers (``cli/benchmark``, ``utils/dataset``, ``utils/serialization``,
``native``).  Module and function names mirror the
JAX package, which stays the reference: each port function is held
against its same-named counterpart by the parity tests in
``tests/test_torch_*.py``.

Every Pallas kernel of the reference is a CUDA C++ kernel for Hopper
(``csrc/fused_stats.cu``, ``csrc/table_copy.cu``), built with ``nvcc`` at
first use; each has a plain-PyTorch version, the CPU path and the kernel's
oracle.

Its entry points run on the card: a function that puts data on a device
takes a ``device`` argument whose default is the card, and raises where
there is none; the CPU (the parity tests' device) is asked for by name,
``device="cpu"``.

This package imports ``torch`` and never ``jax``.
"""

import torch

from .config import (
    InfluenceFunction,
    ScaleEstimator,
    SlamConfig,
    TrackerConfig,
    benchmark_config,
)

__version__ = "0.1.0"



def default_device(device=None) -> torch.device:
    """The device an entry point puts its data on: ``device`` where the
    caller names one (``"cpu"`` is how the CPU is asked for), else the
    current card.  Raises where no card is visible: nothing falls back
    to the CPU unasked."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible: the port runs on the card by default; "
            'pass device="cpu" to run on the CPU'
        )
    return torch.device("cuda", torch.cuda.current_device())


__all__ = [
    "InfluenceFunction",
    "ScaleEstimator",
    "SlamConfig",
    "TrackerConfig",
    "benchmark_config",
    "default_device",
]
