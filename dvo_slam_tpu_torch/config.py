"""Configuration dataclasses of the port: the tracker, keyframe and graph
configs and the benchmark operating point, with the reference's names,
fields and defaults (``dvo_slam_tpu.config``).

The port keeps its own copy, so that it imports nothing of the JAX
package.  The two packages' enums are distinct classes, so a config moves
between them through ``convert.config_to_reference`` /
``convert.config_from_reference``, which map fields and enum members by
name.

``TrackerConfig.kernel_backend`` reads, in the port: ``auto`` takes the
CUDA kernel for CUDA tensors and the plain twin for CPU tensors;
``pallas`` (the kernel) and ``fused`` (the twin) force one; ``xla``, the
modular oracle path, is not ported.
"""

from __future__ import annotations

import dataclasses
import enum

__all__ = [
    "GraphConfig",
    "InfluenceFunction",
    "KeyframeConfig",
    "ScaleEstimator",
    "SlamConfig",
    "TrackerConfig",
    "benchmark_config",
]


class InfluenceFunction(enum.Enum):
    """Robust influence functions (reference: weight_calculation.cpp:300-371)."""

    UNIT = "unit"
    TUKEY = "tukey"
    TDISTRIBUTION = "t_distribution"
    HUBER = "huber"


class ScaleEstimator(enum.Enum):
    """Residual scale estimators (reference: weight_calculation.cpp:48-237)."""

    UNIT = "unit"
    NORMAL = "normal"
    TDISTRIBUTION = "t_distribution"
    MAD = "mad"


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """Dense tracker configuration; defaults of DenseTracker::Config
    (reference: dvo_core/src/dense_tracking_config.cpp:27-42)."""

    first_level: int = 3
    last_level: int = 1
    max_iterations_per_level: int = 100
    precision: float = 5e-7
    use_initial_estimate: bool = False
    use_weighting: bool = True
    mu: float = 0.0
    influence_function: InfluenceFunction = InfluenceFunction.TDISTRIBUTION
    influence_function_param: float = 5.0  # t-distribution dof
    scale_estimator: ScaleEstimator = ScaleEstimator.TDISTRIBUTION
    scale_estimator_param: float = 5.0
    intensity_derivative_threshold: float = 0.0
    depth_derivative_threshold: float = 0.0
    # "auto", "pallas" (the CUDA kernel), "fused" (the plain twin) or "xla"
    # (the modular oracle path, not ported): see the module docstring
    kernel_backend: str = "auto"
    # the reference's 5 cm depth-buffer rule inside the bilinear sample
    # (interpolation.cpp:55-110): a foreground neighbour never blends into
    # a background sample, the weights renormalise over the others
    depth_buffered_sampling: bool = True

    @property
    def num_levels(self) -> int:
        """Reference: dense_tracking_config.cpp:44-47 (FirstLevel + 1)."""
        return self.first_level + 1

    @property
    def use_estimate_smoothing(self) -> bool:
        return self.mu > 1e-6

    @property
    def is_sane(self) -> bool:
        return self.first_level >= self.last_level


@dataclasses.dataclass(frozen=True)
class KeyframeConfig:
    """Keyframe selection policy (reference: dvo_slam/src/config.cpp:27-34)."""

    max_translational_distance: float = 0.2
    max_rotational_distance: float = float("inf")
    min_entropy_ratio: float = 0.91
    min_equation_system_constraint_ratio: float = 0.33


@dataclasses.dataclass(frozen=True)
class GraphConfig:
    """Pose-graph back end knobs (reference: dvo_slam/src/config.cpp:36-53)."""

    use_robust_kernel: bool = True
    # the back end on a worker thread fed by a queue of finished local maps
    # (reference: UseMultiThreading, config.cpp:38)
    use_multi_threading: bool = True
    new_constraint_search_radius: float = 1.0
    new_constraint_min_entropy_ratio_coarse: float = 0.7
    new_constraint_min_entropy_ratio_fine: float = 0.9
    min_equation_system_constraint_ratio: float = 0.2
    min_constraint_distance: int = 0
    optimization_use_dense_graph: bool = False
    optimization_iterations: int = 20
    optimization_remove_outliers: bool = False
    optimization_outlier_weight_threshold: float = 0.0
    final_optimization_use_dense_graph: bool = True
    final_optimization_iterations: int = 5000
    final_optimization_remove_outliers: bool = False
    final_optimization_outlier_weight_threshold: float = 0.0
    # stop the final schedule once a pruning round removes nothing (off: the
    # reference always runs all rounds)
    final_optimization_early_exit: bool = False
    # relative |delta chi2| at which a graph solve stops
    optimization_tol: float = 1e-7


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    """Bundle of all subsystem configs for the full SLAM engine."""

    tracker: TrackerConfig = TrackerConfig()
    keyframe: KeyframeConfig = KeyframeConfig()
    graph: GraphConfig = GraphConfig()


def benchmark_config() -> SlamConfig:
    """The TUM benchmark operating point: the parameters the reference's
    benchmark launch files deploy, which differ from the compiled defaults
    (reference: dvo_benchmark/launch/benchmark.yaml and
    benchmark_backend.yaml)."""
    return SlamConfig(
        tracker=TrackerConfig(
            first_level=3,
            last_level=1,
            max_iterations_per_level=50,
            precision=1e-4,
            use_initial_estimate=True,
            use_weighting=True,
            mu=0.05,
        ),
        keyframe=KeyframeConfig(
            max_translational_distance=0.2,
            min_entropy_ratio=0.6,
            min_equation_system_constraint_ratio=0.3,
        ),
        graph=GraphConfig(
            use_robust_kernel=True,
            new_constraint_search_radius=5.0,
            new_constraint_min_entropy_ratio_coarse=0.03,
            new_constraint_min_entropy_ratio_fine=0.6,
            min_equation_system_constraint_ratio=0.3,
            min_constraint_distance=0,
            optimization_use_dense_graph=False,
            optimization_iterations=50,
            optimization_remove_outliers=True,
            optimization_outlier_weight_threshold=0.1,
            final_optimization_use_dense_graph=True,
            final_optimization_iterations=1000,
            final_optimization_remove_outliers=True,
            final_optimization_outlier_weight_threshold=0.1,
        ),
    )
