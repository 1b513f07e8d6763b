"""The program's configuration objects built from a configuration file's
groups, field by field (enums by their values), and its counters, read
as the entry adapters need them.  Imports the program only when called."""

from __future__ import annotations

import dataclasses


def _fill(cls, values: dict, enums: dict):
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = set(values) - fields
    if unknown:
        raise KeyError(f"{cls.__name__} has no fields {sorted(unknown)}")
    return cls(**{k: enums[k](v) if k in enums else v for k, v in values.items()})


def tracker_config(config: dict):
    from dvo_slam_tpu_torch.config import InfluenceFunction, ScaleEstimator, TrackerConfig

    return _fill(TrackerConfig, config["tracker"], {"influence_function": InfluenceFunction,
                                                    "scale_estimator": ScaleEstimator})


def slam_config(config: dict):
    from dvo_slam_tpu_torch.config import GraphConfig, KeyframeConfig, SlamConfig

    return SlamConfig(tracker=tracker_config(config),
                      keyframe=_fill(KeyframeConfig, config["keyframe"], {}),
                      graph=_fill(GraphConfig, config["graph"], {}))


def intrinsics(config: dict):
    from dvo_slam_tpu_torch.ops.camera import Intrinsics

    k = config["intrinsics"]
    return Intrinsics(float(k["fx"]), float(k["fy"]), float(k["ox"]), float(k["oy"]))


# kernel 1 (one stream) and 1b (B streams): the program's launch counters
# and the names its two launches have in a device trace
KERNEL_NAMES = ("gram_kernel", "loglik_kernel")


def kernel_launches() -> dict:
    """The program's folded launch counts of kernels 1 and 1b (a host read:
    the while graphs' counts are brought up to date first)."""
    from dvo_slam_tpu_torch.models import irls_graph
    from dvo_slam_tpu_torch.ops import fused_kernels

    irls_graph.fold_counts()
    return {"kernel1": fused_kernels.warp_fused_stats_cuda.launches,
            "kernel1b": fused_kernels.warp_fused_stats_batched_cuda.launches}


def graph_stats() -> dict:
    from dvo_slam_tpu_torch.models import irls_graph

    return irls_graph.stats()


def release_graphs():
    from dvo_slam_tpu_torch.models import irls_graph

    irls_graph.release()
