"""Back-end scale probe: an fr3/office-class graph (about 2,000 frames,
300 keyframes) through the real threaded ``KeyframeGraph`` (port of the
reference's ``tools/backend_scale_probe.py``).

Run from the repository root (the card by default):

    python -m dvo_slam_tpu_torch.tools.backend_scale_probe [--keyframes 300]
        [--frames-per-map 7] [--shape 60x80] [--device cpu]

Feeds ``--keyframes`` keyframe events (local maps with real rendered
keyframe pyramids for the validator and stub intermediate frames,
``--frames-per-map`` frames per map: the e2e replay's shape) into the
threaded back end while walking a loop-closing circle, then runs the dense
final pass with its O(K^2) re-search.  The validation waves run on the
device (kernel 1b); the graph's solves are host-pinned float64, where the
port puts them.  Prints two JSON lines with the reference's keys: after
the feed the graph's size, feed and render seconds; after the final pass
its seconds, the edges, the Schur separator count of the last solve, the
optimized ATE, the back end's phase totals and the end-to-end back-end ms
per frame.  The port adds the device, the frame shape, the route each
keyframe-graph solve took (feed and final pass apart), the solves that
fell back, and on the card the peak device memory
(``torch.cuda.max_memory_allocated``) after the feed and after the final
pass: at 480x640 the validator's LRU of prepared keyframes shows there.
"""

from __future__ import annotations

import argparse
import json
import time
import warnings
from collections import Counter

import numpy as np
import torch

from .. import default_device
from ..config import GraphConfig, TrackerConfig
from ..models.frames import Frame
from ..models.keyframe_graph import KeyframeGraph
from ..models.local_map import LocalMap
from ..models.streaming import _ReplayEvaluation, _StubFrame
from ..ops import se3
from ..ops.camera import Intrinsics
from ..utils import synthetic, trajectory


def intrinsics_for(shape) -> Intrinsics:
    """The reference probe's camera (80, 80, 39.5, 29.5 at 60x80), at any
    frame size: the same field of view."""
    h, w = shape
    return Intrinsics(float(w), float(w), (w - 1) / 2.0, (h - 1) / 2.0)


def _peak(device):
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None


def main(n_keyframes: int = 300, frames_per_map: int = 7, shape=(60, 80), device=None):
    """Run the probe; prints and returns the two JSON records."""
    device = default_device(device)
    K = intrinsics_for(shape)
    tcfg = TrackerConfig(first_level=1, last_level=0, use_initial_estimate=True)
    gcfg = GraphConfig(
        new_constraint_search_radius=0.08,
        new_constraint_min_entropy_ratio_coarse=0.01,
        new_constraint_min_entropy_ratio_fine=0.1,
        optimization_iterations=16,
        final_optimization_iterations=60,
    )

    total_frames = n_keyframes * frames_per_map
    gt = synthetic.circular_trajectory(total_frames, radius=0.35, rot_amplitude=0.03)
    rng = np.random.default_rng(3)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    kg = KeyframeGraph(K, gcfg, tcfg, use_threading=True)
    routes = {"feed": Counter(), "final": Counter()}
    stage = ["feed"]
    optimize = kg.graph.optimize

    def recorded_optimize(*args, **kwargs):
        history = optimize(*args, **kwargs)
        routes[stage[0]][kg.graph.last_solver] += 1
        return history

    kg.graph.optimize = recorded_optimize  # the keyframe graph's solves, not the local maps'
    rel = lambda a, b: np.linalg.inv(gt[a]) @ gt[b]  # noqa: E731
    info = np.eye(6) * 5000.0

    def render(i):
        return synthetic.render_frame(gt[i], K, shape, seed=i, depth_noise=0.002,
                                      intensity_noise=1.0)

    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t_feed0 = time.perf_counter()
            render_s = 0.0
            for k in range(n_keyframes):
                base = k * frames_per_map
                t_r = time.perf_counter()
                i_, d_, v_ = render(base)
                render_s += time.perf_counter() - t_r
                kf_frame = Frame.from_arrays(i_, d_, v_, base / 30.0, tcfg.num_levels,
                                             device=device)
                # drifted pose estimate (odometry noise accumulates slowly)
                m = LocalMap.create(kf_frame, gt[base])
                for j in range(1, frames_per_map):
                    i_abs = base + j
                    m.add_frame(_StubFrame(i_abs / 30.0, i_abs))
                    # in float32, as the reference's probe computes it (JAX
                    # without x64 truncates its float64 request)
                    noise = torch.from_numpy(rng.normal(0, 2e-4, 6)).float()
                    T_noisy = rel(i_abs - 1, i_abs) @ se3.exp_se3(noise).numpy()
                    m.add_odometry_measurement(T_noisy, info)
                    m.add_keyframe_measurement(rel(base, i_abs), info)
                m.evaluation = _ReplayEvaluation(100.0)
                # the map's last frame seeds the next keyframe: render it
                last = base + frames_per_map - 1
                t_r = time.perf_counter()
                i2, d2, v2 = render(last)
                render_s += time.perf_counter() - t_r
                m.current_frame = Frame.from_arrays(i2, d2, v2, last / 30.0, tcfg.num_levels,
                                                    device=device)
                kg.add(m)
            kg.wait_for_queue()
            feed_s = time.perf_counter() - t_feed0 - render_s
            first = {
                "keyframes": len(kg.keyframes),
                "vertices": kg.graph.num_vertices,
                "edges_before_final": kg.graph.num_edges,
                "feed_s": feed_s,
                "render_s": render_s,
                "incremental_ms_per_frame": feed_s / total_frames * 1e3,
                "device": str(device), "shape": list(shape),
                "routes": dict(routes["feed"]),
                "peak_device_bytes": _peak(device),
            }
            print(json.dumps(first), flush=True)

            stage[0] = "final"
            t0 = time.perf_counter()
            kg.final_optimization()
            final_s = time.perf_counter() - t0
        stamps, est = kg.trajectory()
        ate = trajectory.ate_rmse(stamps, est, np.arange(total_frames) / 30.0, gt)
        second = {
            "final_pass_s": final_s,
            "final_ms_per_frame": final_s / total_frames * 1e3,
            "edges_after_final": kg.graph.num_edges,
            "separators_last_solve": kg.graph._real_sep_count,
            "ate_m": float(ate),
            "phase_totals_s": {name: s["total_s"] for name, s in kg.timers.summary().items()},
            "total_wall_s": feed_s + final_s,
            "e2e_backend_ms_per_frame": (feed_s + final_s) / total_frames * 1e3,
            "routes": dict(routes["final"]),
            "fallbacks": [str(w.message) for w in caught if "falling back" in str(w.message)],
            "peak_device_bytes": _peak(device),
        }
        print(json.dumps(second), flush=True)
    finally:
        kg.shutdown()
    return first, second


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--keyframes", type=int, default=300)
    ap.add_argument("--frames-per-map", type=int, default=7)
    ap.add_argument("--shape", default="60x80", help="keyframe size HxW (default 60x80)")
    ap.add_argument("--device", default=None,
                    help="device of the frames and waves (default: the card; 'cpu')")
    args = ap.parse_args()
    main(args.keyframes, args.frames_per_map,
         tuple(int(x) for x in args.shape.split("x")), args.device)
