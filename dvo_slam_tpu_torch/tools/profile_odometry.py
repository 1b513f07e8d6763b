"""Where the port's odometry time goes on the card.

Run on a machine with a CUDA card, from the repository root:

    python -m dvo_slam_tpu_torch.tools.profile_odometry [--frames 20] [--trace PATH]
        [--forms while,polled,polled,while]

Prints one JSON object per line:

* ``device``: the card's name and ``nvidia-smi``'s name and power limit;
* ``profile``, one per form in ``--forms`` (the IRLS levels as while
  graphs, or as host-polled graph replays; ``eager`` runs the loop without
  graphs): the frame-to-frame tracker at 640x480
  (``benchmark_config().tracker``) on ``chip_smoke.py`` phase 4's first
  frames after a warm-up, once unprofiled and once under ``torch.profiler``:
  wall time of both, solver iterations, device kernels, host read-backs
  and ``done`` reads per iteration, the device's busy time per iteration
  and its share of the profiled and of the unprofiled wall (the profiler
  slows the host), and the kernels that take the device time; then the
  kernels by name recorded more often in one form than in the other, and
  the node types of the captured chunks of each level (``graph_nodes``);
* ``accuracy``: at levels 3, 2, 1 the fused-stats kernel and its plain
  twin, each against the exact (float64) Gram of the same float32 rows,
  as the largest error relative to each block's largest entry.

``--trace`` also writes the Chrome trace of the profiled window (some
MB per frame: every tracker iteration launches hundreds of kernels).
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import time

import torch

from .. import benchmark_config
from ..odometry import build_frame, render_sequence, track_sequence, upload_sequence
from ..models import dense_tracker, irls_graph
from ..ops import fused_kernels
from ..ops.camera import TUM_FR1
from ..utils import synthetic
from . import fused_check, graph_check

SHAPE = (480, 640)
FUSED_KERNELS = ("gram_kernel", "loglik_kernel")  # csrc/fused_stats.cu's two launches


def _device_report():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    return {"kind": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda}


def _profile(cfg, d_i, d_d, trace_path, form):
    from torch.profiler import ProfilerActivity, profile

    with graph_check.loop_mode(form != "eager", polled=form == "polled"):
        track_sequence(cfg, TUM_FR1, d_i[:3], d_d[:3])  # warm-up: this form's captures
        _, _, unprofiled = track_sequence(cfg, TUM_FR1, d_i, d_d)
        reads = dense_tracker.read_done.calls
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, iterations, _ = track_sequence(cfg, TUM_FR1, d_i, d_d)
            wall = time.perf_counter() - t0
        reads = dense_tracker.read_done.calls - reads
    if trace_path:
        prof.export_chrome_trace(trace_path)
    events = prof.events()
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e for e in device if not e.name.startswith("Memcpy") and not e.name.startswith("Memset")]
    per_name = collections.defaultdict(lambda: [0, 0.0])
    for e in kernels:
        short = (e.name.rsplit("(", 1)[0] if e.name.endswith(")") else e.name)[-60:]
        per_name[short][0] += 1
        per_name[short][1] += e.time_range.elapsed_us() / 1000.0
    busy_ms = sum(e.time_range.elapsed_us() for e in device) / 1000.0
    readbacks = sum(1 for e in events if e.name == "aten::_local_scalar_dense")
    fused = {
        k: {"calls": c, "device_ms_per_call": ms / max(c, 1)}
        for name, (c, ms) in per_name.items()
        for k in FUSED_KERNELS if k in name
    }
    top = sorted(per_name.items(), key=lambda kv: -kv[1][1])[:15]
    return {
        "form": form, "frames": d_i.shape[0], "wall_s": wall, "solver_iterations": iterations,
        "done_reads_per_iteration": reads / iterations,
        "ms_per_iteration": 1000.0 * wall / iterations,
        "unprofiled_ms_per_iteration": 1000.0 * unprofiled / iterations,
        "device_ms_per_iteration": busy_ms / iterations,
        "device_busy_share_unprofiled": busy_ms / (1000.0 * unprofiled) if unprofiled > 0 else None,
        "device_kernels": len(kernels),
        "kernels_per_iteration": len(kernels) / iterations,
        "host_readbacks_per_iteration": readbacks / iterations,
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / (1000.0 * wall) if wall > 0 else None,
        "fused_stats_kernels": fused,
        "top_kernels_ms": [[name, c, ms] for name, (c, ms) in top],
        "kernel_counts": {name: c for name, (c, _) in per_name.items()},
    }


def _accuracy(cfg):
    poses = synthetic.circular_trajectory(100, radius=0.05, rot_amplitude=0.02)[:2]
    d_i, d_d = upload_sequence(*render_sequence(poses, SHAPE, TUM_FR1), "cuda")
    pair = [build_frame(cfg, d_i[k], d_d[k]) for k in (0, 1)]
    p3 = torch.tensor(fused_check.CHECK_PRECISION, device="cuda")
    dof = cfg.influence_function_param
    rows = []
    for level, (sampled, refpack, k) in fused_check.level_inputs(
        cfg, TUM_FR1, pair[0], pair[1]
    ).items():
        for first in (0, 1):
            flag = torch.tensor(first, dtype=torch.int32, device="cuda")
            args = (sampled, refpack, p3, flag, k, dof)
            r_i, r_z, w, maskf, j_i, j_z = fused_kernels._pixel_math(
                refpack, sampled, p3, flag, k.fx, k.fy, dof
            )
            U = fused_kernels._gram_rows(r_i, r_z, w, maskf, j_i, j_z).double()
            exact = fused_kernels._unpack_gram(U @ U.T)
            row = {"level": level, "first_iter": first}
            for label, stats in (
                ("kernel", fused_kernels.fused_stats_cuda(*args)),
                ("twin", fused_kernels.fused_stats_plain(*args)),
            ):
                row[label] = {
                    name: float((got.double() - want).abs().max() / want.abs().max())
                    for name, got, want in zip(fused_check.GRAM_FIELDS, stats, exact)
                }
            rows.append(row)
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--trace", default="", help="Chrome trace of the first form's window")
    ap.add_argument("--forms", default="while,polled,polled,while")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_odometry: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = benchmark_config().tracker
    print(json.dumps({"device": _device_report()}), flush=True)
    print(json.dumps({"accuracy": _accuracy(cfg)}), flush=True)
    poses = synthetic.circular_trajectory(100, radius=0.05, rot_amplitude=0.02)[:args.frames]
    d_i, d_d = upload_sequence(*render_sequence(poses, SHAPE, TUM_FR1), "cuda")
    counts = {}
    for k, form in enumerate(args.forms.split(",")):
        trace = args.trace if k == 0 else ""
        row = _profile(cfg, d_i, d_d, trace, form)
        counts.setdefault(form, row.pop("kernel_counts"))
        print(json.dumps({"profile": row}), flush=True)
    if "while" in counts and "polled" in counts:
        # kernels by name that the profiler recorded more or fewer times in
        # one form than in the other (the same steps run in both)
        names = set(counts["while"]) | set(counts["polled"])
        diff = sorted(((counts["while"].get(n, 0) - counts["polled"].get(n, 0), n) for n in names),
                      key=lambda d: -abs(d[0]))
        print(json.dumps({"kernel_count_while_minus_polled": [[n, d] for d, n in diff[:20] if d]}),
              flush=True)
    print(json.dumps({"graph_nodes": graph_nodes()}), flush=True)


def graph_nodes() -> list:
    """Per key of the IRLS graph cache (its level shape and stream count):
    the node types of the captured head and tail chunks, which the while
    graph runs as child graphs (the tail in its WHILE body)."""
    out = []
    for key, graphs in list(irls_graph._cache.items()):
        if graphs.head is not None and key[1] != "cg" and not irls_graph.has_group(key):
            out.append({"backend": key[1], "level_shape": list(key[2]),
                        "streams": list(graphs.inputs[-4].shape[:-1]), **graphs.census()})
    return out


if __name__ == "__main__":
    main()
