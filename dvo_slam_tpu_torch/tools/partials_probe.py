"""Where launch 1 of the fused kernels (``gram_kernel`` of
``csrc/fused_stats.cu``) spends its time on the card, phase by phase.

Run on a machine with a CUDA card, from the repository root:

    python -m dvo_slam_tpu_torch.tools.partials_probe [--reps 20]

Builds and loads its own diagnostic variant of the library
(``-DDVO_STAMPS``; the package's wrappers never see it), in which thread 0
of every block writes the device's nanosecond timer at six points: start,
rows staged (loads, warp, sample and the per-pixel chain done), Gram done
(the tensor-core products), cluster summed, ticket taken, last block done.
On level 1 of a rendered 640x480 pair (320x240, N = 76,800 pixels) it runs
launch 1 of the pixel-sharded evaluation (``dvo_warp_fused_partials``) on
block 0 of 1, 2 and 4 ranks (N, N/2, N/4 pixels), and prints one JSON
object per line: the device, then per run the time in microseconds,
from the first block's start, at which the LAST block passed each point
(median over ``--reps`` launches), the spread of the blocks' starts, the
kernel's whole span, and the time between CUDA events around the launch
with the card spinning first (so that the difference of the two is what a
launch and its events cost).  The stamps cost a few stores per block; the
event times here are the diagnostic build's.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import numpy as np
import torch

from .. import _build, benchmark_config
from ..odometry import build_frame, render_sequence, upload_sequence
from ..ops import fused_kernels
from ..ops.camera import TUM_FR1
from ..utils import synthetic
from . import fused_check

SHAPE = (480, 640)
POINTS = ("start", "rows_staged", "gram_done", "cluster_summed", "ticket_taken", "last_block_done")
SPIN_CYCLES = 20_000_000  # about 10 ms: longer than the host takes to enqueue the call


def _event_us(fn, reps):
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(1000.0 * start.elapsed_time(end))
    return float(np.median(times))


def _launcher(lib, block, inputs, P, dof):
    """A call of the diagnostic build's ``dvo_warp_fused_partials`` on
    ``block``, as ``fused_kernels.warp_fused_partials_cuda`` makes it."""
    n_local = block.shape[1]
    height, width = inputs.shape
    k = inputs.intrinsics
    device = block.device
    workspace = torch.empty(lib.dvo_fused_stats_workspace_bytes(n_local, 1, 3),
                            dtype=torch.uint8, device=device)
    tickets = torch.zeros(1, dtype=torch.int32, device=device)
    buf = torch.empty(fused_kernels.SHARDED_STRIDE, dtype=torch.float32, device=device)
    scalars = (k.fx, k.fy, k.ox, k.oy, k.fx / 255.0, k.fy / 255.0, dof, dof + 2.0)

    def launch():
        err = lib.dvo_warp_fused_partials(
            block.data_ptr(), inputs.quad.data_ptr(), inputs.T.data_ptr(), P.data_ptr(),
            n_local, height * width, height, width, 0, *scalars,
            workspace.data_ptr(), tickets.data_ptr(), buf.data_ptr(),
            _build.current_stream(device))
        if err != 0:
            raise RuntimeError(f"partials_probe: kernel launch failed, CUDA error {err}")

    return launch


def probe(reps: int):
    """The rows of the report."""
    lib = fused_kernels.declare_signatures(_build.load_library("fused_stats+DVO_STAMPS").lib)
    lib.dvo_set_stamps.argtypes = [ctypes.c_void_p]
    width = lib.dvo_stamps_per_block()
    cfg = benchmark_config().tracker
    poses = synthetic.circular_trajectory(100, radius=0.05, rot_amplitude=0.02)
    d_i, d_d = upload_sequence(*render_sequence(poses[:2], SHAPE, TUM_FR1), "cuda")
    frames = [build_frame(cfg, d_i[k], d_d[k]) for k in (0, 1)]
    inputs = fused_check.warp_level_inputs(cfg, TUM_FR1, frames[0], frames[1])[cfg.last_level]
    P = torch.tensor([[4000.0, 10.0], [10.0, 1.5e5]], device="cuda")
    dof = cfg.influence_function_param
    rows = []
    for ranks in (1, 2, 4):
        block = fused_check.shard_blocks(inputs.refpack, ranks)[0]
        n_local = block.shape[1]
        # one row of stamps per block of the grid (256 pixels a block,
        # rounded up to whole clusters of 8)
        stamps = torch.zeros((-(-n_local // 256) + 8, width), dtype=torch.int64, device="cuda")
        launch = _launcher(lib, block, inputs, P, dof)
        for _ in range(5):
            launch()
        lib.dvo_set_stamps(stamps.data_ptr())
        marks = []
        for _ in range(reps):
            stamps.zero_()
            torch.cuda._sleep(SPIN_CYCLES // 10)
            launch()
            torch.cuda.synchronize()
            t = stamps.cpu().numpy().astype(np.float64)
            started = t[:, 0] > 0
            t0 = t[started, 0].min()
            last = [np.where(t[:, k] > 0, t[:, k], t0).max() - t0 for k in range(len(POINTS))]
            marks.append(last)
        lib.dvo_set_stamps(None)
        median = np.median(np.asarray(marks), axis=0) / 1000.0
        rows.append({
            "pixels": n_local, "blocks": int(started.sum()),
            "start_spread_us": float(median[0]),
            **{point + "_us": float(us) for point, us in zip(POINTS[1:], median[1:])},
            "events_us": _event_us(launch, reps),
        })
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("partials_probe: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}), flush=True)
    for row in probe(args.reps):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
