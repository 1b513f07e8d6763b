"""The ingest kernels at B = 1 and at a rig's B: wrapper and device time of
one ingest of 640x480 raw frames on the card, against the plain chain.

Run on a machine with a CUDA card, from the repository root:

    python -m dvo_slam_tpu_torch.tools.ingest_bench [--streams 1,8] [--reps 30]

For each B: ``wrapper_ms``, CUDA events around one ``frames.ingest_raw``
call from host arrays (the upload and the two launches as the
host queues them); ``device_ms``, the same events around the two launches
alone (``ops/ingest.ingest_cuda`` on raw frames already on the card) with
the card spinning first, so that they bracket the kernels and not the
host; ``stage_host_ms``, the host clock around the route's upload of the
raw frames (``frames._stage``: a copy into its plane for each camera's
frame of each channel);
``plain_ms``, the plain chain's wrapper time (``convert_raw_depth`` ->
``build_pyramid`` -> ``prepare_frame`` on the stacked frames on the card);
``bound_ms``, each raw byte read once and each output byte written once at
3.35 TB/s.  Medians of ``--reps`` after 5 warm-ups.  The tracker's settings
are ``benchmark_config().tracker`` (levels 3..1, the fused path); the rig
form stores levels from the solve range's last, as ``LockstepTracker`` does,
and one frame stores all of them, as ``Frame.from_raw`` does.  Prints one
JSON object per line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from .. import benchmark_config
from ..models import frames
from ..models.dense_tracker import prepare_frame
from ..ops import ingest
from ..ops.camera import TUM_FR1
from ..ops.pyramid import build_pyramid, convert_raw_depth

SHAPE = (480, 640)
SPIN_CYCLES = 20_000_000  # about 10 ms of spinning
PEAK_BYTES_PER_S = 3.35e12


def _events_ms(fn, reps: int, spin: bool) -> float:
    for _ in range(5):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _bound_bytes(layout: ingest.ArenaLayout, streams: int) -> int:
    h, w = layout.shape
    outputs = sum(v.nbytes for v in layout.views.values())
    return streams * 3 * h * w + outputs


def measure(streams: int, reps: int) -> dict:
    cfg = benchmark_config().tracker
    dev = torch.device("cuda")
    rng = np.random.default_rng(streams)
    iu = [rng.integers(0, 256, SHAPE, dtype=np.uint8) for _ in range(streams)]
    du = [rng.integers(2000, 12000, SHAPE).astype(np.uint16) for _ in range(streams)]
    rig = streams > 1
    batch, skip = (streams, cfg.last_level) if rig else (None, 0)
    prepare_for = (cfg, TUM_FR1)

    def wrapper():
        if rig:
            frames.ingest_raw(iu, du, cfg.num_levels, prepare_for, dev, streams, skip)
        else:
            frames.ingest_raw(iu[0], du[0], cfg.num_levels, prepare_for, dev)

    layout = ingest.arena_layout(SHAPE, cfg.num_levels, (cfg.last_level, cfg.first_level), True,
                                 batch, skip)
    pack = ingest.pack_args(layout, TUM_FR1, cfg.intensity_derivative_threshold,
                            cfg.depth_derivative_threshold)
    raw_i = torch.from_numpy(np.stack(iu) if rig else iu[0]).to(dev)
    raw_d = torch.from_numpy(np.stack(du) if rig else du[0]).to(dev)
    ref, cur = ingest.new_arenas(layout, dev)

    def kernels():
        ingest.ingest_cuda(raw_i, raw_d, layout, ref, cur, pack)

    def plain():
        depth, valid = convert_raw_depth(torch.from_numpy(np.stack(du)).to(dev))
        levels = build_pyramid(torch.from_numpy(np.stack(iu)).to(dev).to(torch.float32), depth,
                               valid, cfg.num_levels, skip_below=skip)
        prepare_frame(cfg, TUM_FR1, levels)

    def route_stage():
        frames._stage((iu, du) if rig else (iu[0], du[0]), dev, batch)

    def host_ms(fn):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
        return float(np.median(times))

    return {"streams": streams, "wrapper_ms": _events_ms(wrapper, reps, False),
            "device_ms": _events_ms(kernels, reps, True),
            "stage_host_ms": host_ms(route_stage),
            "plain_ms": _events_ms(plain, reps, False),
            "bound_ms": _bound_bytes(layout, streams) / PEAK_BYTES_PER_S * 1e3}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", default="1,8")
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "card": card}), flush=True)
    for b in (int(s) for s in args.streams.split(",")):
        print(json.dumps(measure(b, args.reps)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
