"""How should the per-iteration quad-table gather be laid out when B camera
streams advance in lockstep?  Times the full bilinear quad sample (gather,
bilinear combine, validity) of each layout on the card (port of the
reference's ``tools/gather_probe.py``).

Run on a machine with a CUDA card, from the repository root:

    python -m dvo_slam_tpu_torch.tools.gather_probe [--streams 8] [--iters 32]

At the L1 shape of a 640x480 stream (320x240, N = 76,800 pixels) and B
streams, each variant samples every stream's table at smooth warp-like
coordinates that move by a quarter pixel per iteration:

  single    one stream: one [32, N] table, [N] coordinates
  flat      one [32, B*N] table, the B streams' columns side by side, and
            per-stream index offsets
  batched   one [B, 32, N] table stack with a per-item index: one
            ``torch.gather`` for all streams (the lockstep tracker's form)
  tuple     B separate [32, N] allocations, one sample each
  pcopy     as ``tuple``, each table copied out of the stack by the
            ``table_copy`` kernel (the reference's ``pallas_copy``)
  rowmajor  [B*N, 32] rows with offsets: one 128-byte row per pixel, where
            the column-major forms make 32 loads of 4 bytes 4N bytes apart

Every variant returns the same sampled values (checked, bit for bit).  The
stacked table is 78.6 MB at B = 8, above the card's 50 MB L2 cache; one
stream's 9.8 MB fits.  Times are CUDA events around ``--iters``
iterations, after a warm-up, the best of ``--reps`` runs; the device time
per iteration is the kernels' summed time under ``torch.profiler`` (null
where the profiler recorded no device event).  Prints
one JSON object per line: the device, then one line per variant.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Dict, NamedTuple

import numpy as np
import torch

from .. import default_device
from ..ops.interp import combine_quad, quad_index, sample_quad
from ..ops.table_copy import table_copy

VARIANTS = ("single", "flat", "batched", "tuple", "pcopy", "rowmajor")


class ProbeInputs(NamedTuple):
    table: torch.Tensor  # [B, 32, N] float32, the stacked quad tables
    u: torch.Tensor  # [B, N] float32 column coordinates
    v: torch.Tensor  # [B, N] float32 row coordinates
    shape: tuple  # (H, W)


def make_inputs(streams: int, height: int, width: int, seed: int = 0, device=None) -> ProbeInputs:
    """Random tables and a per-stream sub-pixel shift of the pixel grid,
    from ``seed`` (the reference probe's inputs), on the card unless
    ``device`` names another (``default_device``)."""
    device = default_device(device)
    rng = np.random.default_rng(seed)
    n = height * width
    u0 = np.tile(np.arange(width, dtype=np.float32), height)
    v0 = np.repeat(np.arange(height, dtype=np.float32), width)
    u = np.stack([u0 + np.float32(rng.uniform(0, 2)) for _ in range(streams)])
    v = np.stack([v0 + np.float32(rng.uniform(0, 2)) for _ in range(streams)])
    table = rng.normal(size=(streams, 32, n)).astype(np.float32)
    put = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return ProbeInputs(put(table), put(u), put(v), (height, width))


def prepare(variant: str, inputs: ProbeInputs):
    """The variant's tables, built once, outside the timed iterations."""
    table = inputs.table
    streams, channels, n = table.shape
    if variant == "single":
        return table[0]
    if variant == "flat":
        return table.transpose(0, 1).reshape(channels, streams * n).contiguous()
    if variant == "batched":
        return table
    if variant == "tuple":
        return [table[b].clone() for b in range(streams)]
    if variant == "pcopy":
        return [table_copy(table[b]) for b in range(streams)]
    if variant == "rowmajor":
        return table.transpose(1, 2).reshape(streams * n, channels).contiguous()
    raise ValueError(f"unknown variant {variant!r}")


def sample(variant: str, tables, inputs: ProbeInputs, iteration: int):
    """One iteration's full bilinear sample -> (values [B, 8, N], valid
    [B, N]); ``single`` samples stream 0 only, [1, 8, N]."""
    u = inputs.u + (iteration % 4) * 0.25
    v = inputs.v
    shape = inputs.shape
    if variant == "single":
        values, valid = sample_quad(tables, shape, u[0], v[0])
        return values[None], valid[None]
    if variant == "batched":
        return sample_quad(tables, shape, u, v)
    if variant in ("tuple", "pcopy"):
        pairs = [sample_quad(t, shape, u[b], v[b]) for b, t in enumerate(tables)]
        return torch.stack([p[0] for p in pairs]), torch.stack([p[1] for p in pairs])
    streams, n = u.shape
    q = quad_index(shape, u, v)
    offsets = torch.arange(streams, device=u.device)[:, None] * n
    flat_idx = (q.idx + offsets).reshape(-1)
    if variant == "flat":
        cols = tables[:, flat_idx].reshape(-1, streams, n).transpose(0, 1)  # [B, 32, N]
    elif variant == "rowmajor":
        cols = tables[flat_idx].reshape(streams, n, -1).transpose(1, 2)  # [B, 32, N]
    else:
        raise ValueError(f"unknown variant {variant!r}")
    return combine_quad(cols, q)


def check_variants(inputs: ProbeInputs, variants=VARIANTS, iteration: int = 1) -> Dict[str, int]:
    """Every variant's sample against ``batched``'s at one iteration;
    raises unless values and validity are bit-equal.  Returns the number of
    values compared per variant."""
    want_values, want_valid = sample("batched", prepare("batched", inputs), inputs, iteration)
    compared = {}
    for variant in variants:
        values, valid = sample(variant, prepare(variant, inputs), inputs, iteration)
        ref_values, ref_valid = want_values[: values.shape[0]], want_valid[: valid.shape[0]]
        if not (torch.equal(values, ref_values) and torch.equal(valid, ref_valid)):
            raise RuntimeError(f"gather probe: variant {variant!r} samples other values than 'batched'")
        compared[variant] = values.numel()
    return compared


def time_variant(variant: str, tables, inputs: ProbeInputs, iters: int = 32, reps: int = 3,
                 warmup: int = 4) -> float:
    """ms per iteration of one variant (its ``prepare``d tables) on the
    card: CUDA events around ``iters`` iterations, the best of ``reps``
    runs."""
    for i in range(warmup):
        sample(variant, tables, inputs, i)
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            sample(variant, tables, inputs, i)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def device_ms_per_call(events, calls: int):
    """Summed duration in ms of the profiler ``events`` that ran on the
    card, per call; None (not measured) when the profiler recorded no
    device event, as happens when its CUPTI tracing is unavailable."""
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    if not device:
        return None
    return sum(e.time_range.elapsed_us() for e in device) / 1000.0 / calls


def device_time(fn, calls: int = 16, attempts: int = 2):
    """(device ms, wall ms) per call of ``fn`` under ``torch.profiler``,
    over ``calls`` calls after one untimed call.  Device time is the summed
    time of the kernels and copies the calls put on the card, or None when
    ``attempts`` profiler sessions in turn recorded none; wall time ends
    with a synchronise."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        device_ms = device_ms_per_call(prof.events(), calls)
        if device_ms is not None:
            break
    return device_ms, 1000.0 * wall_s / calls


def probe(streams: int = 8, height: int = 240, width: int = 320, iters: int = 32,
          reps: int = 3, variants=VARIANTS):
    """Check every variant against ``batched``, then time each on the card
    -> one dict per variant."""
    inputs = make_inputs(streams, height, width)
    check_variants(inputs, variants)
    n = height * width
    rows = []
    for variant in variants:
        table_mb = (1 if variant == "single" else streams) * 32 * n * 4 / 1e6
        tables = prepare(variant, inputs)
        rows.append({
            "variant": variant, "streams": 1 if variant == "single" else streams,
            "pixels_per_stream": n, "table_mb": table_mb,
            "ms_per_iter": time_variant(variant, tables, inputs, iters, reps),
            "device_ms_per_iter": device_time(
                lambda: sample(variant, tables, inputs, 1)  # noqa: B023
            )[0],
            "equal_to_batched": True,
        })
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--iters", type=int, default=32)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--variant", default="all", choices=("all",) + VARIANTS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("gather_probe: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}), flush=True)
    variants = VARIANTS if args.variant == "all" else (args.variant,)
    for row in probe(args.streams, args.height, args.width, args.iters, args.reps, variants):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
