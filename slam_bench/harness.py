"""The run of one cell: set-up, the measured window, the traced slice, the
check of the answers against the plain reference, and the result line.

    python3 -m slam_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, entry or metric
is in its own file (``manifest``); this module is the same for all.

The window hands the recording's frames to the entry (``ingest``, then
``update``, whose pose comes back to the host) as the traffic mix says:
back to back (closed arrivals) or each at its due time (open arrivals).
A frame is attempted when it is handed over, and failed when it raises or
its pose is not finite.  With ``--trace 1`` the spans around ``ingest``
are synchronised with the card, and a slice of ``trace_frames`` frames,
starting a quarter into the window, runs under the profiler; the span
metrics read the frames outside it.

Set-up is everything from the process's start to the window's first
frame; its parts go to standard error before the result, and so does how
late an open-loop generator ran.  After the window: no module of JAX or of
the JAX package may be loaded, the entry finishes outside the timing, the
peak memory is read, the program's state is freed, and the entry's check
compares its answers with the plain reference (``reference/``) in blocks;
each number compared goes to the last lines of standard error and into the
result line beside its limit.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from . import manifest, traffic as traffic_mod

FORBIDDEN = ("jax", "jaxlib", "flax", "dvo_slam_tpu")
PROGRAM = "dvo_slam_tpu_torch"
TRACE_START = 0.25  # the traced slice starts this share into the window


@dataclass
class FrameRecord:
    k: int  # index in the window
    index: int  # frame of the recording
    pass_no: int  # pass over the recording (closed arrivals)
    due: float  # seconds after the window opened
    start: float  # handed over
    ingested: float  # ingest returned
    end: float  # pose on the host
    pose: Optional[np.ndarray]  # None: failed
    info: dict = field(default_factory=dict)  # what the entry reports of the frame
    traced: bool = False


@dataclass
class Run:
    """What the metric readers read (``metrics/<name>.py``: ``read(run)``,
    None where nothing was found)."""

    workload: str
    config: dict
    traffic: dict
    seconds: float
    setup_s: float
    window_s: float = 0.0
    frames: List[FrameRecord] = field(default_factory=list)
    trace: object = None  # trace.Trace of the slice, with --trace 1
    counters: dict = field(default_factory=dict)  # the program's counts over the slice
    timers: dict = field(default_factory=dict)  # the entry's phase timers over the window

    def untraced(self) -> List[FrameRecord]:
        return [f for f in self.frames if not f.traced and f.pose is not None]


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _fail(message: str, code: int = 2):
    print(f"slam_bench: {message}", file=sys.stderr, flush=True)
    sys.exit(code)


def _card() -> str:
    """The card's name, power limit, SM clock (and its maximum), power draw
    and temperature as ``nvidia-smi`` reads them now."""
    query = "name,power.limit,clocks.sm,clocks.max.sm,power.draw,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _cache_dirs():
    """The build and kernel caches of the program and of PyTorch at fixed
    paths inside the checkout (the program's own kernels build into
    ``dvo_slam_tpu_torch/build/``)."""
    base = os.path.join(manifest.ROOT, ".bench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = os.path.join(base, sub)


def _window(entry, rec, traffic: dict, seconds: float, tracing: bool, sync, tr, run: Run):
    """Drive the window; fills ``run.frames``, ``run.window_s`` and, with
    ``tracing``, ``run.trace`` and ``run.counters``."""
    import torch

    closed = traffic["arrivals"] == "closed"
    n_rec = len(rec.intensity)
    due = traffic_mod.due_times(traffic, n_rec)
    trace_frames = int(traffic.get("trace_frames", 0)) if tracing else 0
    traced, traced_left = False, 0
    entry.start_pass()
    t0 = time.perf_counter()
    k, index, pass_no = 0, 0, 0
    while True:
        now = time.perf_counter() - t0
        if closed:
            if now >= seconds:
                break
            if index == n_rec:
                index, pass_no = 0, pass_no + 1
                entry.start_pass()
        else:
            if k >= n_rec or due[k] >= seconds:
                break
            index = k
        if trace_frames and not traced and now >= TRACE_START * seconds:
            # the counters' read and the profiler's start stay out of the window
            paused = time.perf_counter()
            run.counters["before"] = entry.counters()
            traced, traced_left = True, trace_frames
            prof = tr.profiler()
            prof.start()
            run.counters["profiler_start_s"] = time.perf_counter() - paused
            t0 += time.perf_counter() - paused
            slice_span = torch.profiler.record_function(tr.SLICE)
            slice_span.__enter__()
        if not closed:
            wait = due[k] - (time.perf_counter() - t0)
            if wait > 0:
                with torch.profiler.record_function("slam_bench.wait"):
                    time.sleep(wait)
        start = time.perf_counter() - t0
        pose, info = None, {}
        try:
            with torch.profiler.record_function("slam_bench.ingest"):
                sync()
                frame = entry.ingest(rec.intensity[index], rec.depth[index], float(rec.stamps[index]))
                sync()
            ingested = time.perf_counter() - t0
            with torch.profiler.record_function("slam_bench.update"):
                out = entry.update(frame)
            end = time.perf_counter() - t0
            if np.all(np.isfinite(out)):
                pose = np.array(out, dtype=np.float64)
            info = entry.info()
        except Exception as exc:  # a frame that raises is a failed frame; the run goes on
            print(f"slam_bench: frame {k} (recording {index}) raised {exc!r}", file=sys.stderr)
            ingested = end = time.perf_counter() - t0
        run.frames.append(FrameRecord(k, index, pass_no, float(due[k] if not closed else start),
                                      start, ingested, end, pose, info, traced_left > 0))
        k += 1
        index += 1
        if traced_left:
            traced_left -= 1
            if traced_left == 0:
                # the profiler's stop and the counters' read stay out of the window
                paused = time.perf_counter()
                slice_span.__exit__(None, None, None)
                prof.stop()
                run.counters["after"] = entry.counters()
                run.counters["profiler_stop_s"] = time.perf_counter() - paused
                t0 += time.perf_counter() - paused
    run.window_s = max((f.end for f in run.frames), default=0.0)
    if traced_left:  # the window closed inside the slice
        paused = time.perf_counter()
        slice_span.__exit__(None, None, None)
        prof.stop()
        run.counters["after"] = entry.counters()
        run.counters["profiler_stop_s"] = time.perf_counter() - paused
    if traced:
        run.trace = tr.read(prof)


def main(process_start: float, argv=None) -> int:
    """``process_start``: the process's start, wall-clock seconds."""
    startup_s = time.time() - process_start  # the interpreter, PyTorch's import
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = manifest.cell(args.workload)
    chips = int(cell.workload["chips"])
    _cache_dirs()
    os.environ.setdefault("USE_FLAX", "0")
    import torch

    torch.set_num_threads(1)
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if visible < chips:
        _fail(f"the cell needs {chips} CUDA card(s); {visible} visible")
    result, checks = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), process_start,
                              {"startup_s": startup_s})
    for c in checks:
        print(f"slam_bench: check {c['name']} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"slam_bench: check failed_frames = {result['failed']} (limit 0)", file=sys.stderr,
          flush=True)
    print(json.dumps(result), flush=True)
    return 0


def run_cell(cell: manifest.Cell, seed: int, seconds: float, tracing: bool, device,
             process_start: float, split: Optional[dict] = None):
    """Set-up, window, metrics and check of ``cell`` on ``device`` (the
    card; the CPU in the tests, which drive a run without the chip).
    Returns (the result object, the checks)."""
    import torch

    name = cell.workload["name"]
    chips = int(cell.workload["chips"])
    cuda = device.type == "cuda"
    t = time.perf_counter()
    entry_mod = manifest.entry(cell.config["entry"])
    wanted = cell.per_layer if tracing else cell.end_to_end
    readers = {m["name"]: manifest.metric(m["name"]) for m in wanted if m["name"] != "setup_s"}
    from . import trace as tr

    __import__(PROGRAM)
    split = {**(split or {}), "imports_s": time.perf_counter() - t}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cuda:
        t = time.perf_counter()
        torch.cuda.set_device(device)
        torch.zeros(1, device=device).sum().item()
        split["cuda_init_s"] = time.perf_counter() - t
        t = time.perf_counter()
        from dvo_slam_tpu_torch import _build

        libs = _build.load_libraries(["fused_stats", "while_graph"])
        split["kernels_s"] = time.perf_counter() - t
        split["build_seconds"] = max(lib.build_seconds for lib in libs.values())

    t = time.perf_counter()
    n_rec = traffic_mod.recording_frames(cell.config, cell.traffic, seconds)
    rec = traffic_mod.make_recording(cell.config, n_rec, seed, device)
    split["render_s"] = time.perf_counter() - t

    t = time.perf_counter()
    entry_mod.warm_up(cell.config, cell.traffic, rec, device)
    entry = entry_mod.Entry(cell.config, device)
    if cuda:
        torch.cuda.synchronize(device)
    split["warmup_s"] = time.perf_counter() - t
    split.update(entry_mod.setup_counts())
    setup_s = time.time() - process_start
    print("slam_bench: set-up " + " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                                           for k, v in split.items())
          + f" total={setup_s:.4f}", file=sys.stderr, flush=True)

    run = Run(name, cell.config, cell.traffic, seconds, setup_s)
    sync = (lambda: torch.cuda.synchronize(device)) if tracing and cuda else (lambda: None)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    _window(entry, rec, cell.traffic, seconds, tracing, sync, tr, run)
    card = _card() if cuda else "-"  # as the window closes
    found = forbidden_modules()
    if found:
        _fail("modules of JAX or of the JAX package are loaded: " + ", ".join(found[:20]))
    if cell.traffic["arrivals"] == "open":
        late = np.array([f.start - f.due for f in run.frames])
        print(f"slam_bench: generator lateness over {len(late)} frames: median "
              f"{np.median(late) * 1e3:.4f} ms, p95 {np.percentile(late, 95) * 1e3:.4f} ms, "
              f"max {late.max() * 1e3:.4f} ms; p95 by quarter of the window "
              + " ".join(f"{np.percentile(q, 95) * 1e3:.1f}" for q in np.array_split(late, 4))
              + " ms", file=sys.stderr, flush=True)
    run.timers = entry.timers()
    outputs = entry.finish()
    memory_peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0

    metrics = {}
    for m in wanted:
        value = setup_s if m["name"] == "setup_s" else readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {
        "attempted": len(run.frames),
        "failed": sum(f.pose is None for f in run.frames),
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else device.type,
                   "kind": torch.cuda.get_device_name(device) if cuda else device.type,
                   "count": chips, "memory_peak_bytes": memory_peak},
    }
    if tracing:
        if run.trace is None:
            _fail("the traced slice holds no profile")
        print(f"slam_bench: profiler start {run.counters['profiler_start_s']:.4f} s, "
              f"stop {run.counters['profiler_stop_s']:.4f} s, both outside the window",
              file=sys.stderr)
        print(entry.coverage_line(run, tr), file=sys.stderr, flush=True)
        result["device"]["busy_s"] = tr.busy_s(run.trace)
        result["device"]["window_s"] = tr.window_s(run.trace)
        result["breakdown"] = tr.breakdown(run.trace)
    print(f"slam_bench: card (name, power limit, SM clock, its maximum, power, temperature) "
          f"{card}; window {run.window_s:.4f} s, "
          f"{len(run.frames)} frames", file=sys.stderr, flush=True)

    # the program's state goes before the reference runs
    frames = run.frames
    del entry, run
    entry_mod.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks = entry_mod.judge(cell.config, cell.traffic, cell.limits, rec, frames, outputs,
                             seed, device)
    print(f"slam_bench: the check took {time.perf_counter() - t:.4f} s", file=sys.stderr)
    found = forbidden_modules()
    if found:
        _fail("modules of JAX or of the JAX package are loaded: " + ", ".join(found[:20]))
    correct = all(c["value"] <= c["limit"] for c in checks) and result["failed"] == 0
    return {"correct": correct, **result, "checks": checks}, checks
