"""A recorded sequence from disk through the benchmark CLI: PNG decode,
the host ingest reduction and the CLI's engines, on the card.

Run from the repository root (the card by default):

    python -m dvo_slam_tpu_torch.tools.recorded_sequence [--frames 573]
        [--shape 480x640] [--engines streaming,keyframe] [--device cpu]

Renders the hard-scene loop (the occluded scene of ``chip_smoke.py``
phase 5, seeds 1000 + i) for ``--frames`` frames (573 is fr1/desk's
length) and writes it as a TUM RGB-D directory through the port's own PNG
writer (``utils/synthetic_tum.write_tum_frames``: RGB with R = G = B,
16-bit depth, assoc.txt, groundtruth.txt, FR1 intrinsics; the writer's
adaptive filters, as libpng writes real recordings).  Then:

  * decode: every frame through ``native.load_rgbd_raw`` serially and
    through ``RgbdFramePrefetcher`` (2 workers), each bit-equal to what was
    written; ms per frame of each;
  * reduce: ``host_reduce_ingest`` (the native C++ reduction) and
    ``reduce_ingest_numpy`` over the whole sequence to the benchmark's
    ingest level, bit-equal; ms per frame of each;
  * each engine of ``python -m dvo_slam_tpu_torch.cli.benchmark --dataset
    DIR`` (``odometry``: ``--mode odometry``; ``keyframe``: ``--mode slam
    --engine loop``; ``streaming``: ``--mode slam --engine streaming``),
    timed from the call to its report: frames/s, the report's ATEs and RPE,
    keyframes and loop edges of the SLAM engines, the solver iterations and
    the executed steps of kernel 1 (one stream) and 1b (B streams) beside
    their launches on the card, and the graph solves that fell back.

Prints one JSON line.  ``chip_smoke.py`` phase 18 runs the same functions
on its 100 hard-scene frames.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import tempfile
import threading
import time
import warnings
from typing import Dict

import numpy as np

from .. import benchmark_config, default_device, native
from ..cli import benchmark as cli
from ..models import dense_tracker
from ..models import frames as frames_mod
from ..models import keyframe_graph, streaming
from ..odometry import render_sequence
from ..ops.camera import TUM_FR1
from ..utils import synthetic, synthetic_tum
from .driver_launches import BATCHED, ONE, executed_steps, launches, lockstep_iterations, streams

ENGINES = {
    "odometry": ["--mode", "odometry"],
    "keyframe": ["--mode", "slam", "--engine", "loop"],
    "streaming": ["--mode", "slam", "--engine", "streaming"],
}


def hard_sequence(frames: int, shape=(480, 640), workers: int = 8):
    """The hard-scene loop of ``chip_smoke.py`` phase 5 at ``frames`` frames:
    (u8 [T, H, W], u16 [T, H, W], poses [T, 4, 4])."""
    poses = synthetic.circular_trajectory(frames, radius=0.15, rot_amplitude=0.12,
                                          z_amplitude=0.05)
    iu8, du16 = render_sequence(poses, shape, TUM_FR1, scene=synthetic.occluded_scene(),
                                seed0=1000, workers=workers)
    return iu8, du16, poses


def write_sequence(root: str, iu8, du16, poses, filters="adaptive", workers: int = 8) -> Dict:
    """Write the frames as a TUM directory (FR1 intrinsics); returns the
    seconds and the bytes written."""
    t0 = time.perf_counter()
    synthetic_tum.write_tum_frames(root, iu8, du16, poses, TUM_FR1, filters=filters,
                                   workers=workers)
    seconds = time.perf_counter() - t0
    files = [os.path.join(root, sub, n) for sub in ("rgb", "depth")
             for n in os.listdir(os.path.join(root, sub))]
    return {"write_s": seconds, "bytes": sum(os.path.getsize(f) for f in files)}


def roundtrip_u16(depth_u16, depth_scale: float = 5000.0):
    """The u16 depth the CLI's streaming engine hands ``StreamingSLAM``: the
    loader's float32 meters (``raw / 5000``) times 5000 in float32,
    truncated.  4,580 of the 65,535 nonzero values come back one unit low:
    the reference's defect (``cli/benchmark.py:137``), kept."""
    valid = depth_u16 > 0
    meters = np.where(valid, depth_u16.astype(np.float32) / depth_scale, 0.0)
    return np.where(valid, meters * 5000.0, 0).astype(np.uint16)


def _pairs(root):
    """(rgb, depth) file names of assoc.txt."""
    with open(os.path.join(root, "assoc.txt")) as f:
        return [tuple(line.split()[1::2]) for line in f if line.strip()]


def check_decode(root: str, iu8, du16, workers: int = 2) -> Dict:
    """Every frame decoded serially and through the prefetcher, each
    bit-equal to the arrays written (raises on the first that differs);
    ms per frame of each.  The extension is built (at first use) before
    the clock starts."""
    native.native_available()
    pairs = _pairs(root)
    t0 = time.perf_counter()
    for k, (rgb, dep) in enumerate(pairs):
        g8, d16 = native.load_rgbd_raw(os.path.join(root, rgb), os.path.join(root, dep))
        if not (np.array_equal(g8, iu8[k]) and np.array_equal(d16, du16[k])):
            raise AssertionError(f"frame {k} decodes differently from what was written")
    serial = time.perf_counter() - t0
    prefetcher = native.RgbdFramePrefetcher(pairs, root=root, workers=workers, raw=True)
    t0 = time.perf_counter()
    try:
        for k, (g8, d16) in enumerate(prefetcher):
            if not (np.array_equal(g8, iu8[k]) and np.array_equal(d16, du16[k])):
                raise AssertionError(f"frame {k} differs through the prefetcher")
    finally:
        prefetcher.close()
    prefetched = time.perf_counter() - t0
    n = len(pairs)
    return {"frames": n, "serial_ms_per_frame": 1e3 * serial / n,
            "prefetched_ms_per_frame": 1e3 * prefetched / n, "prefetch_workers": workers}


def time_reduction(iu8, du16, level: int, reps: int = 3) -> Dict:
    """``host_reduce_ingest`` (native) against ``reduce_ingest_numpy`` on the
    whole stack, best of ``reps``, bit-equal; ms per frame of each and the
    path the first took."""
    best = {"native": np.inf, "numpy": np.inf}
    out = {}
    for _ in range(reps):
        for name, fn in (("native", streaming.host_reduce_ingest),
                         ("numpy", streaming.reduce_ingest_numpy)):
            t0 = time.perf_counter()
            out[name] = fn(iu8, du16, level)
            best[name] = min(best[name], time.perf_counter() - t0)
            if name == "native":
                path = streaming.host_reduce_ingest.last_path
    equal = all(np.array_equal(a, b) for a, b in zip(out["native"], out["numpy"]))
    if not equal:
        raise AssertionError("the native and NumPy reductions differ")
    n = len(iu8)
    return {"level": level, "path": path, "reason": streaming.host_reduce_ingest.last_reason,
            "native_ms_per_frame": 1e3 * best["native"] / n,
            "numpy_ms_per_frame": 1e3 * best["numpy"] / n}


@contextlib.contextmanager
def counted_solves():
    """Records every solve of the three engines while open: (streams,
    level statistics) of each call of ``match_prepared`` in
    ``models.dense_tracker`` (the odometry engine's ``match_pyramids``),
    ``models.frames`` (``KeyframeTracker``, the validation waves) and
    ``models.streaming`` (the streaming front end)."""
    calls = []
    lock = threading.Lock()  # the graph's worker thread matches too

    def counted(fn):
        def match(*args, **kwargs):
            result = fn(*args, **kwargs)
            with lock:
                calls.append(result.level_stats)
            return result
        return match

    patches = [(mod, "match_prepared", counted(mod.match_prepared))
               for mod in (dense_tracker, frames_mod, streaming)]
    originals = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, fn in patches:
        setattr(obj, name, fn)
    try:
        yield calls
    finally:
        for obj, name, fn in originals:
            setattr(obj, name, fn)


def steps_of(calls) -> Dict:
    """Executed steps (kernel launches on the card) and solver iterations of
    the recorded solves, one stream (kernel 1) and B streams (kernel 1b)."""
    out = {"one_steps": 0, "batched_steps": 0, "one_iterations": 0, "batched_iterations": 0}
    for ls in calls:
        kind = "one" if streams(ls) == 1 else "batched"
        out[f"{kind}_steps"] += executed_steps(ls)
        out[f"{kind}_iterations"] += lockstep_iterations(ls)
    return out


def run_engine(root: str, engine: str, out_dir: str, device=None, timing: bool = True) -> Dict:
    """One CLI run on the TUM directory: its report, seconds, frames/s, the
    solves' steps beside the kernels' launches, keyframes and loop edges of
    a SLAM engine, and the graph solves that fell back."""
    argv = ["--dataset", root, *ENGINES[engine], "--output-dir", out_dir]
    if device is not None:
        argv += ["--device", str(device)]
    if timing:
        argv.append("--timing")
    graphs = []
    shutdown = keyframe_graph.KeyframeGraph.shutdown

    def kept_shutdown(self, *args, **kwargs):
        graphs.append(self)
        return shutdown(self, *args, **kwargs)

    out = io.StringIO()
    keyframe_graph.KeyframeGraph.shutdown = kept_shutdown
    before = launches()
    try:
        with warnings.catch_warnings(record=True) as caught, counted_solves() as calls, \
                contextlib.redirect_stdout(out):
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            rc = cli.main(argv)
            seconds = time.perf_counter() - t0
    finally:
        keyframe_graph.KeyframeGraph.shutdown = shutdown
    after = launches()
    report = json.loads(out.getvalue())
    record = {"engine": engine, "rc": rc, "seconds": seconds,
              "frames_per_s": report["frames"] / seconds, **steps_of(calls),
              "launches": {k: after[k] - before[k] for k in (ONE, BATCHED)},
              "other_launches": {k: after[k] - before[k] for k in after
                                 if k not in (ONE, BATCHED) and after[k] != before[k]},
              "fallbacks": [str(w.message) for w in caught if "falling back" in str(w.message)],
              "report": report}
    if graphs:
        g = graphs[-1].graph
        record["keyframes"] = len(graphs[-1].keyframes)
        record["loop_edges"] = int(g.robust[: g.num_edges].sum())
    return record


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--frames", type=int, default=573)
    ap.add_argument("--shape", default="480x640")
    ap.add_argument("--engines", default="streaming,keyframe")
    ap.add_argument("--workers", type=int, default=8, help="host threads rendering and writing")
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' runs on the CPU")
    args = ap.parse_args(argv)
    device = default_device(args.device)
    shape = tuple(int(x) for x in args.shape.split("x"))
    t0 = time.perf_counter()
    iu8, du16, poses = hard_sequence(args.frames, shape, args.workers)
    result = {"frames": args.frames, "shape": list(shape), "device": str(device),
              "render_s": time.perf_counter() - t0}
    if device.type == "cuda":
        import torch

        result["card"] = torch.cuda.get_device_name(device)
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "rgbd_dataset_fr1_synthetic")
        result["write"] = write_sequence(root, iu8, du16, poses, workers=args.workers)
        result["decode"] = check_decode(root, iu8, du16)
        # StreamingSLAM's default ingest level: the benchmark's finest solved level
        result["reduce"] = time_reduction(iu8, du16, benchmark_config().tracker.last_level)
        result["native_build_error"] = native.build_error()
        result["engines"] = {}
        for engine in args.engines.split(","):
            out_dir = os.path.join(tmp, "out_" + engine)
            result["engines"][engine] = run_engine(root, engine, out_dir, device)
    print(json.dumps(result, default=float), flush=True)
    return result


if __name__ == "__main__":
    main()
