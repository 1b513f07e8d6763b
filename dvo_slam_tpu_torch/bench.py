"""Benchmark driver of the port: tracked frames/s for the dense tracker and
the SLAM system (port of the repository root's ``bench.py``).

Run on a machine with a CUDA card, from the repository root:

    python -m dvo_slam_tpu_torch.bench [--sections e2e,latency,...] [--mesh N [--streams B]]

Each section measures the reference benchmark's operating point (640x480
RGB-D, ``TUM_FR1``, ``benchmark_config()``: a 4-level pyramid solved 3 -> 1,
t-distribution IRLS, mu = 0.05; dvo_benchmark/launch/benchmark.yaml) on
rendered sequences, and writes its keys into one JSON record:

  * ``e2e``: ``StreamingSLAM`` (front end, replayed back end, final pass) on
    a 200-frame hard-scene loop, ``pipeline_chunk=50``, best of 3 runs on
    perturbed copies -> ``slam_e2e_fps``, ``slam_e2e_ate_rmse_m``,
    ``backend_phase_ms_per_frame``;
  * ``latency``: ``KeyframeTracker.update`` per frame (worker thread on)
    -> ``online_latency_ms`` (p50/p90/p99/mean/max, ``meets_30hz_p99``);
  * ``tracker``: frame-to-frame odometry on 100 easy frames, best of 3
    perturbed copies -> ``value`` (frames/s), ``vs_baseline`` (/30),
    ``ate_rmse_m``;
  * ``hard``: the same on the occluded scene -> ``ate_rmse_hard_m``;
  * ``multistream``: 8 streams x 50 frames, lockstep, sequential and
    lockstep without depth-buffered sampling ->
    ``aggregate_fps_8stream_{lockstep,sequential,lockstep_nobuf}``;
  * ``frontend``: the streaming front end alone on the easy frames ->
    ``slam_frontend_fps``, ``slam_ate_rmse_m``;
  * ``bsweep`` (only when named): the sequential schedule at 16 x 26 and
    32 x 14 -> ``aggregate_fps_{16,32}stream_sequential``.

A section that raises records ``error_<section>`` and the others still
run; the partial record is written to ``build/BENCH_PARTIAL.json`` after
every key.  The last line of standard output is the whole record with
``gates`` (``hard_ate_lt_10mm``, ``e2e_ate_lt_5mm``, ``e2e_fps_ge_30``);
the exit code is 0 only when every section ran and every gate passed.

``--mesh N`` starts N ranks of this driver, one process and one card each
(a TCP rendezvous on localhost; ``--mesh 1`` is one rank with a process
group): the multi-stream tracker with its B streams (``--streams``,
default N) cut over the ranks, then ``DataParallelSLAM`` on B 40-frame
hard-scene sequences with every stream's optimized trajectory gated on
ATE < 5 mm.  Rank 0 prints one JSON line.  Times are host seconds between
two ``torch.cuda.synchronize()`` calls.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import socket
import subprocess
import sys
import time
import traceback
from typing import Optional, Tuple

import numpy as np
import torch

from . import benchmark_config, default_device
from .config import SlamConfig
from .odometry import render_sequence as _render, track_sequence, upload_sequence
from .ops.camera import TUM_FR1, Intrinsics
from .utils import synthetic, trajectory

PARTIAL_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                            "BENCH_PARTIAL.json")

# accuracy gates (fail the exit code, never the metric capture; bench.py:43-46)
HARD_ATE_GATE_M = 0.01
E2E_ATE_GATE_M = 0.005
E2E_FPS_GATE = 30.0  # the reference's camera-rate contract

SHAPE = (480, 640)
NUM_FRAMES = 100
E2E_FRAMES = 200
PIPELINE_CHUNK = 50
MS_STREAMS = 8
MS_FRAMES = 50
BSWEEP = ((16, 26), (32, 14))
MESH_E2E_FRAMES = 40
LATENCY_WARM_FRAMES = 6  # bench.py:360
SECTIONS = ("e2e", "latency", "tracker", "hard", "multistream", "frontend")  # bsweep opt-in


class Report:
    """Accumulates metrics; writes the partial record after every ``set``."""

    def __init__(self, path: str = PARTIAL_PATH):
        self.path = path
        self.result = {}
        self.failed = []

    def set(self, **kv):
        self.result.update(kv)
        self.flush()

    def flush(self):
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        with open(self.path, "w") as f:
            json.dump(self.result, f)
            f.write("\n")

    @contextlib.contextmanager
    def section(self, name):
        try:
            yield
        except Exception:
            traceback.print_exc()
            self.failed.append(name)
            self.set(**{f"error_{name}": traceback.format_exc(limit=3).splitlines()[-1]})


def render_sequence(poses, shape, scene=None, seed0=0, intrinsics: Intrinsics = TUM_FR1,
                    workers: int = 1):
    """u8 intensity and u16 depth [N, H, W] of the synthetic scene along
    ``poses`` with the benchmark's sensor noise, frame i from seed
    ``seed0 + i`` (``bench.py:75-88``; ``workers`` threads render the same
    frames as one)."""
    return _render(poses, shape, intrinsics, scene=scene, seed0=seed0, workers=workers)


@dataclasses.dataclass
class Setup:
    """What the sections share: the configuration, the camera, the device
    and the easy sequence (ground truth and u8/u16 frames)."""

    cfg: SlamConfig
    intrinsics: Intrinsics
    device: torch.device
    shape: Tuple[int, int]
    poses: np.ndarray
    intensity_u8: np.ndarray
    depth_u16: np.ndarray
    workers: int = 1

    @property
    def stamps(self) -> np.ndarray:
        return np.arange(len(self.poses)) / 30.0


def make_setup(num_frames: int = NUM_FRAMES, shape=SHAPE, cfg: Optional[SlamConfig] = None,
               intrinsics: Intrinsics = TUM_FR1, device=None, workers: int = 1) -> Setup:
    """The easy sequence (a 5 cm circle, seeds 0..N-1) on ``device`` (the
    card unless named)."""
    device = default_device(device)
    poses = synthetic.circular_trajectory(num_frames, radius=0.05, rot_amplitude=0.02)
    iu, du = render_sequence(poses, shape, seed0=0, intrinsics=intrinsics, workers=workers)
    return Setup(cfg or benchmark_config(), intrinsics, device, tuple(shape), poses, iu, du,
                 workers)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device):
    """(fn(), seconds) between two synchronizations of ``device``."""
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0


def _hard_poses(frames):
    return synthetic.circular_trajectory(frames, radius=0.15, rot_amplitude=0.12,
                                         z_amplitude=0.05)


def _perturbed(frames: torch.Tensor, k: int, index) -> torch.Tensor:
    """A copy of device frames with ``k + 1`` added at ``index`` (u8 wraps)."""
    out = frames.clone()
    out[index] += k + 1
    return out


def e2e(rep: Report, setup: Setup, frames: int = E2E_FRAMES,
        pipeline_chunk: int = PIPELINE_CHUNK, reps: int = 3):
    """End-to-end SLAM (``bench.py:283-336``): ``StreamingSLAM`` on a
    hard-scene loop, pipelined; one warm run, then the best of ``reps``
    runs on copies whose row 0 is perturbed.  Returns the best run's
    optimized (stamps, poses)."""
    from .models.streaming import StreamingSLAM

    poses = _hard_poses(frames)
    iu, du = render_sequence(poses, setup.shape, scene=synthetic.occluded_scene(), seed0=2000,
                             intrinsics=setup.intrinsics, workers=setup.workers)
    stamps = np.arange(frames) / 30.0
    slam = StreamingSLAM(setup.intrinsics, setup.cfg, device=setup.device)
    try:
        slam.track_sequence(iu, du, stamps, pipeline_chunk=pipeline_chunk)
        best = None
        for r in range(reps):
            slam.reset()
            iv = iu.copy()
            iv[:, 0, :] += r + 1
            _, elapsed = _timed(lambda: slam.track_sequence(
                iv, du, stamps, pipeline_chunk=pipeline_chunk), setup.device)
            stamps_out, traj_out = slam.graph.trajectory()
            ate = trajectory.ate_rmse(stamps_out, traj_out, stamps, poses)
            phases = {name: round(s["total_s"] * 1000.0 / frames, 3)
                      for name, s in slam.graph.timers.summary().items()}
            if best is None or elapsed < best[0]:
                best = (elapsed, ate, phases, (stamps_out, traj_out))
    finally:
        slam.graph.shutdown()
    elapsed, ate, phases, traj = best
    rep.set(slam_e2e_fps=round(frames / elapsed, 2), slam_e2e_ate_rmse_m=round(float(ate), 5),
            backend_phase_ms_per_frame=phases)
    return traj


def latency(rep: Report, setup: Setup):
    """Online per-frame latency (``bench.py:352-386``): one
    ``KeyframeTracker.update`` per frame with the graph's worker thread on,
    after a warm-up tracker on the first ``LATENCY_WARM_FRAMES`` frames; the
    two bootstrap frames are left out."""
    from .models.keyframe_tracker import KeyframeTracker

    iu, du = setup.intensity_u8, setup.depth_u16
    warm = KeyframeTracker(setup.intrinsics, setup.cfg, device=setup.device)
    warm.init()
    for i in range(min(LATENCY_WARM_FRAMES, len(iu))):
        warm.update(warm.make_frame_raw(iu[i], du[i], i / 30.0))
    warm.graph.wait_for_queue()
    warm.graph.shutdown()

    kt = KeyframeTracker(setup.intrinsics, setup.cfg, device=setup.device)
    kt.init()
    lat_ms = []
    try:
        for i in range(len(iu)):
            t0 = time.perf_counter()
            kt.update(kt.make_frame_raw(iu[i], du[i], i / 30.0))  # the pose comes to the host
            lat_ms.append((time.perf_counter() - t0) * 1000.0)
        kt.graph.wait_for_queue()
    finally:
        kt.graph.shutdown()
    lat = np.asarray(lat_ms[2:])
    rep.set(online_latency_ms={
        "p50": round(float(np.percentile(lat, 50)), 1),
        "p90": round(float(np.percentile(lat, 90)), 1),
        "p99": round(float(np.percentile(lat, 99)), 1),
        "mean": round(float(lat.mean()), 1),
        "max": round(float(lat.max()), 1),
        "meets_30hz_p99": bool(np.percentile(lat, 99) < 33.3),
    })
    return lat


def tracker(rep: Report, setup: Setup, reps: int = 3):
    """Frame-to-frame odometry (``bench.py:388-432``) with the
    constant-velocity warm start, on device frames: one warm run, then the
    best of ``reps`` runs on copies with pixel (0, k) of every frame
    perturbed; the ATE of the last run.  Returns its trajectory."""
    tcfg = setup.cfg.tracker
    d_int, d_dep = upload_sequence(setup.intensity_u8, setup.depth_u16, setup.device)
    track_sequence(tcfg, setup.intrinsics, d_int, d_dep)  # warm-up
    variants = [_perturbed(d_int, k, (slice(None), 0, k)) for k in range(reps)]
    best = None
    for v in variants:
        (est, _, _), el = _timed(lambda: track_sequence(tcfg, setup.intrinsics, v, d_dep),
                                 setup.device)
        best = el if best is None else min(best, el)
    fps = (len(setup.poses) - 1) / best
    ate = trajectory.ate_rmse(setup.stamps, est, setup.stamps, setup.poses)
    rep.set(value=round(fps, 2), vs_baseline=round(fps / 30.0, 2),
            ate_rmse_m=round(float(ate), 5))
    return est


def hard(rep: Report, setup: Setup):
    """The hard-scene accuracy gate (``bench.py:434-447``): the occluded
    scene under a 30 cm loop, as many frames as the easy sequence."""
    poses = _hard_poses(len(setup.poses))
    iu, du = render_sequence(poses, setup.shape, scene=synthetic.occluded_scene(), seed0=1000,
                             intrinsics=setup.intrinsics, workers=setup.workers)
    d_i, d_d = upload_sequence(iu, du, setup.device)
    est, _, _ = track_sequence(setup.cfg.tracker, setup.intrinsics, d_i, d_d)
    rep.set(ate_rmse_hard_m=round(float(trajectory.ate_rmse(setup.stamps, est, setup.stamps,
                                                            poses)), 5))
    return est


def _rolled_streams(setup: Setup, streams: int, frames: int):
    """``streams`` copies of the easy sequence's first ``frames`` frames,
    stream b rolled by b (mod ``frames``) along time, on the device."""
    from .parallel.multistream import as_frames

    iu = np.stack([np.roll(setup.intensity_u8[:frames], b % frames, axis=0)
                   for b in range(streams)])
    du = np.stack([np.roll(setup.depth_u16[:frames], b % frames, axis=0)
                   for b in range(streams)])
    return as_frames(iu, du, setup.device)


def _aggregate_fps(run, d_i, d_d, device, reps: int = 2):
    """B (T - 1) frames / the mean seconds of ``reps`` runs on copies with
    pixel (0, k) of every frame perturbed, after one warm run."""
    run(d_i, d_d)
    variants = [_perturbed(d_i, k, (slice(None), slice(None), 0, k)) for k in range(reps)]
    _, elapsed = _timed(lambda: [run(v, d_d) for v in variants], device)
    return d_i.shape[0] * (d_i.shape[1] - 1) / (elapsed / reps)


def multistream(rep: Report, setup: Setup, streams: int = MS_STREAMS, frames: int = MS_FRAMES):
    """Aggregate frames/s of B streams on one card (``bench.py:453-497``):
    lockstep, sequential, and lockstep without depth-buffered sampling."""
    from .parallel.multistream import make_multistream_tracker

    d_i, d_d = _rolled_streams(setup, streams, frames)
    tcfg = setup.cfg.tracker
    for name, ms_cfg in (
        ("lockstep", tcfg),
        ("sequential", tcfg),
        ("lockstep_nobuf", dataclasses.replace(tcfg, depth_buffered_sampling=False)),
    ):
        run = make_multistream_tracker(ms_cfg, setup.intrinsics, schedule=name.split("_")[0],
                                       device=setup.device)
        rep.set(**{f"aggregate_fps_{streams}stream_{name}":
                   round(_aggregate_fps(run, d_i, d_d, setup.device), 2)})


def frontend(rep: Report, setup: Setup):
    """The streaming front end alone (``bench.py:501-536``): device
    throughput over the host-reduced frames (ingest and upload excluded),
    two runs on copies with pixel (0, k) perturbed after one warm run; the
    ATE of the unperturbed run.  Returns its [T, 130] records."""
    from .models.streaming import StreamingSLAM, _widen

    slam = StreamingSLAM(setup.intrinsics, setup.cfg, device=setup.device)
    slam.graph.shutdown()
    n = len(setup.poses)
    d_force = torch.zeros(n, dtype=torch.bool, device=setup.device)
    init_T = torch.eye(4, dtype=torch.float32, device=setup.device)
    d_i, d_d = slam._upload(setup.intensity_u8, setup.depth_u16)
    d_i = _widen(d_i)
    raw = slam._run(d_i, d_d, d_force, init_T).cpu()
    variants = [_perturbed(d_i, k, (slice(None), 0, k)) for k in range(2)]
    _, elapsed = _timed(lambda: [slam._run(v, d_d, d_force, init_T).cpu() for v in variants],
                        setup.device)
    rec = raw.numpy()
    est = rec[:, -16:].reshape(n, 4, 4).astype(np.float64)
    rep.set(slam_frontend_fps=round(len(variants) * (n - 1) / elapsed, 2),
            slam_ate_rmse_m=round(float(trajectory.ate_rmse(setup.stamps, est, setup.stamps,
                                                            setup.poses)), 5))
    return rec


def bsweep(rep: Report, setup: Setup, sweep=BSWEEP):
    """The sequential schedule past 8 streams (``bench.py:543-573``):
    (B, T) = (16, 26) and (32, 14)."""
    from .parallel.multistream import make_multistream_tracker

    for streams, frames in sweep:
        d_i, d_d = _rolled_streams(setup, streams, frames)
        run = make_multistream_tracker(setup.cfg.tracker, setup.intrinsics,
                                       schedule="sequential", device=setup.device)
        rep.set(**{f"aggregate_fps_{streams}stream_sequential":
                   round(_aggregate_fps(run, d_i, d_d, setup.device), 2)})
        del d_i, d_d


SECTION_FUNCTIONS = {"e2e": e2e, "latency": latency, "tracker": tracker, "hard": hard,
                     "multistream": multistream, "frontend": frontend, "bsweep": bsweep}


def gates(rep: Report) -> bool:
    """Record the accuracy and speed gates of the keys present
    (``bench.py:576-594``); True when every section ran and every gate
    passed: the exit rule."""
    r = rep.result
    g = {}
    if "ate_rmse_hard_m" in r:
        g["hard_ate_lt_10mm"] = bool(r["ate_rmse_hard_m"] < HARD_ATE_GATE_M)
    if "slam_e2e_ate_rmse_m" in r:
        g["e2e_ate_lt_5mm"] = bool(r["slam_e2e_ate_rmse_m"] < E2E_ATE_GATE_M)
    if "slam_e2e_fps" in r:
        g["e2e_fps_ge_30"] = bool(r["slam_e2e_fps"] >= E2E_FPS_GATE)
    rep.set(gates=g)
    return not rep.failed and all(g.values())


def device_name(device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or the
    device's name where it is not a card."""
    device = torch.device(device)
    if device.type != "cuda":
        return str(device)
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    index = torch.cuda.current_device() if device.index is None else device.index
    return lines[index if index < len(lines) else 0]


def run_sections(setup: Setup, wanted=(), rep: Optional[Report] = None,
                 **kwargs) -> Tuple[Report, bool]:
    """Every default section (or the ``wanted`` ones, in ``bench.py``'s
    order; ``bsweep`` only when wanted), then the gates.  ``kwargs`` maps a
    section's name to its keyword arguments.  Returns the report and the
    exit rule's verdict (:func:`gates`)."""
    rep = rep or Report()
    rep.set(metric="tracked_frames_per_second_per_chip", unit="frames/s",
            device=device_name(setup.device))
    wanted = set(wanted)
    for name in SECTIONS + ("bsweep",):
        if (not wanted and name in SECTIONS) or name in wanted:
            with rep.section(name):
                SECTION_FUNCTIONS[name](rep, setup, **kwargs.get(name, {}))
    return rep, gates(rep)


def mesh_run(mesh, setup: Setup, streams: Optional[int] = None,
             e2e_frames: int = MESH_E2E_FRAMES) -> dict:
    """The ``--mesh`` path on this rank (``bench.py:184-257``): the
    multi-stream tracker with B streams cut over the mesh, then
    ``DataParallelSLAM`` on B hard-scene sequences (seeds 3000 + 97 b).
    Returns the record rank 0 prints."""
    from .parallel.dp_slam import DataParallelSLAM
    from .parallel.multistream import make_multistream_tracker

    b = streams or mesh.size
    d_i, d_d = _rolled_streams(dataclasses.replace(setup, device=mesh.device), b,
                               len(setup.poses))
    run = make_multistream_tracker(setup.cfg.tracker, setup.intrinsics, mesh)
    fps = _aggregate_fps(run, d_i, d_d, mesh.device)
    result = {
        "metric": "aggregate_tracked_frames_per_second",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / 30.0, 2),
        "mesh_devices": mesh.size,
        "streams": b,
        "device": device_name(mesh.device),
    }
    del d_i, d_d

    gt = _hard_poses(e2e_frames)
    hard_scene = synthetic.occluded_scene()
    rendered = [render_sequence(gt, setup.shape, scene=hard_scene, seed0=3000 + 97 * s,
                                intrinsics=setup.intrinsics, workers=setup.workers)
                for s in range(b)]
    stamps = np.arange(e2e_frames) / 30.0
    dp = DataParallelSLAM(setup.intrinsics, setup.cfg, mesh=mesh)
    try:
        _, elapsed = _timed(lambda: dp.track_sequences(
            np.stack([r[0] for r in rendered]), np.stack([r[1] for r in rendered]), stamps),
            mesh.device)
        ates = [float(trajectory.ate_rmse(st, opt, stamps, gt)) for st, opt in dp.trajectories()]
    finally:
        dp.shutdown()
    result.update({
        "e2e_mesh_aggregate_fps": round(b * e2e_frames / elapsed, 2),
        "e2e_mesh_ate_rmse_m_max": round(max(ates), 5),
        "e2e_mesh_ate_rmse_m": [round(a, 5) for a in ates],
        "e2e_mesh_gate_ate_lt_5mm": bool(max(ates) < E2E_ATE_GATE_M),
    })
    return result


def _launch_ranks(args) -> int:
    """Start ``--mesh`` ranks of this driver, one process and one card each,
    and wait for them (rank 0 prints).  Returns the worst exit code; a
    rank that fails takes the others down."""
    if args.device != "cpu":
        cards = torch.cuda.device_count()
        if args.mesh > cards:
            raise ValueError(f"--mesh {args.mesh} asks for {args.mesh} ranks, one card each, "
                             f"but {cards} card(s) are visible")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    command = [sys.executable, "-m", "dvo_slam_tpu_torch.bench", "--mesh", str(args.mesh),
               "--streams", str(args.streams), "--init-method", f"tcp://localhost:{port}"]
    if args.device:
        command += ["--device", args.device]
    procs = [subprocess.Popen(command + ["--rank", str(rank)]) for rank in range(args.mesh)]
    codes = []
    try:
        for proc in procs:
            codes.append(proc.wait(timeout=3600))
            if codes[-1] != 0:
                break
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return max(codes, key=abs) if codes else 1


def _mesh_rank(args) -> int:
    from .parallel import distributed
    from .parallel.mesh import make_mesh

    distributed.initialize(init_method=args.init_method, world_size=args.mesh, rank=args.rank,
                           device=args.device)
    try:
        mesh = make_mesh(args.mesh, device=args.device)
        setup = make_setup(device=mesh.device, workers=os.cpu_count() or 1)
        result = mesh_run(mesh, setup, streams=args.streams or None)
    finally:
        distributed.shutdown()
    if args.rank == 0:
        print(json.dumps(result), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", type=int, default=0,
                    help="cut the multistream engine and DataParallelSLAM over N ranks, one "
                    "card each (0 = the single-card sections)")
    ap.add_argument("--streams", type=int, default=0,
                    help="with --mesh: streams per batch (default the mesh size)")
    ap.add_argument("--sections", type=str, default="",
                    help="comma-separated subset of " + ",".join(SECTIONS) +
                    " (plus the opt-in bsweep, run only when named); default all")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs on the CPU (gloo ranks with --mesh); default the card")
    ap.add_argument("--rank", type=int, default=None, help="(set by the --mesh launcher)")
    ap.add_argument("--init-method", default=None, help="(set by the --mesh launcher)")
    args = ap.parse_args(argv)
    # the tracker's Gram products in IEEE float32, as the kernels' checks hold them
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.mesh:
        return _launch_ranks(args) if args.rank is None else _mesh_rank(args)
    wanted = list(filter(None, args.sections.split(",")))
    unknown = set(wanted) - set(SECTION_FUNCTIONS)
    if unknown:
        ap.error(f"unknown sections {sorted(unknown)}")
    setup = make_setup(device=args.device, workers=os.cpu_count() or 1)
    rep, ok = run_sections(setup, wanted)
    # a failed gate never erases the metrics: the record prints first
    print(json.dumps(rep.result))
    sys.stdout.flush()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
