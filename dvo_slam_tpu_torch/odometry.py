"""Frame-to-frame dense odometry over a raw RGB-D sequence: the benchmark
driver's tracker loop (the reference's ``bench.py`` ``track_sequence``),
run eagerly with the port.

Frames arrive as a sensor delivers them (u8 intensity, u16 depth at 1/5000
m), live on the device, and each is matched against the previous one with
a constant-velocity warm start at the caller's ``TrackerConfig``.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .models.dense_tracker import match_pyramids
from .ops.pyramid import build_pyramid, convert_raw_depth
from .utils import synthetic


def render_sequence(poses, shape, intrinsics, scene=None, seed0=0, workers=1):
    """Camera-format frames of the synthetic scene along ``poses``:
    u8 intensity [N, H, W] and u16 depth [N, H, W] (1/5000 m, 0 invalid),
    with the benchmark's sensor noise.  Frame i depends on its pose and on
    seed ``seed0 + i`` alone, so ``workers`` threads render the same frames
    as one (NumPy's array operations run outside the interpreter lock)."""
    n = len(poses)
    intensity_u8 = np.zeros((n,) + tuple(shape), np.uint8)
    depth_u16 = np.zeros((n,) + tuple(shape), np.uint16)

    def render(i):
        intensity, depth, valid = synthetic.render_frame(
            poses[i], intrinsics, shape, scene=scene, seed=seed0 + i,
            depth_noise=0.002, intensity_noise=1.0,
        )
        intensity_u8[i] = np.clip(intensity, 0, 255).astype(np.uint8)
        depth_u16[i] = np.where(valid, depth * 5000.0, 0).astype(np.uint16)

    if workers > 1:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            list(pool.map(render, range(n)))
    else:
        for i in range(n):
            render(i)
    return intensity_u8, depth_u16


def upload_sequence(intensity_u8, depth_u16, device):
    """Frames to the device; the u16 depth travels widened to int32."""
    return (
        torch.from_numpy(intensity_u8).to(device),
        torch.from_numpy(depth_u16.astype(np.int32)).to(device),
    )


def build_frame(cfg, intensity_u8, depth_raw):
    """One frame's pyramid from its raw channels; levels finer than the
    solve's last level are skipped."""
    depth, valid = convert_raw_depth(depth_raw)
    return build_pyramid(
        intensity_u8.to(torch.float32), depth, valid, cfg.num_levels,
        skip_below=cfg.last_level,
    )


def track_sequence(cfg, intrinsics, intensity, depth, on_result=None):
    """Frame-to-frame odometry over device-resident frames [N, H, W].

    Returns (poses [N, 4, 4] float64 with the first at the identity, total
    solver iterations, seconds from the first pyramid build to the last
    pose on the host).  ``on_result``, where given, is called with each
    pair's ``TrackingResult`` (its tensors still on the device)."""
    device = intensity.device
    eye = torch.eye(4, dtype=torch.float32, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    prev = build_frame(cfg, intensity[0], depth[0])
    pose, rel = eye, eye
    poses = [eye]
    iterations = 0
    for k in range(1, intensity.shape[0]):
        cur = build_frame(cfg, intensity[k], depth[k])
        result = match_pyramids(cfg, intrinsics, prev, cur, rel)
        if on_result is not None:
            on_result(result)
        iterations += sum(s.iterations for s in result.level_stats)
        rel = result.transformation
        pose = pose @ rel
        poses.append(pose)
        prev = cur
    out = torch.stack(poses).cpu().numpy().astype(np.float64)
    return out, iterations, time.perf_counter() - t0
