"""The one traffic generator: a recording of rendered RGB-D frames and its
arrival schedule, from a configuration, a traffic mix and the seed.

A configuration (``configs/<name>.json``) gives the camera (shape, rate,
intrinsics), the scene and the loop the camera flies (``loop``: frames
per lap, radius, rotation and height amplitudes of
``scene.circular_trajectory``) and the sensor noise.  A traffic mix
(``traffic/<name>.json``) gives how frames arrive:

* ``"arrivals": "closed"``: a recording of ``recording_frames`` frames
  (``"sequence"``: the configuration's sequence length) handed over back
  to back, the next when the last pose is on the host; the recording
  starts again from its first frame once it has run out (a new pass);
* ``"arrivals": "open"``: a live camera at ``rate_hz``: frame k is due at
  k / rate_hz seconds after the window opens, and the recording holds as
  many frames as the window has.

Each distinct pose of a lap is rendered once without noise, on the
device (``scene.render_frames_torch``);
frame f shows lap pose f mod lap_frames, with its own sensor noise: row f
of one draw of a ``torch.Generator`` seeded with (seed, f // 64), on the device, 64
frames a call.  The same seed gives the same frames.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from . import scene

NOISE_CHUNK = 64  # frames per noise draw


class Intrinsics(NamedTuple):
    fx: float
    fy: float
    ox: float
    oy: float


class Recording(NamedTuple):
    """Frames as a camera delivers them, held in host memory."""

    intensity: np.ndarray  # [F, H, W] uint8
    depth: np.ndarray  # [F, H, W] uint16, 1/5000 m, 0 invalid
    poses: np.ndarray  # [F, 4, 4] float64 ground truth, camera to world
    stamps: np.ndarray  # [F] seconds
    intrinsics: Intrinsics


def intrinsics_of(config: dict) -> Intrinsics:
    k = config["intrinsics"]
    return Intrinsics(float(k["fx"]), float(k["fy"]), float(k["ox"]), float(k["oy"]))


def lap_poses(config: dict) -> np.ndarray:
    loop = config["loop"]
    return scene.circular_trajectory(int(loop["lap_frames"]), float(loop["radius_m"]),
                                     float(loop["rot_amplitude_rad"]),
                                     float(loop["z_amplitude_m"]))


def recording_frames(config: dict, traffic: dict, seconds: float) -> int:
    """How many frames the recording holds for a window of ``seconds``."""
    if traffic["arrivals"] == "closed":
        frames = traffic["recording_frames"]
        return int(config["sequence"]["frames"] if frames == "sequence" else frames)
    if traffic["arrivals"] == "open":
        return int(math.ceil(float(traffic["rate_hz"]) * seconds)) + 1
    raise ValueError(f"unknown arrivals {traffic['arrivals']!r}")


def seed_generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    return gen


def render_lap(config: dict, device):
    """The lap's clean frames on ``device``: intensity [L, H, W] float32,
    depth [L, H, W] float32 (0 invalid), validity [L, H, W] bool."""
    return scene.render_frames_torch(lap_poses(config), intrinsics_of(config),
                                     tuple(config["sequence"]["shape"]),
                                     scene.SCENES[config["scene"]](), device)


def make_recording(config: dict, frames: int, seed: int, device) -> Recording:
    """``frames`` frames along the configuration's loop with sensor noise
    drawn from ``seed`` on ``device``."""
    d_i, d_z, d_v = render_lap(config, device)
    lap = len(d_i)
    noise = config["sensor_noise"]
    scale = float(noise["depth_scale"])
    shape = tuple(d_i.shape[1:])
    intensity = np.empty((frames,) + shape, np.uint8)
    depth = np.empty((frames,) + shape, np.uint16)
    for start in range(0, frames, NOISE_CHUNK):
        idx = torch.arange(start, min(frames, start + NOISE_CHUNK), device=device) % lap
        n = len(idx)
        # chunk c's noise from (seed, c): frame f's from (seed, f) alone
        gen = seed_generator(int(seed) * 1000003 + start // NOISE_CHUNK, device)
        e_i = torch.randn((NOISE_CHUNK,) + shape, generator=gen, device=device)[:n]
        e_z = torch.randn((NOISE_CHUNK,) + shape, generator=gen, device=device)[:n]
        i = (d_i[idx] + float(noise["intensity_sigma"]) * e_i).clamp(0.0, 255.0)
        z = torch.where(d_v[idx], (d_z[idx] + float(noise["depth_sigma_m"]) * e_z) * scale,
                        torch.zeros((), device=device))
        intensity[start:start + n] = i.to(torch.uint8).cpu().numpy()
        depth[start:start + n] = z.clamp(0.0, 65535.0).to(torch.int32).cpu().numpy()
    rate = float(config["sequence"]["rate_hz"])
    poses = lap_poses(config)[np.arange(frames) % lap]
    return Recording(intensity, depth, poses, np.arange(frames) / rate, intrinsics_of(config))


def due_times(traffic: dict, frames: int) -> np.ndarray:
    """Seconds after the window opens at which each frame is due (open
    arrivals), zeros for closed arrivals."""
    if traffic["arrivals"] == "open":
        return np.arange(frames) / float(traffic["rate_hz"])
    return np.zeros(frames)
