"""Write a synthetic sequence as a real on-disk TUM RGB-D directory (the
port's copy of ``dvo_slam_tpu.utils.synthetic_tum``).

The reference's de-facto integration test is running `dvo_benchmark` over a
TUM sequence directory (assoc.txt + rgb/ + depth/ PNGs + groundtruth.txt,
benchmark_slam.cpp:46-93, 448-525).  No TUM data ships with the
repository, so this module produces the same artifact from the
procedural renderer (the port's ``utils/synthetic``, bit-equal to the
reference's): 8-bit RGB PNGs, 16-bit depth PNGs at the TUM 1/5000 m
scale (surface_pyramid.cpp:45-63), assoc.txt in the associate.py layout the
FileReader consumes (file_reader.h:35-113), rgb.txt/depth.txt for the
nearest-timestamp association fallback, and groundtruth.txt in TUM
quaternion format.

This exercises the whole TUM ingest path — PNG decode (native C++ or cv2),
BT.601 gray conversion, u16 depth scaling, association, groundtruth ATE —
end-to-end, which a purely in-memory synthetic dataset cannot.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from .synthetic import circular_trajectory, render_frame
from .trajectory import pose_to_tum_line
from ..ops.camera import Intrinsics


def _write_png(path: str, array: np.ndarray):
    """Write an 8-bit BGR or 16-bit single-channel PNG via cv2."""
    import cv2

    if not cv2.imwrite(path, array):
        raise IOError(f"cv2.imwrite failed for {path}")


def write_tum_sequence(
    root: str,
    num_frames: int = 20,
    shape: Tuple[int, int] = (120, 160),
    intrinsics: Optional[Intrinsics] = None,
    trajectory: Optional[np.ndarray] = None,
    fps: float = 30.0,
    depth_scale: float = 5000.0,
    depth_noise: float = 0.0,
    intensity_noise: float = 0.0,
    seed: int = 0,
    write_assoc: bool = True,
) -> str:
    """Render ``num_frames`` and write a TUM sequence directory at ``root``.

    Also writes ``intrinsics.txt`` (``fx fy ox oy``) — a minimal extension
    real TUM dirs don't have (the reference hard-codes intrinsics per
    freiburg id, benchmark_slam.cpp:384-390); ``TumDataset`` prefers it
    when present so non-640x480 synthetic rigs load correctly.

    ``write_assoc=False`` omits assoc.txt to exercise the rgb.txt/depth.txt
    nearest-timestamp association fallback.  Returns ``root``.
    """
    h, w = shape
    if intrinsics is None:
        f = 1.25 * w  # TUM-like field of view at any resolution
        intrinsics = Intrinsics(f, f, (w - 1) / 2.0, (h - 1) / 2.0)
    if trajectory is None:
        trajectory = circular_trajectory(num_frames, radius=0.05,
                                         rot_amplitude=0.02)
    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)

    assoc, rgb_list, depth_list, gt_lines = [], [], [], []
    for i in range(num_frames):
        t = i / fps
        intensity, depth, valid = render_frame(
            trajectory[i], intrinsics, shape, seed=seed + i,
            depth_noise=depth_noise, intensity_noise=intensity_noise)
        # gray replicated into BGR: the loader's BT.601 conversion
        # (0.299 R + 0.587 G + 0.114 B) returns the same value back
        gray_u8 = np.clip(np.rint(intensity), 0, 255).astype(np.uint8)
        bgr = np.repeat(gray_u8[..., None], 3, axis=-1)
        depth_u16 = np.where(
            valid, np.clip(np.rint(depth * depth_scale), 0, 65535), 0
        ).astype(np.uint16)
        rgb_rel = f"rgb/{t:.6f}.png"
        depth_rel = f"depth/{t:.6f}.png"
        _write_png(os.path.join(root, rgb_rel), bgr)
        _write_png(os.path.join(root, depth_rel), depth_u16)
        assoc.append(f"{t:.6f} {rgb_rel} {t:.6f} {depth_rel}")
        rgb_list.append(f"{t:.6f} {rgb_rel}")
        depth_list.append(f"{t:.6f} {depth_rel}")
        gt_lines.append(pose_to_tum_line(t, trajectory[i]))

    if write_assoc:
        with open(os.path.join(root, "assoc.txt"), "w") as f:
            f.write("\n".join(assoc) + "\n")
    with open(os.path.join(root, "rgb.txt"), "w") as f:
        f.write("# color images\n# timestamp filename\n" + "\n".join(rgb_list) + "\n")
    with open(os.path.join(root, "depth.txt"), "w") as f:
        f.write("# depth images\n# timestamp filename\n" + "\n".join(depth_list) + "\n")
    with open(os.path.join(root, "groundtruth.txt"), "w") as f:
        f.write("# ground truth trajectory\n" + "\n".join(gt_lines) + "\n")
    with open(os.path.join(root, "intrinsics.txt"), "w") as f:
        f.write(f"{intrinsics.fx} {intrinsics.fy} {intrinsics.ox} {intrinsics.oy}\n")
    return root
