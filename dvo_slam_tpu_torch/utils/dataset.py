"""Dataset loading: TUM RGB-D sequences and synthetic sequences (the
port's copy of ``dvo_slam_tpu.utils.dataset``).

Replaces the reference benchmark's host IO
(dvo_benchmark/src/benchmark_slam.cpp:46-93 — BGR -> gray float conversion,
uint16 depth / 5000 -> meters; assoc.txt parsing via
dvo_benchmark/include/dvo_benchmark/file_reader.h:35-113).

Frames are returned as host NumPy (intensity [H, W] float32 in 0..255,
depth [H, W] float32 meters with 0 marking invalid, valid [H, W] bool);
device upload and pyramid construction happen in the tracking engine so IO
can be overlapped with compute.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..ops.camera import TUM_FR1, TUM_FR2, TUM_FR3, TUM_DEFAULT, Intrinsics
from . import synthetic


@dataclass
class RgbdFrame:
    timestamp: float
    intensity: np.ndarray  # [H, W] float32, 0..255
    depth: np.ndarray  # [H, W] float32 meters, 0 invalid
    valid: np.ndarray  # [H, W] bool


def intrinsics_for_sequence(name: str) -> Intrinsics:
    """Hard-coded TUM intrinsics by freiburg id
    (reference: benchmark_slam.cpp:384-392)."""
    if "freiburg1" in name or "fr1" in name:
        return TUM_FR1
    if "freiburg2" in name or "fr2" in name:
        return TUM_FR2
    if "freiburg3" in name or "fr3" in name:
        return TUM_FR3
    return TUM_DEFAULT


def load_tum_image_pair(
    rgb_path: str, depth_path: str, depth_scale: float = 5000.0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Load one RGB + depth PNG pair in the reference's conventions.

    Prefers the native C++ decoder (``dvo_slam_tpu_torch.native``, the
    analog of the reference's OpenCV C++ loading path); falls back to cv2
    where it could not be built (``native.build_error()`` says why).
    """
    from .. import native

    if native.native_available():
        return native.load_rgbd_native(rgb_path, depth_path, depth_scale)

    import cv2

    bgr = cv2.imread(rgb_path, cv2.IMREAD_COLOR)
    if bgr is None:
        raise FileNotFoundError(rgb_path)
    gray = cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY).astype(np.float32)
    raw_depth = cv2.imread(depth_path, cv2.IMREAD_UNCHANGED)
    if raw_depth is None:
        raise FileNotFoundError(depth_path)
    valid = raw_depth > 0
    depth = np.where(valid, raw_depth.astype(np.float32) / depth_scale, 0.0)
    return gray, depth, valid


class TumDataset:
    """A TUM RGB-D sequence directory with an assoc.txt file.

    assoc.txt lines: ``rgb_t rgb_file depth_t depth_file`` (the output of
    the TUM associate.py tool, consumed by the reference's FileReader).
    Falls back to associating rgb.txt/depth.txt by nearest timestamp when
    assoc.txt is absent.
    """

    def __init__(self, root: str, assoc_file: str = "assoc.txt"):
        self.root = root
        self.pairs: List[Tuple[float, str, float, str]] = []
        assoc_path = os.path.join(root, assoc_file)
        if os.path.exists(assoc_path):
            self.pairs = self._parse_assoc(assoc_path)
        else:
            self.pairs = self._associate(
                os.path.join(root, "rgb.txt"), os.path.join(root, "depth.txt")
            )
        self.intrinsics = intrinsics_for_sequence(os.path.basename(os.path.normpath(root)))
        # minimal extension over real TUM layouts: an intrinsics.txt
        # ("fx fy ox oy") overrides the per-freiburg hard-coded presets
        # (benchmark_slam.cpp:384-390) for synthetic/custom rigs
        intr_path = os.path.join(root, "intrinsics.txt")
        if os.path.exists(intr_path):
            with open(intr_path) as f:
                fx, fy, ox, oy = (float(x) for x in f.read().split()[:4])
            self.intrinsics = Intrinsics(fx, fy, ox, oy)

    @staticmethod
    def _parse_assoc(path: str) -> List[Tuple[float, str, float, str]]:
        pairs = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split()
                if len(parts) >= 4:
                    pairs.append((float(parts[0]), parts[1], float(parts[2]), parts[3]))
        return pairs

    @staticmethod
    def _read_file_list(path: str) -> List[Tuple[float, str]]:
        out = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split()
                out.append((float(parts[0]), parts[1]))
        return out

    def _associate(self, rgb_list: str, depth_list: str, max_dt: float = 0.02):
        rgb = self._read_file_list(rgb_list)
        depth = self._read_file_list(depth_list)
        dstamps = np.array([d[0] for d in depth])
        pairs = []
        for t, f in rgb:
            i = int(np.argmin(np.abs(dstamps - t)))
            if abs(dstamps[i] - t) <= max_dt:
                pairs.append((t, f, depth[i][0], depth[i][1]))
        return pairs

    def __len__(self) -> int:
        return len(self.pairs)

    def __getitem__(self, i: int) -> RgbdFrame:
        t_rgb, rgb_file, _, depth_file = self.pairs[i]
        gray, depth, valid = load_tum_image_pair(
            os.path.join(self.root, rgb_file), os.path.join(self.root, depth_file)
        )
        return RgbdFrame(t_rgb, gray, depth, valid)

    def __iter__(self) -> Iterator[RgbdFrame]:
        for i in range(len(self)):
            yield self[i]


class SyntheticDataset:
    """Procedural RGB-D sequence with exact ground truth (see
    utils/synthetic.py).  Drop-in replacement for TumDataset where no TUM
    data is on disk; ``groundtruth()`` returns camera-to-world poses."""

    def __init__(
        self,
        num_frames: int = 60,
        shape: Tuple[int, int] = (480, 640),
        intrinsics: Intrinsics = TUM_DEFAULT,
        trajectory: Optional[np.ndarray] = None,
        fps: float = 30.0,
        depth_noise: float = 0.0,
        intensity_noise: float = 0.0,
        invalid_fraction: float = 0.0,
    ):
        self.shape = shape
        self.intrinsics = intrinsics
        self.fps = fps
        self.poses = (
            trajectory
            if trajectory is not None
            else synthetic.circular_trajectory(num_frames)
        )
        self.depth_noise = depth_noise
        self.intensity_noise = intensity_noise
        self.invalid_fraction = invalid_fraction

    def groundtruth(self) -> np.ndarray:
        return self.poses

    def timestamps(self) -> np.ndarray:
        return np.arange(len(self.poses)) / self.fps

    def __len__(self) -> int:
        return len(self.poses)

    def __getitem__(self, i: int) -> RgbdFrame:
        intensity, depth, valid = synthetic.render_frame(
            self.poses[i],
            self.intrinsics,
            self.shape,
            depth_noise=self.depth_noise,
            intensity_noise=self.intensity_noise,
            invalid_fraction=self.invalid_fraction,
            seed=i,
        )
        return RgbdFrame(i / self.fps, intensity, depth, valid)

    def __iter__(self) -> Iterator[RgbdFrame]:
        for i in range(len(self)):
            yield self[i]
