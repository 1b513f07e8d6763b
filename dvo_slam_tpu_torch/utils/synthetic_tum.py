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

The PNG files are written by the port's own encoder (``png_encode``:
per-row scanline filters, ``zlib.compress``), so no image library is
needed to write a sequence; the reference writes them with cv2.  The
decoded content is the same.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Iterable, Optional, Tuple, Union

import numpy as np

from .synthetic import circular_trajectory, render_frame
from .trajectory import pose_to_tum_line
from ..ops.camera import Intrinsics


IDAT_BYTES = 65536  # image data per IDAT chunk
ZLIB_LEVEL = 1  # cv2's default PNG compression, its speed setting


def png_filter(rows: np.ndarray, bpp: int, filters: Union[str, int] = "adaptive") -> np.ndarray:
    """Filter packed scanlines ``rows`` [h, rowbytes] (u8) for a PNG, ``bpp``
    bytes per complete pixel (1 below 8 bits).  ``filters``: a filter type
    0-4 (None, Sub, Up, Average, Paeth) for every row; ``"cycle"``, row y
    takes type y mod 5; ``"adaptive"``, each row takes the type whose
    output has the least sum of absolute values as signed bytes (libpng's
    heuristic).  Returns [h, 1 + rowbytes]: each row's filter type, then its
    filtered bytes."""
    x = rows.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    candidates = np.stack([x, x - a, x - b, x - ((a + b) >> 1), x - paeth]).astype(np.uint8)
    h = rows.shape[0]
    if filters == "adaptive":
        signed = candidates.astype(np.int8).astype(np.int16)
        choice = np.abs(signed).sum(axis=2).argmin(axis=0)
    elif filters == "cycle":
        choice = np.arange(h) % 5
    else:
        choice = np.full(h, int(filters))
    out = np.empty((h, rows.shape[1] + 1), np.uint8)
    out[:, 0] = choice
    out[:, 1:] = candidates[choice, np.arange(h)]
    return out


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(body, zlib.crc32(kind)))


def png_file(width: int, height: int, bit_depth: int, color_type: int, filtered: bytes,
             chunks: Iterable[Tuple[bytes, bytes]] = (), interlace: int = 0) -> bytes:
    """A PNG file from already filtered scanlines (all passes' rows, in
    order, for ``interlace=1``): the signature, IHDR, ``chunks`` (e.g.
    PLTE, tRNS), the zlib stream in IDAT chunks of ``IDAT_BYTES``, IEND."""
    stream = zlib.compress(filtered, ZLIB_LEVEL)
    parts = [b"\x89PNG\r\n\x1a\n",
             _chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, bit_depth, color_type,
                                         0, 0, interlace))]
    parts += [_chunk(kind, body) for kind, body in chunks]
    parts += [_chunk(b"IDAT", stream[i:i + IDAT_BYTES])
              for i in range(0, max(len(stream), 1), IDAT_BYTES)]
    parts.append(_chunk(b"IEND", b""))
    return b"".join(parts)


def png_encode(array: np.ndarray, filters: Union[str, int] = "adaptive") -> bytes:
    """Encode an image as cv2.imwrite does: [H, W] u8 or u16 as gray, [H,
    W, 3] u8 as BGR (stored as RGB)."""
    if array.ndim == 3 and array.shape[2] == 3 and array.dtype == np.uint8:
        color_type, rows, bpp = 2, array[..., ::-1].reshape(array.shape[0], -1), 3
    elif array.ndim == 2 and array.dtype == np.uint8:
        color_type, rows, bpp = 0, array, 1
    elif array.ndim == 2 and array.dtype == np.uint16:
        color_type, rows, bpp = 0, array.astype(">u2").view(np.uint8), 2
    else:
        raise ValueError(f"cannot encode a {array.dtype} array of shape {array.shape}")
    filtered = png_filter(np.ascontiguousarray(rows), bpp, filters)
    bit_depth = 16 if array.dtype == np.uint16 else 8
    return png_file(array.shape[1], array.shape[0], bit_depth, color_type, filtered.tobytes())


def _write_png(path: str, array: np.ndarray, filters: Union[str, int] = "adaptive"):
    """Write an 8-bit BGR or 16-bit single-channel PNG (``png_encode``)."""
    with open(path, "wb") as f:
        f.write(png_encode(array, filters))


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
    gray_u8 = np.zeros((num_frames, h, w), np.uint8)
    depth_u16 = np.zeros((num_frames, h, w), np.uint16)
    for i in range(num_frames):
        intensity, depth, valid = render_frame(
            trajectory[i], intrinsics, shape, seed=seed + i,
            depth_noise=depth_noise, intensity_noise=intensity_noise)
        gray_u8[i] = np.clip(np.rint(intensity), 0, 255).astype(np.uint8)
        depth_u16[i] = np.where(
            valid, np.clip(np.rint(depth * depth_scale), 0, 65535), 0
        ).astype(np.uint16)
    return write_tum_frames(root, gray_u8, depth_u16, trajectory[:num_frames], intrinsics,
                            fps=fps, write_assoc=write_assoc)


def write_tum_frames(
    root: str,
    gray_u8: np.ndarray,
    depth_u16: np.ndarray,
    trajectory: np.ndarray,
    intrinsics: Intrinsics,
    fps: float = 30.0,
    write_assoc: bool = True,
    filters: Union[str, int] = "adaptive",
    workers: int = 1,
) -> str:
    """Write frames [T, H, W] (u8 gray, u16 depth at the TUM scale) and
    their camera-to-world poses as a TUM sequence directory at ``root``:
    RGB PNGs with R = G = B (the loader's BT.601 conversion returns the
    gray value exactly), 16-bit depth PNGs, assoc.txt (unless
    ``write_assoc=False``), rgb.txt, depth.txt, groundtruth.txt and
    intrinsics.txt.  ``filters`` as ``png_filter`` takes it; ``workers``
    threads encode the frames (zlib and NumPy release the GIL).  Returns
    ``root``."""
    import concurrent.futures

    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    stamps = [f"{i / fps:.6f}" for i in range(len(gray_u8))]

    def write(i):
        _write_png(os.path.join(root, "rgb", stamps[i] + ".png"),
                   np.repeat(gray_u8[i][..., None], 3, axis=-1), filters)
        _write_png(os.path.join(root, "depth", stamps[i] + ".png"), depth_u16[i], filters)

    with concurrent.futures.ThreadPoolExecutor(max_workers=max(1, workers)) as pool:
        list(pool.map(write, range(len(gray_u8))))
    assoc = [f"{t} rgb/{t}.png {t} depth/{t}.png" for t in stamps]
    rgb_list = [f"{t} rgb/{t}.png" for t in stamps]
    depth_list = [f"{t} depth/{t}.png" for t in stamps]
    gt_lines = [pose_to_tum_line(i / fps, trajectory[i]) for i in range(len(stamps))]

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
