"""Native RGB-D ingest: PNG decode, the host-side ingest reduction and a
threaded prefetcher (the port's copy of ``dvo_slam_tpu.native``).

The reference's host pipeline is C++ throughout (OpenCV imread + color
conversion, benchmark_slam.cpp:46-93).  Here a PNG is decoded in two
parts, neither of which needs libpng: this module parses the chunks,
checks their CRCs and inflates the IDAT stream with the standard
library's ``zlib`` (which releases the GIL), and a small C++ extension
(``ingest.cpp``, the CPython API alone, the GIL released) undoes the
scanline filters and Adam7 interlacing and converts to luma or u16 depth,
the bytes the reference's libpng decoder gives.  The extension also holds
the ingest reduction.  It is compiled with ``g++`` at first use into the
package's ``build/`` directory (listed in ``.gitignore``), under a name
that carries a hash of the source, the flags and the interpreter, so an
edited source is rebuilt.

Where the build fails (no ``g++`` or no Python headers), nothing fails
with it: ``utils.dataset.load_tum_image_pair`` decodes with cv2 and
``models.streaming.host_reduce_ingest`` reduces with NumPy, bit-equal.
The failure is kept, not hidden: :func:`build_error` returns the
compiler's message.

``RgbdFramePrefetcher`` overlaps dataset IO/decode with device compute —
the ingest half of the pipeline parallelism the reference gets from its
ROS message queue.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import importlib.util
import os
import struct
import subprocess
import sys
import sysconfig
import tempfile
import threading
import zlib
from typing import Iterator, NamedTuple, Optional, Tuple

import numpy as np

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ingest.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LIBS: Tuple[str, ...] = ()  # g++ and the Python headers alone

_lock = threading.Lock()
_ext = None
_build_error: Optional[str] = None


def library_path() -> str:
    """Where the extension is (or will be) built: ``build/`` of the package,
    named by a hash of the source, the flags and the interpreter."""
    include = sysconfig.get_paths()["include"]
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(CXX_FLAGS + LIBS + (include, sys.version)).encode()
        ).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"_dvo_ingest_{digest}.so")


def _build_extension() -> str:
    """Compile ingest.cpp into the build directory (g++), unless
    this source's build is already there."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *CXX_FLAGS, f"-I{sysconfig.get_paths()['include']}", SOURCE, *LIBS, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}): {proc.stderr.strip()}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _load():
    """The extension module, built and loaded once per process; None (and
    :func:`build_error` set) where it cannot be built or loaded."""
    global _ext, _build_error
    with _lock:
        if _ext is not None or _build_error is not None:
            return _ext
        try:
            so_path = _build_extension()
            spec = importlib.util.spec_from_file_location("_dvo_ingest", so_path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _ext = mod
        except Exception as e:  # toolchain-dependent: recorded, see build_error()
            _build_error = f"{type(e).__name__}: {e}"
            _ext = None
        return _ext


def native_available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the extension is unavailable (the compiler's or loader's message),
    or None where it built and loaded."""
    _load()
    return _build_error


PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


class PngImage(NamedTuple):
    """A PNG's header and its inflated image data (still filtered; the
    extension checks its length)."""

    width: int
    height: int
    bit_depth: int
    color_type: int
    interlace: int
    palette: bytes  # PLTE's RGB triples (empty where absent)
    transparency: bool  # a tRNS chunk that applies to this color type
    data: bytes


def read_png(data) -> PngImage:
    """Parse a PNG file's chunks and inflate its image data, as libpng
    reads it: the signature, IHDR first, every critical chunk's CRC
    (an ancillary chunk with a bad CRC is dropped, libpng's default),
    PLTE before IDAT for a palette image, the IDAT chunks' zlib stream
    (data past its end ignored), IEND.  Raises ``ValueError`` on a file
    libpng refuses."""
    data = memoryview(data)
    if len(data) < 8 or data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG")
    pos, header, palette, transparency, idat = 8, None, b"", False, []
    while True:
        if pos + 12 > len(data):
            raise ValueError("truncated PNG: no IEND chunk")
        length, kind = struct.unpack_from(">I4s", data, pos)
        end = pos + 8 + length
        if length > 0x7FFFFFFF or end + 4 > len(data):
            raise ValueError(f"truncated PNG: {kind!r} chunk")
        body = data[pos + 8:end]
        (crc,) = struct.unpack_from(">I", data, end)
        pos = end + 4
        critical = not kind[0] & 0x20
        if zlib.crc32(body, zlib.crc32(kind)) != crc:
            if critical:
                raise ValueError(f"bad CRC in the {kind.decode('latin-1')} chunk")
            continue
        if header is None and kind != b"IHDR":
            raise ValueError("PNG does not start with IHDR")
        if kind == b"IHDR":
            if header is not None or length != 13:
                raise ValueError("bad IHDR chunk")
            header = struct.unpack(">IIBBBBB", body)
            width, height, bit_depth, color_type, compression, filtering, interlace = header
            allowed = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
            if (not 0 < width <= 1_000_000 or not 0 < height <= 1_000_000
                    or bit_depth not in allowed.get(color_type, ())
                    or compression or filtering or interlace > 1):
                raise ValueError(f"unsupported PNG header {header}")
        elif kind == b"PLTE":
            if color_type == 3 and (length % 3 or not 0 < length <= 768):
                raise ValueError("bad PLTE chunk")
            if color_type & 2:  # ignored in a gray image, as libpng does
                palette = bytes(body)
        elif kind == b"tRNS":
            # tRNS_to_alpha: a palette's, gray's (2 bytes) or RGB's (6)
            transparency = (color_type == 3 or length == {0: 2, 2: 6}.get(color_type))
        elif kind == b"IDAT":
            if color_type == 3 and not palette:
                raise ValueError("missing PLTE before IDAT")
            idat.append(body)
        elif kind == b"IEND":
            break
        elif critical:
            raise ValueError(f"unknown critical chunk {kind!r}")
    try:
        inflated = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"bad PNG image data: {e}") from None
    return PngImage(width, height, bit_depth, color_type, interlace, palette, transparency,
                    inflated)


def _extension():
    ext = _load()
    if ext is None:
        raise RuntimeError(f"native ingest unavailable: {_build_error}")
    return ext


def decode_gray_u8(png_bytes) -> Tuple[bytes, int, int]:
    """PNG bytes -> (H*W u8 luma bytes, h, w): any color type and bit depth,
    as the reference's libpng path converts them for luma."""
    ext = _extension()
    img = read_png(png_bytes)
    return ext.unfilter_gray_u8(img.data, img.width, img.height, img.bit_depth,
                                img.color_type, img.interlace, img.palette)


def decode_depth_u16(png_bytes) -> Tuple[bytes, int, int]:
    """16-bit grayscale PNG bytes -> (H*W u16 native-endian bytes, h, w);
    anything else raises the reference's ``ValueError``."""
    ext = _extension()
    img = read_png(png_bytes)
    if img.transparency:  # tRNS_to_alpha adds a channel in the reference
        raise ValueError("depth PNG is not 16-bit single channel")
    return ext.unfilter_depth_u16(img.data, img.width, img.height, img.bit_depth,
                                  img.color_type, img.interlace)


def load_rgbd_native(
    rgb_path: str, depth_path: str, depth_scale: float = 5000.0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Load one frame with the native decoder:
    (gray float32 0..255, depth float32 meters 0-invalid, valid bool)."""
    gray, raw = load_rgbd_raw(rgb_path, depth_path)
    valid = raw > 0
    depth = np.where(valid, raw.astype(np.float32) / depth_scale, 0.0)
    return gray.astype(np.float32), depth, valid


def reduce_ingest_native(intensity_u8: np.ndarray, depth_u16: np.ndarray, levels: int):
    """C++ twin of ``models.streaming.host_reduce_ingest``: lossless u16
    4^k-scaled 2x2-mean intensity + subsampled depth, two worker threads,
    GIL released.  Returns (intensity_u16, depth_u16) or raises if the
    extension is unavailable or the shape unsupported (the caller then
    takes the NumPy form)."""
    ext = _extension()
    iu = np.ascontiguousarray(intensity_u8, np.uint8)
    du = np.ascontiguousarray(depth_u16, np.uint16)
    t, h, w = iu.shape
    ib, db, ho, wo = ext.reduce_ingest(iu.data, du.data, t, h, w, int(levels))
    return (
        np.frombuffer(ib, np.uint16).reshape(t, ho, wo),
        np.frombuffer(db, np.uint16).reshape(t, ho, wo),
    )


def load_rgbd_raw(rgb_path: str, depth_path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Camera-native formats (u8 luma, u16 raw depth) for minimal
    host->device transfer; conversion happens on the device
    (``ops.pyramid.convert_raw_depth``)."""
    with open(rgb_path, "rb") as f:
        gray_bytes, h, w = decode_gray_u8(f.read())
    with open(depth_path, "rb") as f:
        depth_bytes, dh, dw = decode_depth_u16(f.read())
    return (
        np.frombuffer(gray_bytes, np.uint8).reshape(h, w),
        np.frombuffer(depth_bytes, np.uint16).reshape(dh, dw),
    )


class RgbdFramePrefetcher:
    """Read-ahead frame loader: decodes frames on a thread pool (the
    native decoder releases the GIL) while the device tracks."""

    def __init__(self, pairs, root: str = "", depth: int = 4, workers: int = 2,
                 raw: bool = False):
        """``pairs``: [(rgb_path, depth_path), ...] relative to ``root``."""
        self.pairs = [(os.path.join(root, r), os.path.join(root, d)) for r, d in pairs]
        self.depth = depth
        self.raw = raw
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=workers)

    def _load(self, i: int):
        rgb, dep = self.pairs[i]
        if self.raw:
            return load_rgbd_raw(rgb, dep)
        return load_rgbd_native(rgb, dep)

    def __iter__(self) -> Iterator:
        futures = {}
        horizon = min(self.depth, len(self.pairs))
        for i in range(horizon):
            futures[i] = self._pool.submit(self._load, i)
        for i in range(len(self.pairs)):
            nxt = i + horizon
            if nxt < len(self.pairs):
                futures[nxt] = self._pool.submit(self._load, nxt)
            yield futures.pop(i).result()

    def close(self):
        self._pool.shutdown(wait=False)
