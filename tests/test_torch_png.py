"""The port's PNG decoder and writer (``dvo_slam_tpu_torch.native``,
``utils/synthetic_tum``), which need no image library.

- Every color type and bit depth the reference's libpng path accepts
  (gray 1/2/4/8/16, RGB 8/16, palette 1/2/4/8 with and without tRNS, gray
  + alpha 8/16, RGBA 8/16), each of the five scanline filters, the
  writer's adaptive and cycling choices, cv2's own adaptive files and
  Adam7-interlaced files built here: the luma is bit-equal to the
  reference's formula, (4899 R + 9617 G + 1868 B + 8192) >> 14, applied to
  the 8-bit BGR that ``cv2.imread`` decodes, and to the reference's libpng
  decoder (``dvo_slam_tpu.native``) where it loads; 16-bit depth
  bit-equal to ``cv2.imread(IMREAD_UNCHANGED)`` and to the reference.
  (cv2's own ``cvtColor`` is held within one level: on this cv2 it rounds
  differently on a fraction of the pixels.)
- Rejection, with ``ValueError`` as the reference raises it: garbage, a
  bad CRC, a truncated IDAT stream, a file cut before IEND, and depth
  files that are not 16-bit single channel (8-bit gray, 16-bit RGB, 16-bit
  gray with tRNS).
- The writer round-trips what it writes; the extension is built without
  libpng; the host ingest reduction takes the native path.  Without a
  compiler ``build_error()`` says so and the NumPy and cv2 fallbacks give
  the same results.
- The reference's depth round trip (``cli/benchmark.py:137``): both CLIs'
  streaming engines turn the loader's float depth back into u16 with a
  float32 product that truncates, so 4,580 of the 65,535 nonzero values
  come back one unit low, the same values in both packages (and in
  ``tools/recorded_sequence.roundtrip_u16``, which phase 18 applies).
- ``tools/recorded_sequence``'s steps on a tiny written sequence.
"""

import os
import struct
import zlib

import numpy as np
import pytest
import torch

from dvo_slam_tpu import native as j_native
from dvo_slam_tpu.cli import benchmark as j_cli
from dvo_slam_tpu.models import streaming as j_streaming

from dvo_slam_tpu_torch import native
from dvo_slam_tpu_torch.cli import benchmark as cli
from dvo_slam_tpu_torch.models import streaming
from dvo_slam_tpu_torch.odometry import render_sequence
from dvo_slam_tpu_torch.ops.camera import Intrinsics
from dvo_slam_tpu_torch.tools import recorded_sequence
from dvo_slam_tpu_torch.utils import dataset, synthetic, synthetic_tum
from dvo_slam_tpu_torch.utils.synthetic_tum import png_encode, png_file, png_filter

cv2 = pytest.importorskip("cv2")

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

SHAPE = (23, 37)  # odd sizes: partial bytes at 1-4 bits, irregular Adam7 passes
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _luma(bgr):
    b, g, r = (bgr[..., k].astype(np.uint32) for k in range(3))
    return ((4899 * r + 9617 * g + 1868 * b + 8192) >> 14).astype(np.uint8)


def _pack(samples, bit_depth):
    """Samples [h, n] -> packed scanlines [h, rowbytes] (big-endian)."""
    if bit_depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(samples.shape[0], -1)
    if bit_depth == 8:
        return samples.astype(np.uint8)
    per = 8 // bit_depth
    h, n = samples.shape
    padded = np.zeros((h, -(-n // per) * per), np.uint8)
    padded[:, :n] = samples
    groups = padded.reshape(h, -1, per)
    shifts = (8 - bit_depth * (np.arange(per) + 1)).astype(np.uint8)
    return np.bitwise_or.reduce(groups << shifts, axis=2).astype(np.uint8)


def _make_png(samples, bit_depth, color_type, filters=0, interlace=0, chunks=()):
    """A PNG of samples [h, w, channels] (any type and depth), every pass's
    rows filtered by ``filters``."""
    h, w = samples.shape[:2]
    ch = CHANNELS[color_type]
    bpp = max(1, ch * bit_depth // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    parts = []
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            rows = _pack(sub.reshape(sub.shape[0], -1), bit_depth)
            parts.append(png_filter(rows, bpp, filters).tobytes())
    return png_file(w, h, bit_depth, color_type, b"".join(parts), chunks, interlace)


def _cases():
    rng = np.random.default_rng(7)
    h, w = SHAPE
    cases = {}
    for bd in (1, 2, 4, 8, 16):
        cases[f"gray{bd}"] = (rng.integers(0, 1 << bd, (h, w, 1)), bd, 0, ())
    for bd in (8, 16):
        cases[f"rgb{bd}"] = (rng.integers(0, 1 << bd, (h, w, 3)), bd, 2, ())
        cases[f"gray_alpha{bd}"] = (rng.integers(0, 1 << bd, (h, w, 2)), bd, 4, ())
        cases[f"rgba{bd}"] = (rng.integers(0, 1 << bd, (h, w, 4)), bd, 6, ())
    cases["rgb8_trns"] = (rng.integers(0, 256, (h, w, 3)), 8, 2,
                          ((b"tRNS", struct.pack(">HHH", 1, 2, 3)),))
    cases["gray8_trns"] = (rng.integers(0, 256, (h, w, 1)), 8, 0, ((b"tRNS", b"\0\x05"),))
    for bd in (1, 2, 4, 8):
        n = 1 << bd
        plte = rng.integers(0, 256, (n, 3), dtype=np.uint8).tobytes()
        index = rng.integers(0, n, (h, w, 1))
        cases[f"palette{bd}"] = (index, bd, 3, ((b"PLTE", plte),))
        alpha = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        cases[f"palette{bd}_trns"] = (index, bd, 3, ((b"PLTE", plte), (b"tRNS", alpha)))
    return cases


CASES = _cases()


def _check_gray(path, data):
    """The port's luma against cv2's BGR through the reference's formula
    and against the reference's decoder; returns the luma."""
    with open(path, "wb") as f:
        f.write(data)
    gray_bytes, h, w = native.decode_gray_u8(data)
    gray = np.frombuffer(gray_bytes, np.uint8).reshape(h, w)
    bgr = cv2.imread(path, cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(gray, _luma(bgr))
    assert np.abs(gray.astype(int) - cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)).max() <= 1
    if j_native.native_available():
        ref_bytes, rh, rw = j_native._load().decode_gray_u8(data)
        assert (rh, rw) == (h, w) and ref_bytes == gray_bytes
    return gray


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("interlace", [0, 1])
def test_every_color_type_and_depth(name, interlace, tmp_path):
    samples, bd, color_type, chunks = CASES[name]
    data = _make_png(samples, bd, color_type, filters="cycle", interlace=interlace,
                     chunks=chunks)
    _check_gray(str(tmp_path / "image.png"), data)
    if (bd, color_type) != (16, 0):
        with pytest.raises(ValueError, match="not 16-bit single channel"):
            native.decode_depth_u16(data)


@pytest.mark.parametrize("shape", [(1, 1), (2, 3), (5, 1), (1, 9)])
def test_tiny_images_with_empty_adam7_passes(shape, tmp_path):
    rng = np.random.default_rng(9)
    for name in ("gray1", "gray16", "rgb8", "palette4_trns"):
        _, bd, color_type, chunks = CASES[name]
        samples = rng.integers(0, 1 << bd if color_type != 3 else 16,
                               shape + (CHANNELS[color_type],))
        for interlace in (0, 1):
            data = _make_png(samples, bd, color_type, filters="cycle", interlace=interlace,
                             chunks=chunks)
            _check_gray(str(tmp_path / "tiny.png"), data)


@pytest.mark.parametrize("filters", [0, 1, 2, 3, 4, "adaptive", "cycle"])
@pytest.mark.parametrize("interlace", [0, 1])
def test_each_filter_and_the_depth_path(filters, interlace, tmp_path):
    rng = np.random.default_rng(3)
    h, w = SHAPE
    depth = rng.integers(0, 65536, (h, w, 1))
    data = _make_png(depth, 16, 0, filters=filters, interlace=interlace)
    path = str(tmp_path / "depth.png")
    with open(path, "wb") as f:
        f.write(data)
    out, dh, dw = native.decode_depth_u16(data)
    got = np.frombuffer(out, np.uint16).reshape(dh, dw)
    np.testing.assert_array_equal(got, depth[..., 0])
    np.testing.assert_array_equal(got, cv2.imread(path, cv2.IMREAD_UNCHANGED))
    if j_native.native_available():
        assert j_native._load().decode_depth_u16(data) == (out, dh, dw)
    rgb = rng.integers(0, 256, (h, w, 3))
    _check_gray(str(tmp_path / "rgb.png"),
                _make_png(rgb, 8, 2, filters=filters, interlace=interlace))


def test_cv2_adaptive_files(tmp_path):
    """Files that cv2 (libpng's adaptive filters, its own zlib settings and
    IDAT sizes) writes decode bit-equal."""
    rng = np.random.default_rng(11)
    frame = np.clip(np.cumsum(rng.normal(0, 9, (96, 128, 3)), axis=1) % 256, 0, 255)
    bgr = frame.astype(np.uint8)
    depth = (np.cumsum(rng.integers(0, 40, (96, 128)), axis=0) % 60000).astype(np.uint16)
    for level in (1, 9):
        rgb_path, depth_path = str(tmp_path / "rgb.png"), str(tmp_path / "depth.png")
        cv2.imwrite(rgb_path, bgr, [cv2.IMWRITE_PNG_COMPRESSION, level])
        cv2.imwrite(depth_path, depth, [cv2.IMWRITE_PNG_COMPRESSION, level])
        with open(rgb_path, "rb") as f:
            np.testing.assert_array_equal(_check_gray(rgb_path, f.read()), _luma(bgr))
        g8, d16 = native.load_rgbd_raw(rgb_path, depth_path)
        np.testing.assert_array_equal(d16, depth)
        np.testing.assert_array_equal(g8, _luma(bgr))


@pytest.mark.parametrize("filters", [0, 1, 2, 3, 4, "adaptive", "cycle"])
def test_writer_round_trips(filters, tmp_path):
    rng = np.random.default_rng(5)
    arrays = {"gray": rng.integers(0, 256, (31, 45), dtype=np.uint8),
              "bgr": rng.integers(0, 256, (31, 45, 3), dtype=np.uint8),
              "depth": rng.integers(0, 65536, (31, 45), dtype=np.uint16)}
    for name, array in arrays.items():
        data = png_encode(array, filters)
        path = str(tmp_path / f"{name}.png")
        synthetic_tum._write_png(path, array, filters)
        with open(path, "rb") as f:
            assert f.read() == data
        np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), array)
        if name == "depth":
            out, h, w = native.decode_depth_u16(data)
            np.testing.assert_array_equal(np.frombuffer(out, np.uint16).reshape(h, w), array)
        else:
            gray = _check_gray(path, data)
            if name == "gray":
                np.testing.assert_array_equal(gray, array)
    # the writer's fixed and cycling choices
    rows = png_filter(arrays["bgr"].reshape(31, -1), 3, filters)
    want = {"adaptive": None, "cycle": np.arange(31) % 5}.get(filters, np.full(31, filters))
    if want is not None:
        np.testing.assert_array_equal(rows[:, 0], want)
    with pytest.raises(ValueError, match="cannot encode"):
        png_encode(np.zeros((4, 4), np.float32))


def _corrupt():
    rng = np.random.default_rng(2)
    good = _make_png(rng.integers(0, 256, (32, 48, 3)), 8, 2, filters="cycle")
    idat = good.index(b"IDAT")
    (length,) = struct.unpack(">I", good[idat - 4:idat])
    crc_at = idat + 4 + length
    bad_crc = good[:crc_at] + bytes([good[crc_at] ^ 1]) + good[crc_at + 1:]
    # a well-formed chunk around a cut zlib stream
    body = good[idat + 4:crc_at][: length // 2]
    short = good[:idat - 4] + struct.pack(">I", len(body)) + b"IDAT" + body + struct.pack(
        ">I", zlib.crc32(body, zlib.crc32(b"IDAT"))) + good[crc_at + 4:]
    # too little data: a stream that inflates to half the scanlines
    raw = zlib.decompress(good[idat + 4:crc_at])
    half = png_file(48, 32, 8, 2, raw[: len(raw) // 2])
    return {"garbage": b"not a png at all", "bad_crc": bad_crc, "truncated_idat": short,
            "not_enough_data": half, "cut_before_iend": good[: crc_at + 4],
            "cut_in_idat": good[: idat + 40], "empty": b""}


def test_corrupt_and_truncated_files_raise(tmp_path):
    for name, data in _corrupt().items():
        path = tmp_path / f"{name}.png"
        path.write_bytes(data)
        with pytest.raises(ValueError):
            native.decode_gray_u8(data)
        with pytest.raises(ValueError):
            native.load_rgbd_native(str(path), str(path))
        if j_native.native_available():
            with pytest.raises(ValueError):
                j_native._load().decode_gray_u8(data)


def test_depth_files_that_are_not_16_bit_gray_raise(tmp_path):
    rng = np.random.default_rng(4)
    files = {
        "gray8": png_encode(rng.integers(0, 256, (20, 30), dtype=np.uint8)),
        "rgb16": _make_png(rng.integers(0, 65536, (20, 30, 3)), 16, 2),
        "gray16_trns": _make_png(rng.integers(0, 65536, (20, 30, 1)), 16, 0,
                                 chunks=((b"tRNS", b"\x01\x02"),)),
        "gray_alpha16": _make_png(rng.integers(0, 65536, (20, 30, 2)), 16, 4),
    }
    for name, data in files.items():
        with pytest.raises(ValueError, match="depth PNG is not 16-bit single channel"):
            native.decode_depth_u16(data)
        if j_native.native_available():
            with pytest.raises(ValueError, match="depth PNG is not 16-bit single channel"):
                j_native._load().decode_depth_u16(data)


def test_the_extension_is_built_without_libpng():
    assert native.LIBS == ()
    assert native.build_error() is None, native.build_error()
    with open(native.SOURCE) as f:
        assert "png.h" not in f.read()
    with open(native.library_path(), "rb") as f:
        assert b"libpng" not in f.read()
    shape = (2, 96, 128)
    rng = np.random.default_rng(5)
    iu = rng.integers(0, 256, shape, dtype=np.uint8)
    du = rng.integers(0, 60000, shape, dtype=np.uint16)
    for levels in (1, 2, 3):
        i_out, d_out = streaming.host_reduce_ingest(iu, du, levels)
        assert streaming.host_reduce_ingest.last_path == "native"
        i_ref, d_ref = j_streaming.host_reduce_ingest(iu, du, levels)
        np.testing.assert_array_equal(i_out, i_ref)
        np.testing.assert_array_equal(d_out, d_ref)


def test_without_a_compiler_the_fallbacks_run_and_say_why(tmp_path, monkeypatch):
    """Where g++ is missing, ``build_error()`` names the failure, the
    reduction takes its NumPy form and the loader cv2, with the same
    results as the native paths."""
    rng = np.random.default_rng(6)
    iu = rng.integers(0, 256, (2, 32, 48), dtype=np.uint8)
    du = rng.integers(0, 60000, (2, 32, 48), dtype=np.uint16)
    rgb, dep = str(tmp_path / "rgb.png"), str(tmp_path / "depth.png")
    synthetic_tum._write_png(rgb, np.repeat(iu[0][..., None], 3, axis=-1))
    synthetic_tum._write_png(dep, du[0])
    want_reduced = streaming.host_reduce_ingest(iu, du, 1)
    want_loaded = dataset.load_tum_image_pair(rgb, dep)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_ext", None)
    monkeypatch.setattr(native, "_build_error", None)
    monkeypatch.setenv("PATH", str(tmp_path))  # no g++ on it
    assert not native.native_available()
    assert "g++" in native.build_error()
    reduced = streaming.host_reduce_ingest(iu, du, 1)
    assert streaming.host_reduce_ingest.last_path == "numpy"
    assert "g++" in streaming.host_reduce_ingest.last_reason
    for a, b in zip(reduced, want_reduced):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(dataset.load_tum_image_pair(rgb, dep), want_loaded):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(RuntimeError, match="native ingest unavailable"):
        native.decode_gray_u8(b"")


class _CapturingSLAM:
    """Stands in for either package's ``StreamingSLAM`` in its CLI: keeps
    the u16 depth the CLI hands it."""

    seen = []

    def __init__(self, *args, **kwargs):
        self.graph = self

    def track_sequence(self, iu8, du16, stamps):
        _CapturingSLAM.seen.append(du16.copy())
        self._stamps = np.asarray(stamps)
        return np.tile(np.eye(4), (len(stamps), 1, 1))

    def trajectory(self):
        return self._stamps, np.tile(np.eye(4), (len(self._stamps), 1, 1))

    def edge_errors(self):
        return np.zeros(0), np.zeros(0)

    def shutdown(self):
        pass


def test_depth_round_trip_defect_is_the_references(tmp_path, monkeypatch, capsys):
    """Every nonzero u16 value through ``TumDataset`` and the CLI's
    streaming conversion, in both packages: the same 4,580 values come
    back one unit (0.2 mm) low, e.g. 7 -> 6 and 14 -> 13."""
    raw = np.arange(65536, dtype=np.uint32).reshape(256, 256).astype(np.uint16)
    root = tmp_path / "seq"
    synthetic_tum.write_tum_frames(str(root), np.zeros((2, 256, 256), np.uint8),
                                   np.stack([raw, raw]), np.tile(np.eye(4), (2, 1, 1)),
                                   Intrinsics(200.0, 200.0, 127.5, 127.5))
    os.remove(root / "groundtruth.txt")
    _CapturingSLAM.seen = []
    monkeypatch.setattr(streaming, "StreamingSLAM", _CapturingSLAM)
    monkeypatch.setattr(j_streaming, "StreamingSLAM", _CapturingSLAM)
    args = ["--dataset", str(root), "--engine", "streaming", "--output-dir", str(tmp_path)]
    assert cli.main(args + ["--device", "cpu"]) == 0
    assert j_cli.main(args) == 0
    capsys.readouterr()
    port, ref = _CapturingSLAM.seen
    np.testing.assert_array_equal(port, ref)
    low = port[0] != raw
    assert int(low.sum()) == 4580
    np.testing.assert_array_equal(port[0][low], raw[low] - 1)
    assert port[0][0, 7] == 6 and port[0][0, 14] == 13 and port[0][0, 0] == 0
    np.testing.assert_array_equal(recorded_sequence.roundtrip_u16(raw), port[0])


def test_recorded_sequence_tool_on_the_cpu(tmp_path):
    """``tools/recorded_sequence``'s steps at 4 frames of 30x40: the written
    directory decodes back bit for bit (serially and prefetched), the
    reduction takes the native path, the odometry engine's report and its
    solves' steps."""
    poses = synthetic.circular_trajectory(4, radius=0.02, rot_amplitude=0.01)
    iu8, du16 = render_sequence(poses, (30, 40), Intrinsics(40.0, 40.0, 19.5, 14.5))
    root = str(tmp_path / "rgbd_dataset_fr1_tiny")
    written = recorded_sequence.write_sequence(root, iu8, du16, poses, filters="cycle",
                                               workers=2)
    assert written["bytes"] > 0
    assert recorded_sequence.check_decode(root, iu8, du16)["frames"] == 4
    reduce = recorded_sequence.time_reduction(iu8, du16, 1, reps=1)
    assert reduce["path"] == "native"
    run = recorded_sequence.run_engine(root, "odometry", str(tmp_path / "out"), device="cpu",
                                       timing=False)
    assert run["rc"] == 0 and run["report"]["frames"] == 4 and not run["fallbacks"]
    assert run["one_steps"] == run["one_iterations"] > 0 and run["batched_steps"] == 0
