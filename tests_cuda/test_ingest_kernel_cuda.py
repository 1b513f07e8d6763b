"""Ingest on the card (``ops/ingest``, ``csrc/ingest.cu``): ``Frame.from_raw``'s
kernel route against the plain chain on the card (``convert_raw_depth`` ->
``build_pyramid`` -> ``prepare_frame``), bit for bit.

* Every field of every level, ``sel``, ``refpack`` and ``quad`` (or, on the
  modular backend, ``accel``) equal in their bits on: the two benchmark
  cells' rendered frames, random u8/u16 with holes, all-zero depth, depth
  steps just either side of the 0.3 m derivative gate at every level along
  rows and columns, raw depth 65535, odd sizes (639x479, 161x121), int32
  depth already on the card, intensity on the card with depth on the host,
  and selection thresholds above zero.
* One launch of each kernel a prepared frame, one of kernel A alone
  without ``prepare_for``; ``prepare_frame`` never runs on this route.
* A raw frame the kernels do not take (int64 or float depth, a stack of
  frames) raises ValueError on the card.
* Three frames ingested back to back behind a spinning stream, no
  synchronise in between, each frame's tensors right after the others
  were uploaded.
* Two threads ingesting at once.
* ``BatchedMatcher.evict`` and ``ref_artifacts`` free the quad arena:
  ``torch.cuda.memory_allocated`` drops by its size.
* A rig's B frames in one call (``frames.ingest_raw`` with ``streams``):
  at 640x480, B = 1, 2 and 8, with and without the levels below the solve
  range, every tensor of every stream bit-equal to the plain chain over the
  stacked frames and to the stream's own ``Frame.from_raw``, with one
  launch of each kernel; a time slice of a [B, T, H, W] int32 sequence on
  the card and a stacked host array; the rig cell's eight streams.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from dvo_slam_tpu_torch import benchmark_config
from dvo_slam_tpu_torch.config import InfluenceFunction, ScaleEstimator
from dvo_slam_tpu_torch.models.dense_tracker import prepare_frame, ref_artifacts
from dvo_slam_tpu_torch.models.frames import BatchedMatcher, Frame
from dvo_slam_tpu_torch.ops import ingest
from dvo_slam_tpu_torch.ops.camera import TUM_FR1, Intrinsics
from dvo_slam_tpu_torch.ops.pyramid import build_pyramid, convert_raw_depth
from slam_bench import manifest, program, traffic

pytestmark = pytest.mark.cuda

CFG = benchmark_config().tracker  # levels 3..1, the fused path
MODULAR = dataclasses.replace(CFG, influence_function=InfluenceFunction.HUBER,
                              scale_estimator=ScaleEstimator.MAD)
THRESHOLDS = dataclasses.replace(CFG, intensity_derivative_threshold=2.0,
                                 depth_derivative_threshold=0.01)
GATE_RAW = 3000  # raw depth units across two pixels at the 0.3 m gate


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _plain(iu, du, cfg, K, num_levels=None):
    """The plain chain on the card, the kernels' oracle."""
    dev = torch.device("cuda")
    depth, valid = convert_raw_depth(torch.as_tensor(du).to(dev))
    levels = build_pyramid(torch.as_tensor(iu).to(dev).to(torch.float32), depth, valid,
                           num_levels or cfg.num_levels)
    return levels, prepare_frame(cfg, K, levels)


def _assert_same(frame: Frame, cfg, K, iu, du):
    levels, prepared = _plain(iu, du, cfg, K, len(frame.levels))
    mine = frame.__dict__["_prepared"][(cfg, K)]
    for k, (a, b) in enumerate(zip(frame.levels, levels)):
        for name, x, y in zip(a._fields, a, b):
            assert x.shape == y.shape and x.dtype == y.dtype, (k, name)
            assert torch.equal(_bits(x), _bits(y)), (k, name)
    for field in prepared._fields:
        for k, (x, y) in enumerate(zip(getattr(mine, field), getattr(prepared, field))):
            assert (x is None) == (y is None), (field, k)
            if x is not None:
                assert x.shape == y.shape and x.dtype == y.dtype, (field, k)
                assert torch.equal(_bits(x), _bits(y)), (field, k)


def _ingest(iu, du, cfg=CFG, K=TUM_FR1, num_levels=None):
    return Frame.from_raw(iu, du, 0.0, num_levels or cfg.num_levels, prepare_for=(cfg, K),
                          device="cuda")


def _random(shape, seed, holes=0.2):
    rng = np.random.default_rng(seed)
    iu = rng.integers(0, 256, shape, dtype=np.uint8)
    du = rng.integers(1, 65536, shape).astype(np.uint16)
    du[rng.random(shape) < holes] = 0
    return iu, du


def _gate_steps(shape, along_rows: bool):
    """Depth whose central differences at level l straddle the 0.3 m gate
    along the rows (or the columns): bands of rows, each with its level,
    step (GATE_RAW - 2 .. + 2 raw units) and base depth."""
    h, w = shape
    du = np.zeros(shape, np.uint16)
    coord = np.arange(w if along_rows else h)
    bands = [(level, step, base) for level in range(4) for step in range(GATE_RAW - 2, GATE_RAW + 3)
             for base in (4000, 9000, 20000)]
    size = (h if along_rows else w) // len(bands)
    for b, (level, step, base) in enumerate(bands):
        line = base + step * ((coord >> (level + 1)) % 2)
        if along_rows:
            du[b * size:(b + 1) * size] = line[None, :]
        else:
            du[:, b * size:(b + 1) * size] = line[:, None]
    iu = (np.add.outer(np.arange(h), 3 * np.arange(w)) % 256).astype(np.uint8)
    return iu, du


def _cell_frames(name, count=3):
    cell = manifest.cell(name)
    rec = traffic.make_recording(cell.config, count, 2**31 + 11, torch.device("cuda"))
    return program.tracker_config(cell.config), program.intrinsics(cell.config), rec


@pytest.mark.parametrize("name", ["fr1_desk_odometry.recorded", "fr3_office_slam.recorded"])
def test_the_cells_frames_bit_equal(name):
    cfg, K, rec = _cell_frames(name)
    for iu, du in zip(rec.intensity, rec.depth):
        _assert_same(_ingest(iu, du, cfg, K), cfg, K, iu, du)


@pytest.mark.parametrize("shape", [(480, 640), (479, 639), (121, 161)])
@pytest.mark.parametrize("cfg", [CFG, MODULAR, THRESHOLDS], ids=["fused", "modular", "thresholds"])
def test_random_frames_bit_equal(shape, cfg):
    iu, du = _random(shape, seed=shape[0] + 7)
    _assert_same(_ingest(iu, du, cfg), cfg, TUM_FR1, iu, du)


@pytest.mark.parametrize("along_rows", [True, False])
def test_the_derivative_gate_at_every_level(along_rows):
    iu, du = _gate_steps((480, 640), along_rows)
    _assert_same(_ingest(iu, du), CFG, TUM_FR1, iu, du)
    # the gate does cut: both sides of it show at every level
    levels, _ = _plain(iu, du, CFG, TUM_FR1)
    for level in levels:
        d = level.zdx if along_rows else level.zdy
        assert bool((d.abs() > 0.29).any()) and bool(((d == 0) & level.valid).any())


def test_zero_depth_full_depth_and_a_deep_pyramid():
    shape = (480, 640)
    iu, _ = _random(shape, seed=3)
    for du in (np.zeros(shape, np.uint16), np.full(shape, 65535, np.uint16)):
        _assert_same(_ingest(iu, du), CFG, TUM_FR1, iu, du)
    iu, du = _random(shape, seed=4, holes=0.05)
    du[::3] = 65535
    deep = dataclasses.replace(CFG, first_level=6, last_level=2)
    K = Intrinsics(300.0, 310.0, 320.5, 240.5)
    _assert_same(_ingest(iu, du, deep, K), deep, K, iu, du)


def test_int32_depth_already_on_the_card():
    iu, du = _random((480, 640), seed=5)
    d_i = torch.from_numpy(iu).cuda()
    d_d = torch.from_numpy(du.astype(np.int32)).cuda()
    frame = Frame.from_raw(d_i, d_d, 0.0, CFG.num_levels, prepare_for=(CFG, TUM_FR1),
                           device="cuda")
    _assert_same(frame, CFG, TUM_FR1, iu, du)


def test_intensity_on_the_card_depth_on_the_host():
    iu, du = _random((480, 640), seed=7)
    frame = _ingest(torch.from_numpy(iu).cuda(), du)
    _assert_same(frame, CFG, TUM_FR1, iu, du)


@pytest.mark.parametrize("kind", ["int64_depth", "float_depth", "stack"])
def test_raw_frames_the_kernels_do_not_take_raise(kind):
    iu, du = _random((120, 160), seed=8)
    launches = ingest.ingest_cuda.pyramid_launches
    if kind == "int64_depth":
        du = du.astype(np.int64)
    elif kind == "float_depth":
        du = du.astype(np.float32) / 5000
    else:
        iu, du = iu[None], du[None]
    with pytest.raises(ValueError, match="the kernels take"):
        _ingest(iu, du)
    assert ingest.ingest_cuda.pyramid_launches == launches


def test_launch_counts():
    iu, du = _random((480, 640), seed=6)
    counts = ingest.ingest_cuda
    a, b = counts.pyramid_launches, counts.pack_launches
    calls = prepare_frame.calls
    _ingest(iu, du)
    assert (counts.pyramid_launches - a, counts.pack_launches - b) == (1, 1)
    assert prepare_frame.calls == calls
    Frame.from_raw(iu, du, 0.0, 4, device="cuda")
    assert (counts.pyramid_launches - a, counts.pack_launches - b) == (2, 1)


def test_back_to_back_behind_a_busy_stream():
    frames = [_random((480, 640), seed=10 + k) for k in range(3)]
    _ingest(*frames[0])
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # the stream spins while the host uploads
    made = [_ingest(iu, du) for iu, du in frames]
    for frame, (iu, du) in zip(made, frames):
        _assert_same(frame, CFG, TUM_FR1, iu, du)


def test_two_threads_ingest_at_once():
    frames = [_random((240, 320), seed=20 + k) for k in range(12)]
    out = [None] * len(frames)
    errors = []

    def work(part):
        try:
            stream = torch.cuda.Stream()
            with torch.cuda.stream(stream):
                for k in part:
                    out[k] = _ingest(*frames[k])
            stream.synchronize()
        except Exception as exc:  # noqa: BLE001 - reported by the test
            errors.append(exc)

    threads = [threading.Thread(target=work, args=(range(j, len(frames), 2),)) for j in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []
    for frame, (iu, du) in zip(out, frames):
        _assert_same(frame, CFG, TUM_FR1, iu, du)


def test_evict_and_ref_artifacts_free_the_quad_arena():
    iu, du = _random((480, 640), seed=30)
    layout = ingest.arena_layout((480, 640), CFG.num_levels, (CFG.last_level, CFG.first_level),
                                 True)
    matcher = BatchedMatcher(CFG, TUM_FR1)
    frame = _ingest(iu, du)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    matcher.evict(frame)
    assert before - torch.cuda.memory_allocated() == layout.cur_bytes
    assert frame.levels[CFG.first_level].intensity.is_cuda  # the reference arena stays

    frame = _ingest(iu, du)
    key = (CFG, TUM_FR1)
    kept = ref_artifacts(frame.__dict__["_prepared"][key])
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    del frame.__dict__["_prepared"][key]
    assert before - torch.cuda.memory_allocated() == layout.cur_bytes
    assert kept.refpack[CFG.first_level].is_cuda and kept.quad[CFG.first_level] is None


# ---------------------------------------------------------------------------
# a rig's B frames in one upload and one launch of each kernel


def _rig_plain(iu, du, cfg, K, skip_below=0):
    """The plain chain on the card over the rig's stacked frames [B, H, W]."""
    dev = torch.device("cuda")
    depth, valid = convert_raw_depth(torch.as_tensor(np.stack(du)).to(dev))
    levels = build_pyramid(torch.as_tensor(np.stack(iu)).to(dev).to(torch.float32), depth, valid,
                           cfg.num_levels, skip_below=skip_below)
    return levels, prepare_frame(cfg, K, levels)


def _assert_rig_same(got, want):
    (levels, prepared), (plain_levels, plain_prepared) = got, want
    for k, (a, b) in enumerate(zip(levels, plain_levels)):
        assert (a is None) == (b is None), k
        if a is not None:
            for name, x, y in zip(a._fields, a, b):
                assert x.shape == y.shape and x.dtype == y.dtype, (k, name)
                assert torch.equal(_bits(x), _bits(y)), (k, name)
    for field in plain_prepared._fields:
        for k, (x, y) in enumerate(zip(getattr(prepared, field), getattr(plain_prepared, field))):
            assert (x is None) == (y is None), (field, k)
            if x is not None:
                assert x.shape == y.shape and x.dtype == y.dtype, (field, k)
                assert torch.equal(_bits(x), _bits(y)), (field, k)


@pytest.mark.parametrize("streams", [1, 2, 8])
@pytest.mark.parametrize("skip_below", [0, CFG.last_level])
def test_a_rig_bit_equal_to_the_plain_chain_and_to_one_frame(streams, skip_below):
    """Every tensor of every stream of a rig ingested in one call equals the
    plain chain over the stacked frames and each stream's own one-frame
    ingest (``Frame.from_raw``), at 640x480; one launch of each kernel a
    rig frame."""
    from dvo_slam_tpu_torch.models.frames import ingest_raw

    frames = [_random((480, 640), seed=40 + b) for b in range(streams)]
    iu, du = [f[0] for f in frames], [f[1] for f in frames]
    counts = ingest.ingest_cuda
    a, b = counts.pyramid_launches, counts.pack_launches
    got = ingest_raw(iu, du, CFG.num_levels, (CFG, TUM_FR1), torch.device("cuda"), streams,
                     skip_below)
    assert (counts.pyramid_launches - a, counts.pack_launches - b) == (1, 1)
    _assert_rig_same(got, _rig_plain(iu, du, CFG, TUM_FR1, skip_below))
    levels, prepared = got
    for s in range(streams):
        one = _ingest(iu[s], du[s])
        mine = one.__dict__["_prepared"][(CFG, TUM_FR1)]
        for k in range(skip_below, CFG.num_levels):
            for x, y in zip(levels[k], one.levels[k]):
                assert torch.equal(_bits(x[s]), _bits(y)), (s, k)
        for field in ("sel", "refpack", "quad"):
            for k, (x, y) in enumerate(zip(getattr(prepared, field), getattr(mine, field))):
                if x is not None:
                    assert torch.equal(_bits(x[s]), _bits(y)), (s, field, k)


@pytest.mark.parametrize("cfg", [CFG, MODULAR], ids=["fused", "modular"])
def test_a_rig_from_a_sequence_on_the_card(cfg):
    """A time slice of [B, T, H, W] int32 depth on the card (its frames lie
    T frames apart) and a stacked host array [B, H, W] give the plain
    chain's bits."""
    from dvo_slam_tpu_torch.models.frames import ingest_raw

    frames = [[_random((480, 640), seed=60 + 3 * b + t) for t in range(3)] for b in range(3)]
    iu = np.stack([[f[0] for f in row] for row in frames])
    du = np.stack([[f[1] for f in row] for row in frames])
    d_i, d_d = torch.from_numpy(iu).cuda(), torch.from_numpy(du.astype(np.int32)).cuda()
    for t in range(3):
        got = ingest_raw(d_i[:, t], d_d[:, t], cfg.num_levels, (cfg, TUM_FR1),
                         torch.device("cuda"), 3, cfg.last_level)
        want = _rig_plain(list(iu[:, t]), list(du[:, t]), cfg, TUM_FR1, cfg.last_level)
        _assert_rig_same(got, want)
    got = ingest_raw(iu[:, 1], du[:, 1], cfg.num_levels, (cfg, TUM_FR1), torch.device("cuda"), 3)
    _assert_rig_same(got, _rig_plain(list(iu[:, 1]), list(du[:, 1]), cfg, TUM_FR1))


def test_the_rig_cells_frames_bit_equal():
    """The rig cell's eight streams at one instant, through the entry's
    route, equal the plain chain stream by stream."""
    from dvo_slam_tpu_torch.models.frames import ingest_raw

    cell = manifest.cell("rig8_lockstep.recorded")
    entry = manifest.entry(cell.config["entry"])
    cfg, K = program.tracker_config(cell.config), program.intrinsics(cell.config)
    rec = traffic.make_recording(cell.config, 3, 2**31 + 13, torch.device("cuda"))
    recs = entry.rig(cell.config, rec, torch.device("cuda"))
    iu, du = [r.intensity[2] for r in recs], [r.depth[2] for r in recs]
    got = ingest_raw(iu, du, cfg.num_levels, (cfg, K), torch.device("cuda"), len(recs),
                     cfg.last_level)
    _assert_rig_same(got, _rig_plain(iu, du, cfg, K, cfg.last_level))
