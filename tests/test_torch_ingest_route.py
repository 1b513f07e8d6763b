"""Ingest's kernel route as far as the CPU reaches it (``ops/ingest``,
``models/frames.Frame.from_raw``).

* The arena layout: every view on an ``ALIGN`` boundary, no two views
  overlapping, the arenas' sizes, the views' shapes and dtypes, at 640x480
  with 4 levels, at odd sizes, with a level of no pixels and at 8 levels.
* The views of two CPU arenas: each where the layout puts it (each filled
  with its own value and read back), ``sel`` and ``refpack`` never in the
  quad tables' storage.
* The kernels' argument blocks: every pixel in a block, coarse levels
  first, the intrinsics as the plain chain's float32 scalars.
* Which raw frames the kernels take (``check_raw``).
* On the CPU ``from_raw`` takes the plain chain, bit-equal to
  ``build_pyramid`` + ``prepare_frame``, with its three spans.
* The route's wiring with the two kernels played on the CPU by the plain
  chain (the card's own tests hold the kernels to it): the arenas and their
  views, the prepared artifacts on the fused and the modular backend, the
  two spans, one kernel call and no ``prepare_frame`` call; a raw frame the
  kernels do not take raises before any kernel runs.
"""

import dataclasses

import numpy as np
import pytest
import torch

from dvo_slam_tpu_torch.config import InfluenceFunction, ScaleEstimator, TrackerConfig
from dvo_slam_tpu_torch.models import frames as t_frames
from dvo_slam_tpu_torch.models.dense_tracker import _build_refpack, prepare_frame
from dvo_slam_tpu_torch.ops import ingest
from dvo_slam_tpu_torch.ops.camera import TUM_FR1, Intrinsics
from dvo_slam_tpu_torch.ops.interp import build_quad_table_cm
from dvo_slam_tpu_torch.ops.pyramid import (
    PyramidLevel, build_acceleration_cm, build_pyramid, convert_raw_depth, selection_mask)
from dvo_slam_tpu_torch.utils import timers

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

CFG = TrackerConfig(first_level=2, last_level=1, max_iterations_per_level=10)
MODULAR = dataclasses.replace(CFG, influence_function=InfluenceFunction.HUBER,
                              scale_estimator=ScaleEstimator.MAD)
K = Intrinsics(80.0, 81.0, 39.5, 29.5)

LAYOUTS = [
    ((480, 640), 4, (1, 3), True),
    ((479, 639), 4, (1, 3), True),
    ((121, 161), 4, (0, 3), False),
    ((7, 5), 4, (1, 3), True),  # level 3 has no pixels
    ((480, 640), 4, None, False),
    ((480, 640), 8, (2, 7), True),
]


@pytest.fixture(autouse=True)
def _recorder_off():
    timers.disable()
    yield
    timers.disable()


def _raw(shape=(60, 80), seed=0, holes=0.2):
    rng = np.random.default_rng(seed)
    iu = rng.integers(0, 256, shape, dtype=np.uint8)
    du = rng.integers(2000, 12000, shape).astype(np.uint16)
    du[rng.random(shape) < holes] = 0
    return iu, du


def _expected_views(shape, num_levels, solve, quad):
    """(name, level) -> (arena, shape, dtype), written out from the layout's
    definition."""
    out = {}
    for level in range(num_levels):
        hw = (shape[0] >> level, shape[1] >> level)
        for name in PyramidLevel._fields:
            out[(name, level)] = ("ref", hw, torch.bool if name in ("valid", "zvalid")
                                  else torch.float32)
    if solve is not None:
        for level in range(solve[0], solve[1] + 1):
            hw = (shape[0] >> level, shape[1] >> level)
            out[("sel", level)] = ("ref", hw, torch.bool)
            out[("refpack", level)] = ("ref", (8, hw[0] * hw[1]), torch.float32)
            if quad:
                out[("quad", level)] = ("cur", (32, hw[0] * hw[1]), torch.float32)
    return out


@pytest.mark.parametrize("shape,num_levels,solve,quad", LAYOUTS)
def test_the_arena_layout(shape, num_levels, solve, quad):
    layout = ingest.arena_layout(shape, num_levels, solve, quad)
    expected = _expected_views(shape, num_levels, solve, quad)
    assert {k: (v.arena, v.shape, v.dtype) for k, v in layout.views.items()} == expected
    assert layout.quad == (quad and solve is not None)
    for arena, size in (("ref", layout.ref_bytes), ("cur", layout.cur_bytes)):
        views = sorted((v for v in layout.views.values() if v.arena == arena),
                       key=lambda v: v.offset)
        assert size % ingest.ALIGN == 0
        end = 0
        for v in views:
            assert v.offset % ingest.ALIGN == 0 and v.offset >= end
            end = v.offset + v.nbytes
        assert end <= size < end + ingest.ALIGN
    if shape == (480, 640) and num_levels == 4 and solve is not None:
        pixels = sum((480 >> k) * (640 >> k) for k in range(4))
        solve_pixels = sum((480 >> k) * (640 >> k) for k in range(1, 4))
        # 26 bytes a pixel of the levels, 33 of sel and refpack, 128 of quad, each view
        # padded to the next ALIGN boundary
        padding = layout.ref_bytes - (26 * pixels + 33 * solve_pixels)
        assert 0 <= padding < ingest.ALIGN * len(layout.views)
        assert layout.cur_bytes == 128 * solve_pixels
    assert ingest.arena_layout(shape, num_levels, solve, quad) is layout


def test_the_layout_refuses_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="num_levels"):
        ingest.arena_layout((48, 64), ingest.MAX_LEVELS + 1)
    with pytest.raises(ValueError, match="solve range"):
        ingest.arena_layout((48, 64), 3, (1, 3), True)


@pytest.mark.parametrize("shape,num_levels,solve,quad", LAYOUTS)
def test_the_views_of_cpu_arenas(shape, num_levels, solve, quad):
    layout = ingest.arena_layout(shape, num_levels, solve, quad)
    ref, cur = ingest.new_arenas(layout, "cpu")
    assert ref.numel() * 4 == layout.ref_bytes
    assert (cur is None) == (layout.cur_bytes == 0)
    levels, sel, refpack, quads = ingest.arena_views(layout, ref, cur)
    views = {(name, k): t for k, lv in enumerate(levels) for name, t in zip(lv._fields, lv)}
    for name, tables in (("sel", sel), ("refpack", refpack), ("quad", quads)):
        assert len(tables) == num_levels
        views.update({(name, k): t for k, t in enumerate(tables) if t is not None})
    assert set(views) == set(layout.views)
    for key, t in views.items():
        v = layout.views[key]
        assert (tuple(t.shape), t.dtype) == (v.shape, v.dtype) and t.is_contiguous()
        base = ref if v.arena == "ref" else cur
        if t.numel():
            assert t.untyped_storage().data_ptr() == base.untyped_storage().data_ptr()
            assert t.data_ptr() - base.data_ptr() == v.offset
    # each view holds its own value after all were written: none overlaps another
    for j, t in enumerate(views.values()):
        t.fill_(j % 2 == 1 if t.dtype == torch.bool else float(j))
    for j, t in enumerate(views.values()):
        if t.numel():
            assert bool((t == (j % 2 == 1 if t.dtype == torch.bool else float(j))).all())
    for tables in (sel, refpack):
        for t in tables:
            for q in quads:
                if t is not None and q is not None:
                    assert t.untyped_storage().data_ptr() != q.untyped_storage().data_ptr()


def test_the_argument_blocks():
    layout = ingest.arena_layout((479, 639), 4, (1, 3), True)
    a = ingest.pyramid_args(layout)
    assert a.levels == 4 and a.block_start[3] == 0
    for level in range(4):
        h, w = 479 >> level, 639 >> level
        assert (a.h[level], a.w[level]) == (h, w)
        assert a.tiles_x[level] * ingest.TILE[1] >= w
        assert a.blocks[level] * ingest.TILE[0] * ingest.TILE[1] >= h * w
        if level:
            assert a.block_start[level - 1] == a.block_start[level] + a.blocks[level]
        for k, name in enumerate(ingest.KERNEL_FIELDS):
            assert a.field[level][k] == layout.views[(name, level)].offset
    assert ingest.pyramid_args(layout) is a
    p = ingest.pack_args(layout, TUM_FR1, 2.0, 0.01)
    assert (p.last, p.first, p.write_quad, p.block_start[3]) == (1, 3, 1, 0)
    for level in range(1, 4):
        kl = TUM_FR1.at_level(level)
        assert p.blocks[level] * ingest.PACK_THREADS >= p.h[level] * p.w[level]
        assert p.inv_fx[level] == np.float32(1.0 / kl.fx)  # as PyTorch's CUDA division
        assert p.oy[level] == np.float32(kl.oy)
        assert p.quad[level] == layout.views[("quad", level)].offset
    assert p.intensity_threshold == np.float32(2.0) and p.depth_threshold == np.float32(0.01)


def _case(name):
    iu, du = _raw()
    return {
        "u16": (iu, du), "int32": (iu, du.astype(np.int32)),
        "float_intensity": (iu.astype(np.float32), du), "int64_depth": (iu, du.astype(np.int64)),
        "float_depth": (iu, du.astype(np.float32) / 5000), "shapes_differ": (iu, du[:, :-1]),
        "stack": (iu[None], du[None]), "int8_intensity": (iu.view(np.int8), du),
    }[name]


@pytest.mark.parametrize("name,taken", [
    ("u16", True), ("int32", True), ("float_intensity", False), ("int64_depth", False),
    ("float_depth", False), ("shapes_differ", False), ("stack", False),
    ("int8_intensity", False)])
def test_which_frames_the_kernels_take(name, taken):
    iu, du = (torch.from_numpy(a) for a in _case(name))
    if taken:
        ingest.check_raw(iu, du)
    else:
        with pytest.raises(ValueError, match="the kernels take"):
            ingest.check_raw(iu, du)


def test_from_raw_on_the_cpu_is_the_plain_chain():
    iu, du = _raw(seed=1)
    launches = ingest.ingest_cuda.pyramid_launches, ingest.ingest_cuda.pack_launches
    timers.enable("cpu")
    frame = t_frames.Frame.from_raw(iu, du, 0.0, CFG.num_levels, prepare_for=(CFG, K),
                                    device="cpu")
    names = {s.name for s in timers.drain() if s.frame == frame.frame_id}
    assert names == {"dvo.ingest", "dvo.ingest.upload", "dvo.ingest.pyramid",
                     "dvo.ingest.prepare"}
    assert (ingest.ingest_cuda.pyramid_launches, ingest.ingest_cuda.pack_launches) == launches
    depth, valid = convert_raw_depth(torch.from_numpy(du))
    levels = build_pyramid(torch.from_numpy(iu).to(torch.float32), depth, valid, CFG.num_levels)
    prepared = prepare_frame(CFG, K, levels)
    _assert_bits(frame, levels, prepared, (CFG, K))


def _assert_bits(frame, levels, prepared, key):
    for a, b in zip(frame.levels, levels):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and torch.equal(x, y)
    mine = frame.__dict__["_prepared"][key]
    for field in prepared._fields:
        for x, y in zip(getattr(mine, field), getattr(prepared, field)):
            assert (x is None) == (y is None)
            if x is not None:
                assert x.dtype == y.dtype and torch.equal(x, y)


def _played_kernels(monkeypatch, cfg, intrinsics):
    """The route's two kernels played on the CPU by the plain chain; returns
    the list of the played calls (True where kernel B ran)."""
    played = []

    def play(raw_i, raw_d, layout, ref, cur=None, pack=None):
        played.append(pack is not None)
        depth, valid = convert_raw_depth(raw_d)
        plain = build_pyramid(raw_i.to(torch.float32), depth, valid, layout.num_levels)
        levels, sel, refpack, quad = ingest.arena_views(layout, ref, cur)
        for src, dst in zip(plain, levels):
            for a, b in zip(src, dst):
                b.copy_(a)
        if pack is None:
            return
        for level in range(layout.solve[0], layout.solve[1] + 1):
            lv = levels[level]
            sel[level].copy_(selection_mask(lv, cfg.intensity_derivative_threshold,
                                            cfg.depth_derivative_threshold))
            refpack[level].copy_(_build_refpack(lv, sel[level], intrinsics.at_level(level)))
            if layout.quad:
                quad[level].copy_(build_quad_table_cm(build_acceleration_cm(lv),
                                                      lv.intensity.shape[-1]))

    monkeypatch.setattr(ingest, "ingest_cuda", play)
    return played


@pytest.mark.parametrize("cfg", [CFG, MODULAR], ids=["fused", "modular"])
@pytest.mark.parametrize("depth_dtype", [np.uint16, np.int32])
def test_the_route_with_the_kernels_played_on_the_cpu(monkeypatch, cfg, depth_dtype):
    iu, du = _raw((61, 83), seed=2)
    played = _played_kernels(monkeypatch, cfg, K)
    calls = prepare_frame.calls
    timers.enable("cpu")
    with timers.span("dvo.ingest", frame=10 ** 9):
        levels, prepared = t_frames._ingest_kernels(iu, du.astype(depth_dtype), cfg.num_levels,
                                                    (cfg, K), torch.device("cpu"))
    names = [s.name for s in timers.drain()]
    assert sorted(names) == ["dvo.ingest", "dvo.ingest.kernel", "dvo.ingest.stage"]
    assert played == [True] and prepare_frame.calls == calls
    frame = t_frames.Frame(levels=levels, timestamp=0.0)
    frame.__dict__["_prepared"] = {(cfg, K): prepared}
    depth, valid = convert_raw_depth(torch.from_numpy(du))
    plain = build_pyramid(torch.from_numpy(iu).to(torch.float32), depth, valid, cfg.num_levels)
    _assert_bits(frame, plain, prepare_frame(cfg, K, plain), (cfg, K))
    modular = cfg is MODULAR
    assert all((q is None) == (modular or not cfg.last_level <= k <= cfg.first_level)
               for k, q in enumerate(prepared.quad))
    assert all((a is None) == (not modular or not cfg.last_level <= k <= cfg.first_level)
               for k, a in enumerate(prepared.accel))


def test_the_route_without_prepare_for(monkeypatch):
    iu, du = _raw(seed=3)
    played = _played_kernels(monkeypatch, CFG, K)
    calls = prepare_frame.calls
    levels, prepared = t_frames._ingest_kernels(iu, du, 3, None, torch.device("cpu"))
    assert prepared is None and prepare_frame.calls == calls and len(levels) == 3
    assert played == [False]
    depth, valid = convert_raw_depth(torch.from_numpy(du))
    plain = build_pyramid(torch.from_numpy(iu).to(torch.float32), depth, valid, 3)
    for a, b in zip(levels, plain):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


@pytest.mark.parametrize("name", ["int64_depth", "float_intensity", "stack"])
def test_the_route_refuses_what_the_kernels_do_not_take(monkeypatch, name):
    """A raw frame the kernels do not take raises ValueError on the card's
    route, before any kernel runs: there is no other route there."""
    played = _played_kernels(monkeypatch, CFG, K)
    iu, du = _case(name)
    with pytest.raises(ValueError, match="the kernels take"):
        t_frames._ingest_kernels(iu, du, CFG.num_levels, (CFG, K), torch.device("cpu"))
    assert played == []


# ---------------------------------------------------------------------------
# a rig's B frames: [B, ...] arenas, levels below the solve range skipped


@pytest.mark.parametrize("batch,skip", [(1, 0), (3, 1), (8, 1), (2, 2)])
def test_the_rig_arena_layout(batch, skip):
    shape, solve = (480, 640), (max(skip, 1), 3)
    one = ingest.arena_layout(shape, 4, solve, True)
    layout = ingest.arena_layout(shape, 4, solve, True, batch, skip)
    assert (layout.batch, layout.skip) == (batch, skip)
    assert set(layout.views) == {k for k in one.views if k[1] >= skip}
    for key, v in layout.views.items():
        assert v.shape == (batch,) + one.views[key].shape and v.dtype == one.views[key].dtype
        assert v.offset % ingest.ALIGN == 0
    for arena, size in (("ref", layout.ref_bytes), ("cur", layout.cur_bytes)):
        views = sorted((v for v in layout.views.values() if v.arena == arena),
                       key=lambda v: v.offset)
        end = 0
        for v in views:
            assert v.offset >= end
            end = v.offset + v.nbytes
        assert end <= size < end + ingest.ALIGN
    ref, cur = ingest.new_arenas(layout, "cpu")
    levels, sel, refpack, quad = ingest.arena_views(layout, ref, cur)
    assert all((lv is None) == (k < skip) for k, lv in enumerate(levels))
    for k in range(solve[0], 4):
        assert refpack[k].shape == (batch, 8, (480 >> k) * (640 >> k)) and refpack[k].is_contiguous()
        assert quad[k].shape == (batch, 32, (480 >> k) * (640 >> k)) and quad[k].is_contiguous()
        assert sel[k].shape == (batch, 480 >> k, 640 >> k)
    a = ingest.pyramid_args(layout)
    assert [a.blocks[k] == 0 for k in range(4)] == [k < skip for k in range(4)]


def test_the_rig_layout_refuses_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="skip_below"):
        ingest.arena_layout((48, 64), 3, None, False, 2, 3)
    with pytest.raises(ValueError, match="solve range"):
        ingest.arena_layout((48, 64), 4, (1, 3), True, 2, 2)
    with pytest.raises(ValueError, match="batch"):
        ingest.arena_layout((48, 64), 4, (1, 3), True, 0)


def test_which_rig_frames_the_kernels_take():
    iu, du = (torch.from_numpy(a) for a in _raw())
    ingest.check_raw(iu[None].expand(3, -1, -1), du[None].expand(3, -1, -1), batched=True)
    with pytest.raises(ValueError, match=r"the kernels take \[B, H, W\]"):
        ingest.check_raw(iu, du, batched=True)
    with pytest.raises(ValueError, match="the kernels take"):
        ingest.check_raw(iu[None], du[None].to(torch.int64), batched=True)


def _played_rig_kernels(monkeypatch, cfg, intrinsics):
    """The two kernels played on the CPU by the plain chain for a layout of
    any batch and skip; returns the played calls' raw shapes."""
    played = []

    def play(raw_i, raw_d, layout, ref, cur=None, pack=None):
        played.append(tuple(raw_i.shape))
        depth, valid = convert_raw_depth(raw_d)
        plain = build_pyramid(raw_i.to(torch.float32), depth, valid, layout.num_levels,
                              skip_below=layout.skip)
        levels, sel, refpack, quad = ingest.arena_views(layout, ref, cur)
        for src, dst in zip(plain, levels):
            assert (src is None) == (dst is None)
            for a, b in zip(src or (), dst or ()):
                b.copy_(a)
        prepared = prepare_frame(cfg, intrinsics, plain)
        for k in range(layout.solve[0], layout.solve[1] + 1):
            sel[k].copy_(prepared.sel[k])
            refpack[k].copy_(prepared.refpack[k])
            if layout.quad:
                quad[k].copy_(prepared.quad[k])

    monkeypatch.setattr(ingest, "ingest_cuda", play)
    return played


@pytest.mark.parametrize("form", ["list", "stacked", "tensor_slice"])
def test_the_rig_route_with_the_kernels_played_on_the_cpu(monkeypatch, form):
    """Three streams in one call: one upload and one (played) kernel
    call, the [B, ...] outputs equal to the plain chain over the stacked
    frames, whether the frames come as a list of host arrays, a stacked
    array or a time slice of a [B, T, H, W] tensor."""
    frames = [_raw((61, 83), seed=10 + b) for b in range(3)]
    iu = np.stack([f[0] for f in frames])
    du = np.stack([f[1] for f in frames])
    played = _played_rig_kernels(monkeypatch, CFG, K)
    if form == "list":
        args = (list(iu), list(du))
    elif form == "stacked":
        args = (iu, du)
    else:
        seq_i = torch.from_numpy(np.stack([iu, iu], axis=1))
        seq_d = torch.from_numpy(np.stack([du, du], axis=1).astype(np.int32))
        args = (seq_i[:, 1], seq_d[:, 1])
    timers.enable("cpu")
    levels, prepared = t_frames._ingest_kernels(*args, CFG.num_levels, (CFG, K),
                                                torch.device("cpu"), 3, CFG.last_level)
    spans = timers.drain()
    assert sorted(s.name for s in spans) == ["dvo.ingest.kernel", "dvo.ingest.stage"]
    assert played == [(3, 61, 83)]
    depth, valid = convert_raw_depth(torch.from_numpy(du))
    plain = build_pyramid(torch.from_numpy(iu).to(torch.float32), depth, valid, CFG.num_levels,
                          skip_below=CFG.last_level)
    want = prepare_frame(CFG, K, plain)
    for a, b in zip(levels, plain):
        assert (a is None) == (b is None)
        for x, y in zip(a or (), b or ()):
            assert torch.equal(x, y)
    for field in want._fields:
        for x, y in zip(getattr(prepared, field), getattr(want, field)):
            assert (x is None) == (y is None)
            if x is not None:
                assert x.shape == y.shape and torch.equal(x, y)


def test_a_rig_of_the_wrong_size_raises(monkeypatch):
    played = _played_rig_kernels(monkeypatch, CFG, K)
    iu, du = _raw()
    with pytest.raises(ValueError, match="2 frames for 3 streams"):
        t_frames._ingest_kernels([iu, iu], [du, du], CFG.num_levels, (CFG, K),
                                 torch.device("cpu"), 3)
    assert played == []


def test_ingest_raw_off_the_card_is_the_plain_chain():
    """Off the card a rig takes the plain chain over its stacked frames,
    bit for bit, and ``from_raw`` is its one-frame case."""
    frames = [_raw(seed=20 + b) for b in range(3)]
    iu, du = [f[0] for f in frames], [f[1] for f in frames]
    levels, prepared = t_frames.ingest_raw(iu, du, CFG.num_levels, (CFG, K),
                                           torch.device("cpu"), 3, CFG.last_level)
    depth, valid = convert_raw_depth(torch.from_numpy(np.stack(du)))
    plain = build_pyramid(torch.from_numpy(np.stack(iu)).to(torch.float32), depth, valid,
                          CFG.num_levels, skip_below=CFG.last_level)
    for a, b in zip(levels, plain):
        assert (a is None) == (b is None)
        for x, y in zip(a or (), b or ()):
            assert torch.equal(x, y)
    for x, y in zip(prepared.refpack, prepare_frame(CFG, K, plain).refpack):
        assert (x is None) == (y is None) and (x is None or torch.equal(x, y))
    frame = t_frames.Frame.from_raw(iu[1], du[1], 0.0, CFG.num_levels, prepare_for=(CFG, K),
                                    device="cpu")
    for k in range(CFG.last_level, CFG.num_levels):
        for x, y in zip(frame.levels[k], levels[k]):
            assert torch.equal(x, y[1])
