"""Ingest of raw RGB-D frames on the card: two launches of
``csrc/ingest.cu`` build a frame's whole pyramid and its prepared tables,
bit-equal to the plain chain (``pyramid.convert_raw_depth`` ->
``build_pyramid`` -> ``dense_tracker.prepare_frame``), which stays the CPU
route and the kernels' oracle (``models/frames.ingest_raw`` chooses).  One
frame [H, W] and the B frames of a rig [B, H, W] take the same two
launches, the rig's on a grid of (blocks, B).

* The outputs are views into two byte arenas, laid out by
  :func:`arena_layout`: the reference arena holds every stored level's
  eight ``PyramidLevel`` fields and the solve range's ``sel`` and
  ``refpack``; the current arena the solve range's ``quad`` tables, so
  that a keyframe that drops them (``ref_artifacts``,
  ``BatchedMatcher.evict``) frees them.  A rig's arenas hold each tensor
  as [B, ...], the layout of a batched ``PreparedFrame``.
* Kernel A writes the levels, kernel B the tables, both queued by one C
  call (:func:`ingest_cuda`) on the raw u8 intensity and u16 or int32
  depth on the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import _build
from .camera import Intrinsics
from .pyramid import MAX_DEPTH_DERIVATIVE_M, PyramidLevel

ALIGN = 256  # bytes: every view starts on this boundary of its arena
MAX_LEVELS = 8  # the kernels' bound on the pyramid's depth
DEPTH_SCALE = 5000.0  # raw depth units a meter (TUM)
TILE = (8, 32)  # kernel A's tile (rows, columns)
PACK_THREADS = 256  # kernel B's block

# kernel A's field order (csrc/ingest.cu's ``Field``)
KERNEL_FIELDS = ("intensity", "depth", "idx", "idy", "zdx", "zdy", "valid", "zvalid")
_BOOL_FIELDS = ("valid", "zvalid", "sel")
RAW_DEPTH_DTYPES = (torch.uint16, torch.int32)


class View(NamedTuple):
    """One tensor of a frame in an arena."""

    arena: str  # "ref" or "cur"
    offset: int  # bytes from the arena's start, a multiple of ALIGN
    shape: Tuple[int, ...]
    dtype: torch.dtype

    @property
    def itemsize(self) -> int:
        return 1 if self.dtype == torch.bool else 4

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) * self.itemsize

    @property
    def strided(self):
        """(shape, stride, offset in elements) of ``as_strided`` on its arena:
        a contiguous tensor."""
        stride = tuple(int(np.prod(self.shape[k + 1:], dtype=np.int64))
                       for k in range(len(self.shape)))
        return self.shape, stride, self.offset // self.itemsize


class ArenaLayout:
    """Where a frame's tensors lie in its two arenas (:func:`arena_layout`,
    which makes one object per set of arguments: the argument blocks are
    cached by it)."""

    __slots__ = ("shape", "num_levels", "solve", "quad", "batch", "skip", "ref_bytes",
                 "cur_bytes", "views", "planes", "tables")

    def __init__(self, shape, num_levels, solve, quad, batch, skip, ref_bytes, cur_bytes,
                 views):
        self.shape: Tuple[int, int] = shape  # level 0's (H, W)
        self.num_levels: int = num_levels
        self.batch: Optional[int] = batch  # B of a rig's [B, ...] tensors; None: one frame
        self.skip: int = skip  # the first level stored (those below are None)
        self.solve: Optional[Tuple[int, int]] = solve  # (last, first) of the prepared tables
        self.quad: bool = quad  # the current arena holds quad tables
        self.ref_bytes: int = ref_bytes
        self.cur_bytes: int = cur_bytes
        self.views: Dict[Tuple[str, int], View] = views  # (field, level) -> its view
        # per stored level each field's (is bool, shape, stride, offset in
        # elements) in ``PyramidLevel`` order, None below ``skip``; the solve
        # range's tables as (field, level, shape, stride, offset in elements)
        self.planes = tuple(
            tuple((views[(f, k)].dtype == torch.bool, *views[(f, k)].strided)
                  for f in PyramidLevel._fields) if k >= skip else None
            for k in range(num_levels))
        self.tables = tuple((name, k, *v.strided) for (name, k), v in views.items()
                            if name in ("sel", "refpack", "quad"))


def _aligned(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


def level_shape(shape: Tuple[int, int], level: int) -> Tuple[int, int]:
    """(H, W) of pyramid level ``level``: floor-halved per level."""
    return shape[0] >> level, shape[1] >> level


_FLOAT_FIELDS = tuple(f for f in KERNEL_FIELDS if f not in _BOOL_FIELDS)


@functools.lru_cache(maxsize=64)
def arena_layout(shape: Tuple[int, int], num_levels: int,
                 solve: Optional[Tuple[int, int]] = None, quad: bool = False,
                 batch: Optional[int] = None, skip_below: int = 0) -> ArenaLayout:
    """The arenas of a frame of level-0 ``shape`` with ``num_levels`` levels
    and, for ``solve=(last, first)``, the prepared tables of those levels
    (``quad``: the fused path's quad tables too).  The reference arena holds
    level by level the ``PyramidLevel`` fields (the six float32 fields, then
    ``valid`` and ``zvalid``), then level by level ``sel`` [H, W] bool and
    ``refpack`` [8, N] float32; the current arena the ``quad`` tables
    [32, N] float32.  With ``batch`` B every view is [B, ...] (a field's B
    planes one after another); levels below ``skip_below`` are not stored,
    as ``build_pyramid``'s ``skip_below`` leaves them out.  Each view starts
    on an ``ALIGN``-byte boundary; each arena's size is a multiple of
    ``ALIGN``."""
    h, w = int(shape[0]), int(shape[1])
    if not 1 <= num_levels <= MAX_LEVELS:
        raise ValueError(f"arena_layout: num_levels must be 1..{MAX_LEVELS}, got {num_levels}")
    if not 0 <= skip_below < num_levels:
        raise ValueError(f"arena_layout: skip_below {skip_below} outside levels "
                         f"0..{num_levels - 1}")
    if solve is not None and not skip_below <= solve[0] <= solve[1] < num_levels:
        raise ValueError(f"arena_layout: solve range {solve} outside levels "
                         f"{skip_below}..{num_levels - 1}")
    if batch is not None and batch < 1:
        raise ValueError(f"arena_layout: batch must be at least 1, got {batch}")
    lead = () if batch is None else (int(batch),)
    views: Dict[Tuple[str, int], View] = {}
    size = {"ref": 0, "cur": 0}

    def put(arena, name, level, shape_, dtype):
        views[(name, level)] = View(arena, size[arena], lead + shape_, dtype)
        size[arena] = _aligned(size[arena] + views[(name, level)].nbytes)

    for level in range(skip_below, num_levels):
        hw = level_shape((h, w), level)
        for name in _FLOAT_FIELDS:
            put("ref", name, level, hw, torch.float32)
        for name in ("valid", "zvalid"):
            put("ref", name, level, hw, torch.bool)
    if solve is not None:
        for level in range(solve[0], solve[1] + 1):
            hw = level_shape((h, w), level)
            put("ref", "sel", level, hw, torch.bool)
            put("ref", "refpack", level, (8, hw[0] * hw[1]), torch.float32)
        if quad:
            for level in range(solve[0], solve[1] + 1):
                hw = level_shape((h, w), level)
                put("cur", "quad", level, (32, hw[0] * hw[1]), torch.float32)
    return ArenaLayout((h, w), num_levels, solve, bool(quad and solve is not None),
                       None if batch is None else int(batch), int(skip_below), size["ref"],
                       size["cur"], views)


def new_arenas(layout: ArenaLayout, device) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The two arenas of ``layout``, uninitialised, as float32 tensors (the
    current arena None where it holds nothing)."""
    ref = torch.empty(layout.ref_bytes // 4, dtype=torch.float32, device=device)
    cur = (torch.empty(layout.cur_bytes // 4, dtype=torch.float32, device=device)
           if layout.cur_bytes else None)
    return ref, cur


def arena_views(layout: ArenaLayout, ref: torch.Tensor, cur: Optional[torch.Tensor]):
    """The frame's tensors as views of its arenas: (levels, sel, refpack,
    quad), each one entry per level (a level below the layout's ``skip``
    None; the tables None outside the solve range and, for ``quad``, without
    quad tables or without ``cur``): one ``as_strided`` a tensor."""
    bases = (ref, ref.view(torch.bool))
    levels = tuple(None if fields is None else
                   PyramidLevel(*[bases[flag].as_strided(shape, stride, offset)
                                  for flag, shape, stride, offset in fields])
                   for fields in layout.planes)
    n = layout.num_levels
    tables = {"sel": [None] * n, "refpack": [None] * n, "quad": [None] * n}
    base = {"sel": bases[1], "refpack": ref, "quad": cur}
    for name, k, shape, stride, offset in layout.tables:
        if base[name] is not None:
            tables[name][k] = base[name].as_strided(shape, stride, offset)
    return levels, tuple(tables["sel"]), tuple(tables["refpack"]), tuple(tables["quad"])


# ---------------------------------------------------------------------------
# the kernels' argument blocks (csrc/ingest.cu's PyramidArgs and PackArgs)

_I8 = ctypes.c_int * MAX_LEVELS
_F8 = ctypes.c_float * MAX_LEVELS
_L8 = ctypes.c_longlong * MAX_LEVELS


class PyramidArgs(ctypes.Structure):
    _fields_ = [("levels", ctypes.c_int), ("h", _I8), ("w", _I8), ("tiles_x", _I8),
                ("block_start", _I8), ("blocks", _I8),
                ("field", (ctypes.c_longlong * len(KERNEL_FIELDS)) * MAX_LEVELS)]


class PackArgs(ctypes.Structure):
    _fields_ = [("last", ctypes.c_int), ("first", ctypes.c_int), ("write_quad", ctypes.c_int),
                ("h", _I8), ("w", _I8), ("block_start", _I8), ("blocks", _I8),
                ("field", (ctypes.c_longlong * len(KERNEL_FIELDS)) * MAX_LEVELS),
                ("sel", _L8), ("refpack", _L8), ("quad", _L8),
                ("ox", _F8), ("oy", _F8), ("inv_fx", _F8), ("inv_fy", _F8),
                ("intensity_threshold", ctypes.c_float), ("depth_threshold", ctypes.c_float)]


def _fill_fields(args, layout: ArenaLayout):
    for level in range(layout.skip, layout.num_levels):
        for k, name in enumerate(KERNEL_FIELDS):
            args.field[level][k] = layout.views[(name, level)].offset


@functools.lru_cache(maxsize=64)
def pyramid_args(layout: ArenaLayout) -> PyramidArgs:
    """Kernel A's argument block: per level its shape, tiles and fields,
    the coarse levels' blocks first (their tiles cost the most); a level
    below the layout's ``skip`` has no blocks."""
    args = PyramidArgs()
    args.levels = layout.num_levels
    start = 0
    for level in reversed(range(layout.num_levels)):
        h, w = level_shape(layout.shape, level)
        tiles_x = -(-w // TILE[1])
        args.h[level], args.w[level], args.tiles_x[level] = h, w, max(tiles_x, 1)
        args.block_start[level] = start
        args.blocks[level] = tiles_x * -(-h // TILE[0]) if level >= layout.skip else 0
        start += args.blocks[level]
    _fill_fields(args, layout)
    return args


def _f32(x: float) -> np.float32:
    return np.float32(x)


@functools.lru_cache(maxsize=64)
def pack_args(layout: ArenaLayout, intrinsics: Intrinsics, intensity_threshold: float,
              depth_threshold: float) -> PackArgs:
    """Kernel B's argument block for the solve range of ``layout``: the
    tables' offsets, each level's intrinsics as the plain chain's float32
    scalars and the selection thresholds.  The offsets are cast to float32;
    a focal length enters as its reciprocal, taken in double and rounded to
    float32, since PyTorch's CUDA division by a Python scalar multiplies by
    that (``tests_cuda/test_ingest_kernel_cuda.py`` holds the two to the
    same bits)."""
    if layout.solve is None:
        raise ValueError("pack_args: the layout has no solve range")
    last, first = layout.solve
    args = PackArgs()
    args.last, args.first, args.write_quad = last, first, int(layout.quad)
    start = 0
    for level in reversed(range(last, first + 1)):
        h, w = level_shape(layout.shape, level)
        k = intrinsics.at_level(level)
        args.h[level], args.w[level] = h, w
        args.block_start[level] = start
        args.blocks[level] = -(-(h * w) // PACK_THREADS)
        start += args.blocks[level]
        args.sel[level] = layout.views[("sel", level)].offset
        args.refpack[level] = layout.views[("refpack", level)].offset
        args.quad[level] = layout.views[("quad", level)].offset if layout.quad else 0
        args.ox[level], args.oy[level] = _f32(k.ox), _f32(k.oy)
        args.inv_fx[level] = _f32(1.0 / k.fx)
        args.inv_fy[level] = _f32(1.0 / k.fy)
    _fill_fields(args, layout)
    args.intensity_threshold = _f32(intensity_threshold)
    args.depth_threshold = _f32(depth_threshold)
    return args


# ---------------------------------------------------------------------------
# the library and the kernels' wrapper


@functools.lru_cache(maxsize=None)
def _library():
    """``csrc/ingest.cu`` with its C signatures declared (built by nvcc at
    the first call in a process)."""
    lib = _build.load_library("ingest").lib
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ll = ctypes.c_longlong
    lib.dvo_ingest.argtypes = [p, p, i, i, ll, ll, i, f, f, p, ctypes.POINTER(PyramidArgs), p,
                               ctypes.POINTER(PackArgs), p]
    lib.dvo_ingest_sizes.argtypes = [ctypes.POINTER(i), ctypes.POINTER(i)]
    for name in ("dvo_ingest", "dvo_ingest_sizes"):
        getattr(lib, name).restype = ctypes.c_int
    sizes = (ctypes.c_int(), ctypes.c_int())
    lib.dvo_ingest_sizes(ctypes.byref(sizes[0]), ctypes.byref(sizes[1]))
    if (sizes[0].value, sizes[1].value) != (ctypes.sizeof(PyramidArgs), ctypes.sizeof(PackArgs)):
        raise RuntimeError("csrc/ingest.cu's argument blocks differ from ops/ingest.py's: "
                           f"{sizes[0].value}, {sizes[1].value} bytes against "
                           f"{ctypes.sizeof(PyramidArgs)}, {ctypes.sizeof(PackArgs)}")
    return lib


def _check(code: int, what: str):
    if code:
        raise RuntimeError(f"{what} failed with CUDA error {code}")


def _stream(device: torch.device) -> int:
    return _build.current_stream(device)


_INV_SCALE = _f32(1.0 / DEPTH_SCALE)
_MAX_DERIVATIVE = _f32(MAX_DEPTH_DERIVATIVE_M)


def _check_arenas(layout: ArenaLayout, ref: torch.Tensor, cur: Optional[torch.Tensor],
                  pack: Optional[PackArgs]):
    if not ref.is_cuda or ref.dtype != torch.float32 or ref.numel() * 4 != layout.ref_bytes:
        raise ValueError("ingest_cuda: the reference arena does not fit the layout")
    if pack is not None:
        if layout.solve is None:
            raise ValueError("ingest_cuda: kernel B needs a layout with a solve range")
        if layout.quad and (cur is None or not cur.is_cuda or cur.dtype != torch.float32
                            or cur.numel() * 4 != layout.cur_bytes):
            raise ValueError("ingest_cuda: the current arena does not fit the layout")


def check_raw(raw_i: torch.Tensor, raw_d: torch.Tensor, batched: bool = False):
    """Raises ValueError unless the kernels take this raw frame: [H, W]
    uint8 intensity and [H, W] uint16 or int32 depth of the same shape
    (with ``batched``, a rig's [B, H, W] of each)."""
    dims = 3 if batched else 2
    if (raw_i.dtype != torch.uint8 or raw_d.dtype not in RAW_DEPTH_DTYPES
            or raw_i.dim() != dims or raw_i.shape != raw_d.shape):
        lead = "[B, H, W]" if batched else "[H, W]"
        raise ValueError(f"ingest: a raw frame of {raw_i.dtype} {tuple(raw_i.shape)} and "
                         f"{raw_d.dtype} {tuple(raw_d.shape)}; the kernels take {lead} uint8 "
                         f"intensity and {lead} uint16 or int32 depth")


def rows_contiguous(t: torch.Tensor) -> bool:
    """Each frame's rows lie one after another (a rig's frames may lie
    apart: a time slice of a [B, T, H, W] sequence)."""
    return t.stride(-1) == 1 and (t.shape[-2] <= 1 or t.stride(-2) == t.shape[-1])


def ingest_cuda(raw_i: torch.Tensor, raw_d: torch.Tensor, layout: ArenaLayout,
                ref: torch.Tensor, cur: Optional[torch.Tensor] = None,
                pack: Optional[PackArgs] = None):
    """The kernels on raw frames on the card: kernel A writes the levels of
    ``layout`` from raw_i uint8 and raw_d uint16 or int32 (CUDA, each
    frame's rows contiguous), [H, W] or, for a layout with a ``batch`` B,
    [B, H, W], into the reference arena ``ref``; with ``pack``
    (:func:`pack_args` of this layout) kernel B then writes ``sel`` and
    ``refpack`` into ``ref`` and the quad tables, where the layout has
    them, into ``cur``.  One C call, no synchronisation, whatever B; adds
    one to ``ingest_cuda.pyramid_launches`` and, with ``pack``, to
    ``ingest_cuda.pack_launches``."""
    if not (raw_i.is_cuda and raw_d.is_cuda):
        raise ValueError("ingest_cuda: the raw frame must be CUDA tensors")
    batched = layout.batch is not None
    check_raw(raw_i, raw_d, batched)
    lead = (layout.batch,) if batched else ()
    if tuple(raw_i.shape) != lead + layout.shape:
        raise ValueError(f"ingest_cuda: raw frame {tuple(raw_i.shape)} against the layout's "
                         f"{lead + layout.shape}")
    if not (rows_contiguous(raw_i) and rows_contiguous(raw_d)):
        raise ValueError("ingest_cuda: each raw frame's rows must be contiguous")
    _check_arenas(layout, ref, cur, pack)
    err = _library().dvo_ingest(
        raw_i.data_ptr(), raw_d.data_ptr(), int(raw_d.dtype == torch.int32),
        layout.batch or 1, raw_i.stride(0) if batched else 0,
        raw_d.stride(0) if batched else 0, layout.shape[1], _INV_SCALE, _MAX_DERIVATIVE,
        ref.data_ptr(), ctypes.byref(pyramid_args(layout)),
        cur.data_ptr() if pack is not None and layout.quad else None,
        ctypes.byref(pack) if pack is not None else None, _stream(ref.device))
    _check(err, "ingest_cuda: a kernel launch")
    ingest_cuda.pyramid_launches += 1
    ingest_cuda.pack_launches += pack is not None


ingest_cuda.pyramid_launches = 0
ingest_cuda.pack_launches = 0
