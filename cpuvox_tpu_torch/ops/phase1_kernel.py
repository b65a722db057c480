"""Kernel 2: the phase-1 chunk rasterizer (``csrc/rasterize.cu``).

Replaces ``cpuvox_tpu/ops/phase1_kernel.py::rasterize_chunk``: a chunk's C
cells on the dense march, a group of GK gated cells on the gated march.  Per
ray, for each cell in order: frustum cull and solid kill, the
writable-frustum re-clip, then per run of the column the side span (near
clip, perspective-correct u) and the top/bottom cap, written into the
unwritten texels of the ray's own raybuffer row: color indices, or in ARGB
mode the column's inline colors themselves (the TPU kernel's MCC write).
The frontier scans are the EXACT ones of
``_next_unwritten_geq``/``_prev_unwritten_leq``, so both designs below equal
the plain version (``_rasterize_step`` over the cells) bit for bit in the
raybuffer and in all 8 state fields.

``rasterize_visits`` is the march's (``raymarch.march_ops``): a group of
16 CUDA lanes a ray, half a warp.  It takes the cells as the march makes
them, the roll's visits (C, 13, Rk) int32 on the dense march or a gated
group's ``PackedCells``, and reads and unpacks each cell's column record
from the world tables itself (inline int32 runs, 16-bit packed runs, the
split layout), so the march runs no torch column fetch.  On the dense march
it works out each cell's column index from the visit, through the tile
window of a world-sharded active world (``WorldArrays.win``, read from the
device) where there is one; a gated group's rows carry the index ``raymarch.gated_group`` made.
The lanes split the texel work, work out a cell's runs side by side in a
world of more than 8 runs a column, and keep a written-texel bitmask of the
ray's row in shared memory for the frontier scans.  Its plain version,
``rasterize_visits_ref``, is the fetch (``raymarch.fetch_cells``, whose
``chunk_cells`` applies the same window) followed by
``raymarch.rasterize_cells``.

``rasterize_chunk`` is the previous design, off every path and timed
against the group kernel by ``chip_smoke.py``: one thread a ray on cells
that torch has fetched (``CellFields``), its plain version
``rasterize_cells``.

The camera height is a scalar of the launch, or for a batch of cameras
marched together (``parallel/batch.py``) an (R,) array a ray
(``raymarch.raster_consts``), which ``rasterize_visits`` hands the kernel
as two pointers; ``rasterize_chunk`` takes the scalar only.

Each wrapper takes its plain version for CPU tensors and launches its
kernel for CUDA tensors, which it updates in place, and returns the same
``RasterState``.  With a live-ray ``index`` (ascending int32 (Rk,)) lane
group (or thread) t works on ray ``index[t]``: the cells are (C, ., Rk), the
raybuffer, the state and the static planes stay in place at full width R.

The TPU kernel's run blocks and checkpoint sweep skip exist for its lane
layout; here a ray passes a far-side run as cheaply as a skip would
(``csrc/rasterize.cu``).
"""
from __future__ import annotations

import ctypes

import torch

from cpuvox_tpu_torch.render import device as world_device
from cpuvox_tpu_torch.render import raymarch as rm

from . import _build

# kernel launches since the last reset (plain calls not counted): the group
# kernel's, and the previous design's
launches = 0
chunk_launches = 0

# the group kernel's record formats (csrc/rasterize.cu)
FMT_INLINE32, FMT_PACKED, FMT_SPLIT = 0, 1, 2

rasterize_chunk_ref = rm.rasterize_cells

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# 9 state + 9 cell-field + 3 static pointers, then the scalars
_CHUNK_ARGTYPES = ([_P] * 21 + [_F, _F, _F, _I, _F, _F, _I, _I, _I, _I, _P,
                                _I, _I, _P])
# 9 state + 3 static pointers; visits, packed, proc, C; the world and its
# tile window; scalars; the per-ray camera height (or nulls); the timer
_VISITS_ARGTYPES = ([_P] * 12 + [_P, _P, _P, _I, _P, _I, _I, _P, _I, _I, _I,
                                 _P, _P, _P, _F, _F, _F, _I, _F,
                                 _F, _I, _P, _P, _P, _I, _I, _P, _P])


def rasterize_visits_ref(rs: rm.RasterState, wa: rm.WorldArrays, cells,
                         static: rm.RayStatic, consts,
                         iteration_direction: int,
                         index=None) -> rm.RasterState:
    """The plain version: torch fetches the cells' column records, then
    ``rasterize_cells`` draws them."""
    return rm.rasterize_cells(rs, rm.fetch_cells(wa, cells,
                                                 iteration_direction),
                              static, consts, iteration_direction,
                              index=index)


def _state_ptrs(rs: rm.RasterState, static: rm.RayStatic):
    g = _build.require
    R, P = rs.raybuf.shape
    i32, f32, b8 = torch.int32, torch.float32, torch.bool
    return [
        g(rs.raybuf, i32, (R, P), "raybuf"),
        g(rs.nfp_min, i32, (R,), "nfp_min"), g(rs.nfp_max, i32, (R,), "nfp_max"),
        g(rs.fb_min, f32, (R,), "fb_min"), g(rs.fb_max, f32, (R,), "fb_max"),
        g(rs.f_active, b8, (R,), "f_active"),
        g(rs.fdir_min, f32, (R,), "fdir_min"),
        g(rs.fdir_max, f32, (R,), "fdir_max"),
        g(rs.alive, b8, (R,), "alive"),
    ], [
        g(static.plane_bottom, f32, (R, 3), "plane_bottom"),
        g(static.plane_top, f32, (R, 3), "plane_top"),
        g(static.plane_dir, f32, (R, 3), "plane_dir"),
    ]


def _scalars(consts, iteration_direction: int):
    wmy, cam_y, cam_y_norm, smin, smax = consts["scalars"]
    has_solid = smax is not None
    return [wmy, cam_y, cam_y_norm, int(has_solid),
            smin if has_solid else 0.0, smax if has_solid else 0.0,
            int(iteration_direction)]


def _cam_y_ptrs(consts, R: int):
    """The per-ray camera height's pointers, (R,) f32 each, or two nulls
    where the frame has one camera (the scalars carry it)."""
    if consts["cam_y"].dim() == 0:
        return [None, None]
    g = _build.require
    return [g(consts["cam_y"], torch.float32, (R,), "cam_y"),
            g(consts["cam_y_norm"], torch.float32, (R,), "cam_y_norm")]


def _world_args(wa: rm.WorldArrays, iteration_direction: int):
    """(rec, rw, fmt, runs, max_runs, rwords, mcc) of the record table the
    direction reads: the inline records (int32 or 16-bit packed runs), or
    the split layout's meta rows and flat run array."""
    g = _build.require
    fwd = iteration_direction > 0
    maxr = wa.max_runs
    if wa.rec_fwd is None:
        rec = wa.col_rec
        runs = g(wa.runs if fwd else wa.runs_rev, torch.int32, None, "runs")
        fmt, rwords, mcc = FMT_SPLIT, 0, 0
    else:
        rec = wa.rec_fwd if fwd else wa.rec_rev
        runs = None
        mcc = wa.max_col_colors
        rwords = world_device.packed_run_words(maxr, mcc)
        fmt = FMT_INLINE32 if rwords == maxr else FMT_PACKED
    if maxr > 64 and fmt != FMT_SPLIT:
        raise ValueError(f"an inline record holds at most 64 runs, not {maxr}")
    rw = rec.shape[1]
    if rw % 8:
        raise ValueError(f"record rows of {rw} ints: expected a multiple of 8")
    return (g(rec, torch.int32, None, "rec"), rw, fmt, runs, maxr, rwords,
            mcc)


def rasterize_visits(rs: rm.RasterState, wa: rm.WorldArrays, cells,
                     static: rm.RayStatic, consts, iteration_direction: int,
                     index=None) -> rm.RasterState:
    """Rasterize one chunk's visited cells (the roll's visits (C, 13, Rk)
    int32) or a gated group (``raymarch.PackedCells``) for every ray, or the
    rays of ``index``, reading the column records from ``wa``."""
    global launches
    if not rs.raybuf.is_cuda:
        return rasterize_visits_ref(rs, wa, cells, static, consts,
                                    iteration_direction, index=index)
    R, P = rs.raybuf.shape
    Rk = R if index is None else index.shape[0]
    g = _build.require
    if isinstance(cells, rm.PackedCells):
        C = cells.rows.shape[0]
        visits = None
        packed = g(cells.rows, torch.int32, (C, Rk, 4), "rows")
        proc = g(cells.proc, torch.bool, (C, Rk), "proc")
        if packed % 16:  # the kernel reads a row as one int4
            raise ValueError("packed rows: expected 16-byte alignment")
    else:
        C = cells.shape[0]
        visits = g(cells, torch.int32, (C, rm.NVF, Rk), "visits")
        packed = proc = None
    state, planes = _state_ptrs(rs, static)
    rec, rw, fmt, runs, maxr, rwords, mcc = _world_args(wa, iteration_direction)
    fn = _build.function("cpuvox_rasterize_visits", _VISITS_ARGTYPES)
    code = fn(*state, *planes, visits, packed, proc, C, rec, rw, fmt, runs,
              maxr, rwords, mcc,
              g(wa.col_base, torch.int32, (8,), "col_base"),
              g(wa.grid_z, torch.int32, (8,), "grid_z"),
              None if wa.win is None
              else g(wa.win, torch.int32, (4,), "win"),
              *_scalars(consts, iteration_direction), *_cam_y_ptrs(consts, R),
              None if index is None else g(index, torch.int32, (Rk,), "index"),
              Rk, P, _build.timer_ptr(), _build.stream_ptr(rs.raybuf))
    _build.check(code, "cpuvox_rasterize_visits")
    if _build.counted():
        launches += 1
    return rs


def rasterize_chunk(rs: rm.RasterState, cells: rm.CellFields,
                    static: rm.RayStatic, consts, iteration_direction: int,
                    index=None) -> rm.RasterState:
    """The previous design on fetched cells; same signature and result as
    ``raymarch.rasterize_cells``."""
    global chunk_launches
    if not rs.raybuf.is_cuda:
        return rasterize_chunk_ref(rs, cells, static, consts,
                                   iteration_direction, index=index)
    if consts["cam_y"].dim():
        raise ValueError("the previous design takes one camera height a "
                         "launch")
    R, P = rs.raybuf.shape
    Rk = R if index is None else index.shape[0]
    C = cells.lod.shape[0]
    maxr = cells.runs.shape[-1]
    mcc = 0 if cells.colors is None else cells.colors.shape[-1]
    g = _build.require
    i32, f32, b8 = torch.int32, torch.float32, torch.bool
    state, planes = _state_ptrs(rs, static)
    fields = [
        g(cells.ids, f32, (C, Rk, 2), "ids"),
        g(cells.lod, i32, (C, Rk), "lod"),
        g(cells.valid, b8, (C, Rk), "valid"),
        g(cells.n_runs, i32, (C, Rk), "n_runs"),
        g(cells.color_off, i32, (C, Rk), "color_off"),
        g(cells.cmin, i32, (C, Rk), "cmin"),
        g(cells.cmax, i32, (C, Rk), "cmax"),
        g(cells.runs, i32, (C, Rk, maxr), "runs"),
        g(cells.colors, i32, (C, Rk, mcc), "colors") if mcc else None,
    ]
    fn = _build.function("cpuvox_rasterize_chunk", _CHUNK_ARGTYPES)
    code = fn(*state, *fields, *planes,
              *_scalars(consts, iteration_direction), C, maxr, mcc,
              None if index is None else g(index, i32, (Rk,), "index"), Rk, P,
              _build.stream_ptr(rs.raybuf))
    _build.check(code, "cpuvox_rasterize_chunk")
    chunk_launches += 1
    return rs
