"""Kernel 2: the phase-1 chunk rasterizer (``csrc/rasterize.cu``).

Replaces ``cpuvox_tpu/ops/phase1_kernel.py::rasterize_chunk``: a chunk's C
cells on the dense march, a group of GK gated cells on the gated march.  One
CUDA thread per ray walks the cells in order and, per cell, the column's
runs (``MAXR`` is a runtime argument): frustum cull and solid kill, the
writable-frustum re-clip, then per run the side span (near clip,
perspective-correct u) and the top/bottom cap, writing into unwritten texels
of the ray's own raybuffer row: color indices, or in ARGB mode
(``cells.colors`` given, MCC words a cell, a runtime argument too) the
column's inline colors themselves (the TPU kernel's MCC write).  The thread runs the EXACT
frontier scans of ``_next_unwritten_geq``/``_prev_unwritten_leq`` over its
row, so the kernel equals the plain version (``_rasterize_step`` over the
cells) bit for bit in the raybuffer and in all 8 state fields.

``rasterize_chunk`` takes the plain version for CPU tensors and launches the
kernel for CUDA tensors.  The kernel updates the raybuffer and the state in
place and returns the same ``RasterState``.

With a live-ray ``index`` (ascending int32 (Rk,)) thread t works on ray
``index[t]``: the cells are (C, Rk), the raybuffer, the state and the static
planes stay in place at full width R.

The TPU kernel's run blocks and checkpoint sweep skip exist for its lane
layout; one thread per ray sweeps any MAXR in one loop and passes a far-side
run as cheaply as a skip would (``csrc/rasterize.cu``).
"""
from __future__ import annotations

import ctypes

import torch

from cpuvox_tpu_torch.render import raymarch as rm

from . import _build

launches = 0  # kernel launches since the last reset (plain calls not counted)

rasterize_chunk_ref = rm.rasterize_cells

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# 9 state + 9 cell-field + 3 static pointers, then the scalars
_ARGTYPES = ([_P] * 21 + [_F, _F, _F, _I, _F, _F, _I, _I, _I, _I, _P, _I, _I,
                          _P])


def rasterize_chunk(rs: rm.RasterState, cells: rm.CellFields,
                    static: rm.RayStatic, consts, iteration_direction: int,
                    index=None) -> rm.RasterState:
    """Rasterize one chunk of visited cells for every ray (or the rays of
    ``index``); same signature and result as ``raymarch.rasterize_cells``."""
    global launches
    if not rs.raybuf.is_cuda:
        return rasterize_chunk_ref(rs, cells, static, consts,
                                   iteration_direction, index=index)
    R, P = rs.raybuf.shape
    Rk = R if index is None else index.shape[0]
    C = cells.lod.shape[0]
    maxr = cells.runs.shape[-1]
    mcc = 0 if cells.colors is None else cells.colors.shape[-1]
    g = _build.require
    i32, f32, b8 = torch.int32, torch.float32, torch.bool
    ptrs = [
        g(rs.raybuf, i32, (R, P), "raybuf"),
        g(rs.nfp_min, i32, (R,), "nfp_min"), g(rs.nfp_max, i32, (R,), "nfp_max"),
        g(rs.fb_min, f32, (R,), "fb_min"), g(rs.fb_max, f32, (R,), "fb_max"),
        g(rs.f_active, b8, (R,), "f_active"),
        g(rs.fdir_min, f32, (R,), "fdir_min"),
        g(rs.fdir_max, f32, (R,), "fdir_max"),
        g(rs.alive, b8, (R,), "alive"),
        g(cells.ids, f32, (C, Rk, 2), "ids"),
        g(cells.lod, i32, (C, Rk), "lod"),
        g(cells.valid, b8, (C, Rk), "valid"),
        g(cells.n_runs, i32, (C, Rk), "n_runs"),
        g(cells.color_off, i32, (C, Rk), "color_off"),
        g(cells.cmin, i32, (C, Rk), "cmin"),
        g(cells.cmax, i32, (C, Rk), "cmax"),
        g(cells.runs, i32, (C, Rk, maxr), "runs"),
        g(cells.colors, i32, (C, Rk, mcc), "colors") if mcc else None,
        g(static.plane_bottom, f32, (R, 3), "plane_bottom"),
        g(static.plane_top, f32, (R, 3), "plane_top"),
        g(static.plane_dir, f32, (R, 3), "plane_dir"),
    ]
    wmy, cam_y, cam_y_norm, smin, smax = consts["scalars"]
    has_solid = smax is not None
    fn = _build.function("cpuvox_rasterize_chunk", _ARGTYPES)
    code = fn(*ptrs, wmy, cam_y, cam_y_norm, int(has_solid),
              smin if has_solid else 0.0, smax if has_solid else 0.0,
              int(iteration_direction), C, maxr, mcc,
              None if index is None else g(index, i32, (Rk,), "index"), Rk, P,
              _build.stream_ptr(rs.raybuf))
    _build.check(code, "cpuvox_rasterize_chunk")
    launches += 1
    return rs
