"""Kernel 2: the phase-1 chunk rasterizer (``csrc/rasterize.cu``).

Replaces ``cpuvox_tpu/ops/phase1_kernel.py::rasterize_chunk`` on the dense
branch.  One CUDA thread per ray walks the chunk's C visited cells in order
and, per cell, the column's runs (``MAXR`` is a runtime argument): frustum
cull and solid kill, the writable-frustum re-clip, then per run the side span
(near clip, perspective-correct u) and the top/bottom cap, writing color
indices into unwritten texels of the ray's own raybuffer row.  The thread
runs the EXACT frontier scans of ``_next_unwritten_geq``/``_prev_unwritten_leq``
over its row, so the kernel equals the plain version (``_rasterize_step``
over the C cells) bit for bit in the raybuffer and in all 8 state fields.

``rasterize_chunk`` takes the plain version for CPU tensors and launches the
kernel for CUDA tensors.  The kernel updates the raybuffer and the state in
place and returns the same ``RasterState``.

Not ported (their callers are off the dense path): the MCC inline-color
write, the deep-RLE run blocks and the checkpoint sweep skip.
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
# 9 state + 8 cell-field + 3 static pointers, then the scalars
_ARGTYPES = ([_P] * 20 + [_F, _F, _F, _I, _F, _F, _I, _I, _I, _I, _I, _P])


def rasterize_chunk(rs: rm.RasterState, cells: rm.CellFields,
                    static: rm.RayStatic, consts, iteration_direction: int
                    ) -> rm.RasterState:
    """Rasterize one chunk of visited cells for every ray; same signature
    and result as ``raymarch.rasterize_cells``."""
    global launches
    if not rs.raybuf.is_cuda:
        return rasterize_chunk_ref(rs, cells, static, consts,
                                   iteration_direction)
    R, P = rs.raybuf.shape
    C = cells.lod.shape[0]
    maxr = cells.runs.shape[-1]
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
        g(cells.ids, f32, (C, R, 2), "ids"), g(cells.lod, i32, (C, R), "lod"),
        g(cells.valid, b8, (C, R), "valid"),
        g(cells.n_runs, i32, (C, R), "n_runs"),
        g(cells.color_off, i32, (C, R), "color_off"),
        g(cells.cmin, i32, (C, R), "cmin"), g(cells.cmax, i32, (C, R), "cmax"),
        g(cells.runs, i32, (C, R, maxr), "runs"),
        g(static.plane_bottom, f32, (R, 3), "plane_bottom"),
        g(static.plane_top, f32, (R, 3), "plane_top"),
        g(static.plane_dir, f32, (R, 3), "plane_dir"),
    ]
    wmy, cam_y, cam_y_norm, smin, smax = consts["scalars"]
    has_solid = smax is not None
    fn = _build.function("cpuvox_rasterize_chunk", _ARGTYPES)
    code = fn(*ptrs, wmy, cam_y, cam_y_norm, int(has_solid),
              smin if has_solid else 0.0, smax if has_solid else 0.0,
              int(iteration_direction), C, maxr, R, P,
              _build.stream_ptr(rs.raybuf))
    _build.check(code, "cpuvox_rasterize_chunk")
    launches += 1
    return rs
