"""The gated march's glue as two kernels (``csrc/gate.cu``): the gate and
the rewind of one gated iteration.

No TPU kernel is replaced: the JAX package's stage A/B and rewind are XLA
code inside its ``while_loop`` (``cpuvox_tpu/render/raymarch.py:1228-1333``,
``:1542-1583``).  On the card their plain versions, ``raymarch.gated_group``
and ``raymarch.rewind_snapshot``/``rewind_apply``, ran as several dozen
small torch launches an iteration; here they are one launch each,
bit-equal to them.  Each kernel adds its launch to its word of a (3,) int64
device counter, the march state's ``gate_counts`` [gate launches, overflow
steps, rewind launches]:

- ``gate`` (after the roll): the occupancy-tile gate with its tile budget,
  the frustum-window gate with taint, the solid pre-kill (``rs.alive``
  cleared in place) and the pack of each ray's first ``group_cells`` gated
  cells, plus what the rewind needs: the ray's gated count, its cap and
  the pre-switch snapshot of its first unprocessed gated cell
  (``raymarch.rewind_snapshot``), so no (C, Rk) mask leaves the kernel;
  it also counts its overflow steps (steps past the tile budget, fetched
  conservatively);
- ``rewind`` (after the rasterizer): ``raymarch.rewind_apply`` in place on
  the DDA state, the rewound rays or-ed into the march's ``alive`` and
  counted into ``rewound``.

Each takes its plain version for CPU tensors (``gate_ref``, ``rewind_ref``:
the plain functions with the kernels' in-place contract, which count
nothing; ``raymarch.march_ops`` gives them for the plain march) and
launches its kernel for CUDA tensors.  With a live-ray
``index`` (int32 (Rk,), distinct rays) the visits and the outputs are the
index's slots and the state stays in place at full width.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from cpuvox_tpu_torch.render import raymarch as rm

from . import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_GATE_ARGTYPES = ([_P, _I, _I, _P, _P, _I] + [_P] * 10
                  + [_F, _F, _F, _I, _F, _F, _I] + [_P] * 7)
_REWIND_ARGTYPES = [_I] + [_P] * 15


class Gate(NamedTuple):
    """A gated iteration's group and what its rewind reads."""

    cells: rm.PackedCells  # (GK, Rk) each ray's first GK gated cells
    count: torch.Tensor  # (Rk,) i32: gated steps per ray
    cap: torch.Tensor  # (Rk,) i32: gated steps in the group, min(count, GK)
    snap: torch.Tensor  # (7, Rk) i32: ``raymarch.rewind_snapshot``


def gate_ref(wa: rm.WorldArrays, visits, rs: rm.RasterState, consts,
             group_cells: int, counters, index=None) -> Gate:
    """The plain version: ``raymarch.gated_group`` with its pre-kill
    written into ``rs.alive``; ``counters`` is left as it is."""
    killed, g = rm.gated_group(wa, visits, rs, consts, group_cells,
                               index=index)
    if killed.alive is not rs.alive:
        rs.alive.copy_(killed.alive)
    return Gate(g.cells, g.count, g.cap, rm.rewind_snapshot(visits, g))


def gate(wa: rm.WorldArrays, visits, rs: rm.RasterState, consts,
         group_cells: int, counters, index=None) -> Gate:
    """Gate and pack one rolled chunk (``visits`` (C, 13, Rk) int32) for
    every ray, or the rays of ``index``: ``gated_group`` in one launch,
    the pre-kill applied to ``rs.alive`` in place; adds 1 and the overflow
    steps to ``counters`` ((3,) int64, ``raymarch.MarchState``'s
    ``gate_counts``)."""
    if not visits.is_cuda:
        return gate_ref(wa, visits, rs, consts, group_cells, counters,
                        index=index)
    C, R = visits.shape[0], rs.alive.shape[0]
    Rk = visits.shape[2]
    GK = int(group_cells)
    g = _build.require
    i32, f32, b8 = torch.int32, torch.float32, torch.bool
    dev = visits.device
    out = Gate(rm.PackedCells(torch.empty((GK, Rk, 4), dtype=i32, device=dev),
                              torch.empty((GK, Rk), dtype=b8, device=dev)),
               torch.empty(Rk, dtype=i32, device=dev),
               torch.empty(Rk, dtype=i32, device=dev),
               torch.empty((rm.SNAP_WORDS, Rk), dtype=i32, device=dev))
    wmy, cam_y, _cam_y_norm, smin, smax = consts["scalars"]
    has_solid = smax is not None
    fn = _build.function("cpuvox_gate", _GATE_ARGTYPES)
    code = fn(g(visits, i32, (C, rm.NVF, Rk), "visits"), C, Rk,
              None if index is None else g(index, i32, (Rk,), "index"),
              g(wa.occ_tiles, i32, None, "occ_tiles"),
              wa.occ_tiles.shape[0],
              g(wa.tile_base, i32, (8,), "tile_base"),
              g(wa.tile_gz, i32, (8,), "tile_gz"),
              g(wa.col_base, i32, (8,), "col_base"),
              g(wa.grid_z, i32, (8,), "grid_z"),
              None if wa.win is None else g(wa.win, i32, (4,), "win"),
              g(rs.fdir_min, f32, (R,), "fdir_min"),
              g(rs.fdir_max, f32, (R,), "fdir_max"),
              g(rs.f_active, b8, (R,), "f_active"),
              g(rs.alive, b8, (R,), "alive"),
              None if consts["cam_y"].dim() == 0
              else g(consts["cam_y"], f32, (R,), "cam_y"),
              cam_y, wmy, float(rm.GATE_EPS), int(has_solid),
              smin if has_solid else 0.0, smax if has_solid else 0.0, GK,
              out.cells.rows.data_ptr(), out.cells.proc.data_ptr(),
              out.count.data_ptr(), out.cap.data_ptr(), out.snap.data_ptr(),
              g(counters, torch.int64, (3,), "counters"),
              _build.stream_ptr(visits))
    _build.check(code, "cpuvox_gate")
    return out


def rewind_ref(dda: rm.DDAState, alive, rewound, counters,
               rs: rm.RasterState, g: Gate, index=None) -> None:
    """The plain version: ``raymarch.rewind_apply`` written into ``dda``,
    the rewound rays or-ed into ``alive`` and counted into ``rewound``;
    ``counters`` is left as it is."""
    new, needs = rm.rewind_apply(dda, g.snap, g.count, g.cap, rs, index)
    for d, x in zip(dda, new):
        d.copy_(x)
    alive.copy_(rm._or_rows(alive, index, needs))
    rewound.add_(needs.sum())


def rewind(dda: rm.DDAState, alive, rewound, counters, rs: rm.RasterState,
           g: Gate, index=None) -> None:
    """The busy-ray rewind of one gated iteration in one launch, in place:
    ``dda`` (R, .), the march's ``alive`` (R,) bool, ``rewound`` () int64;
    adds 1 to ``counters[2]`` (the gate's); ``rs`` is the state after the
    rasterizer."""
    if not alive.is_cuda:
        return rewind_ref(dda, alive, rewound, counters, rs, g, index=index)
    R = alive.shape[0]
    Rk = g.count.shape[0]
    p = _build.require
    i32, f32 = torch.int32, torch.float32
    fn = _build.function("cpuvox_gate_rewind", _REWIND_ARGTYPES)
    code = fn(Rk, None if index is None else p(index, i32, (Rk,), "index"),
              p(g.count, i32, (Rk,), "count"), p(g.cap, i32, (Rk,), "cap"),
              p(g.snap, i32, (rm.SNAP_WORDS, Rk), "snap"),
              p(rs.alive, torch.bool, (R,), "rs_alive"),
              p(dda.pos, i32, (R, 2), "pos"), p(dda.tmax, f32, (R, 2), "tmax"),
              p(dda.tdelta, f32, (R, 2), "tdelta"),
              p(dda.stp, i32, (R, 2), "stp"), p(dda.ids, f32, (R, 2), "ids"),
              p(dda.lod, i32, (R,), "lod"),
              p(alive, torch.bool, (R,), "alive"),
              p(rewound, torch.int64, (), "rewound"),
              p(counters, torch.int64, (3,), "counters"),
              _build.stream_ptr(alive))
    _build.check(code, "cpuvox_gate_rewind")
