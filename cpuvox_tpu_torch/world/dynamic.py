"""Dynamic worlds: per-frame RLE column rebuilds on the device, in torch.

The counterpart of ``cpuvox_tpu/world/dynamic.py``; every function keeps
the reference's integer and float operations, so on the same inputs it
builds the same words (``tests/test_torch_dynamic.py`` and
``tests/test_torch_editable.py`` hold them to JAX).  Two kinds of world:

- a *surface world*: every column one solid band of constant depth, rebuilt
  from a height field each frame (``build_surface_world_arrays``): 3 runs a
  column, [air above][band][air below], and a LOD chain that is the union
  of the 2x2 blocks above LOD 0, with LOD 1 voxel-exact under
  ``exact_lod1`` (at most 9 runs a column);
- an *editable world*: every column owns a fixed-capacity inline record
  (``EditableWorld``), so ``set_voxel_column`` replaces one column on the
  device; it renders LOD 0 only, or through a voxel-exact LOD chain that
  ``editable_chain_snapshot`` rebuilds on the device.

Both produce the port's ``raymarch.WorldArrays`` (the split layout for the
surface world and the chain, the inline records for the editable world),
with no occupancy tiles: a Renderer over them (``Renderer.from_arrays``)
marches densely whatever its gate setting, as the JAX Renderer does.

Colors are int32 views of uint32 ARGB, as everywhere in the port.  Where
the reference takes a maximum of uint32 colors (a scatter ``.at[].max``),
an opaque color has bit 31 set and is negative as int32, so the maximum is
taken on the colors widened to int64 (``_scatter_max_u32``).  A scatter-add
with repeated indices is exact in int32 in any order.
"""
from __future__ import annotations

import ctypes
import ctypes.util
from typing import NamedTuple

import numpy as np
import torch

from cpuvox_tpu_torch.render import device as world_device
from cpuvox_tpu_torch.render.raymarch import WorldArrays

SKYBOX = int(np.uint32(0xFF191919).view(np.int32))
OPAQUE = int(np.uint32(0xFF000000).view(np.int32))  # alpha 255
BIG = 1 << 20
_I32 = torch.int32


class SurfaceWorldSpec(NamedTuple):
    dims: tuple[int, int, int]
    depth: int  # solid band depth (voxels, constant per column)
    lod_levels: int
    exact_lod1: bool = True  # voxel-exact LOD1; False = union


_EXACT_LOD1_RUNS = 9  # union of 4 intervals: <= 4 solid runs + <= 5 air runs


def surface_world_max_runs(spec: SurfaceWorldSpec) -> int:
    """Per-column run capacity the renderer must size its fetch for."""
    return _EXACT_LOD1_RUNS if (spec.exact_lod1 and spec.lod_levels > 1) else 3


def _exact_lod1_color_cap(depth: int, h1: int) -> int:
    # each source band contributes <= floor(depth/2)+1 halved voxels; 4 sources
    return min(4 * (depth // 2 + 1), h1)


def _col_base_grid_z(dims, L: int):
    """(col_base, grid_z), 8 entries each, the LODs past ``L`` clamped to the
    last one, as ``DeviceWorld`` lays them out (numpy)."""
    X, _Y, Z = dims
    col_base = np.zeros(8, np.int32)
    for i in range(1, L):
        col_base[i] = col_base[i - 1] + (X >> (i - 1)) * (Z >> (i - 1))
    col_base[L:] = col_base[L - 1]
    grid_z = np.array([max(Z >> min(i, L - 1), 1) for i in range(8)], np.int32)
    return col_base, grid_z


def _u32(x):
    """int32 bits of uint32 values as their int64 value."""
    return x.to(torch.int64) & 0xFFFFFFFF


def _scatter_max_u32(n_rows: int, width: int, tgt, vals):
    """``zeros((n_rows, width), uint32).at[rows, tgt].max(vals)`` with
    ``vals`` int32 bits of uint32: the maximum taken in int64, back to int32
    bits."""
    out = torch.zeros((n_rows, width), dtype=torch.int64, device=vals.device)
    out.scatter_reduce_(1, tgt.long(), _u32(vals), "amax")
    return out.to(_I32)


def _argb(sum_r, sum_g, sum_b, d):
    """Opaque ARGB of the floor-mean channels, int32 bits."""
    return (OPAQUE | (torch.div(sum_r, d, rounding_mode="floor") << 16)
            | (torch.div(sum_g, d, rounding_mode="floor") << 8)
            | torch.div(sum_b, d, rounding_mode="floor"))


def _runs_from_occupancy_batched(occ_t, K: int):
    """Batched (N, H) TOP-FIRST occupancy -> packed RLE runs
    (``dynamic.py:62``).  Returns (runs (N, K) int32, runs_rev (N, K),
    n_runs (N,)): solid runs pack (colors_index << 16) | length with
    colors_index = solid voxels above within the column, air runs
    (-1 << 16) | length.  Columns of more than K runs are not representable;
    callers size K from a proof."""
    N, H = occ_t.shape
    dev = occ_t.device
    first = torch.ones((N, H), dtype=torch.bool, device=dev)
    first[:, 1:] = occ_t[:, 1:] != occ_t[:, :-1]
    run_id = torch.cumsum(first.to(_I32), 1, dtype=_I32) - 1
    nr = run_id[:, -1] + 1
    rid = run_id.clamp(max=K - 1).long()
    occ_i = occ_t.to(_I32)
    lengths = torch.zeros((N, K), dtype=_I32, device=dev).scatter_add_(
        1, rid, torch.ones_like(occ_i))
    is_solid = torch.zeros((N, K), dtype=_I32, device=dev).scatter_reduce_(
        1, rid, occ_i, "amax") > 0
    solid_before = torch.cumsum(occ_i, 1, dtype=_I32) - occ_i
    cidx = torch.full((N, K), BIG, dtype=_I32, device=dev).scatter_reduce_(
        1, rid, torch.where(occ_t, solid_before, BIG), "amin")
    cidx = torch.where(is_solid, cidx, 0)
    runs = torch.where(is_solid, (cidx << 16) | lengths, (-1 << 16) | lengths)
    kk = torch.arange(K, dtype=_I32, device=dev)[None, :]
    n_runs = torch.where(occ_t.any(1), nr, 0)
    in_col = kk < n_runs[:, None]
    runs = torch.where(in_col, runs, 0)
    rev_idx = torch.where(in_col, n_runs[:, None] - 1 - kk, kk).clamp(0, K - 1)
    runs_rev = torch.where(in_col, torch.gather(runs, 1, rev_idx.long()), 0)
    return runs, runs_rev, n_runs


def _exact_lod1_parts(dims, depth, tl0, bl0, colors):
    """Voxel-exact LOD1 tables from LOD0 band arrays (``dynamic.py:100``):
    a LOD1 voxel is solid iff a source band of its 2x2 columns holds a y'
    with y' >> 1 == y, colored with the floor-mean over all contributing
    source voxels, alpha 255.  Returns (runs_flat, runs_rev_flat,
    colors_flat, n_runs, cmin, cmax, K1, cap1), cmin/cmax in world units."""
    X, Y, Z = dims
    gx1, gz1, h1 = X >> 1, Z >> 1, Y >> 1
    n1 = gx1 * gz1
    K1 = _EXACT_LOD1_RUNS
    cap1 = _exact_lod1_color_cap(depth, h1)
    dev = tl0.device

    y1 = torch.arange(h1, dtype=_I32, device=dev)[None, None, :]
    occ1 = torch.zeros((gx1, gz1, h1), dtype=torch.bool, device=dev)
    sums = [torch.zeros((gx1, gz1, h1), dtype=_I32, device=dev)
            for _ in range(4)]  # r, g, b, count
    for dx in (0, 1):
        for dz in (0, 1):
            t_i = tl0[dx::2, dz::2][:, :, None]
            b_i = bl0[dx::2, dz::2][:, :, None]
            occ1 = occ1 | ((y1 >= (b_i >> 1)) & (y1 <= (t_i >> 1)))
            c_i = colors[dx::2, dz::2].contiguous()  # (gx1, gz1, depth) top-first
            for p in (0, 1):
                yp = 2 * y1 + p
                valid = (yp >= b_i) & (yp <= t_i)
                idx = (t_i - yp).clamp(0, depth - 1)
                c = torch.gather(c_i, 2, idx.long())
                for s, ch in zip(sums, ((c >> 16) & 0xFF, (c >> 8) & 0xFF,
                                        c & 0xFF, torch.ones_like(c))):
                    s += torch.where(valid, ch, 0)
    sum_r, sum_g, sum_b, cnt = sums
    argb1 = _argb(sum_r, sum_g, sum_b, cnt.clamp(min=1))

    ys = y1[0]
    has_solid = occ1.any(2)
    cmin = torch.where(has_solid,
                       torch.where(occ1, ys, BIG).amin(2) * 2, 0)
    cmax = torch.where(has_solid,
                       torch.where(occ1, ys + 1, -BIG).amax(2) * 2, 0)

    occ_t = occ1.flip(2).reshape(n1, h1)
    argb_t = torch.where(occ1, argb1, 0).flip(2).reshape(n1, h1)
    runs, runs_rev, n_runs = _runs_from_occupancy_batched(occ_t, K1)
    occ_i = occ_t.to(_I32)
    solid_before = torch.cumsum(occ_i, 1, dtype=_I32) - occ_i
    tgt = torch.where(occ_t, solid_before, cap1 - 1)
    slot = _scatter_max_u32(n1, cap1, tgt, argb_t)
    return (runs.reshape(-1), runs_rev.reshape(-1), slot.reshape(-1),
            n_runs, cmin.reshape(n1), cmax.reshape(n1), K1, cap1)


def _record(n_runs, run_off, color_off, cmin, cmax):
    """Split-layout meta rows (n_cols, 8): [n_runs, run_off, color_off, cmin,
    cmax, 0, 0, 0]."""
    z = torch.zeros_like(n_runs)
    return torch.stack([n_runs, run_off, color_off, cmin, cmax, z, z, z], 1)


def build_surface_world_arrays(spec: SurfaceWorldSpec, top,
                               colors) -> WorldArrays:
    """Heights -> the world's arrays on ``top``'s device (``dynamic.py:170``).

    top: (X, Z) int32, each column band's top voxel y (bottom = top - depth
    + 1, clamped at 0); colors: (X, Z, depth) int32 ARGB bits, top voxel
    first.  LOD0 (and LOD1 with ``exact_lod1``) are voxel-exact against the
    static builder; the other LODs are a conservative union (max top per
    2^L block)."""
    X, Y, Z = spec.dims
    depth = spec.depth
    L = spec.lod_levels
    dev = top.device
    col_base, grid_z = _col_base_grid_z(spec.dims, L)

    exact1 = spec.exact_lod1 and L > 1
    runs_parts, runs_rev_parts, colors_parts, rec_parts = [], [], [], []
    run_base = 0
    color_base = 1  # colors[0] = skybox

    top_l = top
    colors_l = colors
    tl0 = bl0 = None
    for lvl in range(L):
        gx, gz = X >> lvl, Z >> lvl
        if lvl > 0:
            # the union band and the color subsample of the 2x2 parent block
            # (the chain from LOD2 on continues from it, exact LOD1 or not)
            top_l = top_l.reshape(gx, 2, gz, 2).amax(dim=(1, 3)) >> 1
            colors_l = colors_l.reshape(gx, 2, gz, 2, depth)[:, 0, :, 0, :]
        n_cols = gx * gz
        h_l = Y >> lvl
        ar = torch.arange(n_cols, dtype=_I32, device=dev)

        if lvl == 1 and exact1:
            (runs1, runs1_rev, colors1, n_runs1, cmin1, cmax1,
             K_l, cap_l) = _exact_lod1_parts(spec.dims, depth, tl0, bl0,
                                             colors)
            runs_parts.append(runs1)
            runs_rev_parts.append(runs1_rev)
            colors_parts.append(colors1)
            rec_parts.append(_record(n_runs1, ar * K_l + run_base,
                                     ar * cap_l + color_base, cmin1, cmax1))
            run_base += n_cols * K_l
            color_base += n_cols * cap_l
            continue

        tl = top_l.reshape(n_cols).clamp(0, h_l - 1)
        bl = (tl - depth + 1).clamp(min=0)
        if lvl == 0:
            tl0, bl0 = tl.reshape(gx, gz), bl.reshape(gx, gz)
        solid = tl - bl + 1  # colors_index 0
        air_above = (-1 << 16) | ((h_l - 1) - tl)
        air_below = (-1 << 16) | bl
        runs_parts.append(
            torch.stack([air_above, solid, air_below], 1).reshape(-1))
        runs_rev_parts.append(
            torch.stack([air_below, solid, air_above], 1).reshape(-1))
        colors_parts.append(colors_l.reshape(-1))
        vs = 1 << lvl
        rec_parts.append(_record(torch.full_like(ar, 3), ar * 3 + run_base,
                                 ar * depth + color_base, bl * vs,
                                 (tl + 1) * vs))
        run_base += n_cols * 3
        color_base += n_cols * depth

    # the run fetch reads max_runs words from a column's offset: pad the tail
    # so the last column's window stays in bounds
    max_runs = surface_world_max_runs(spec)
    pad = torch.zeros(max_runs, dtype=_I32, device=dev)
    sky = torch.full((1,), SKYBOX, dtype=_I32, device=dev)
    return WorldArrays(
        col_base=torch.from_numpy(col_base).to(dev),
        grid_z=torch.from_numpy(grid_z).to(dev),
        rec_fwd=None, rec_rev=None,
        colors=torch.cat([sky, *colors_parts]), max_runs=max_runs,
        occ_tiles=None, tile_base=None, tile_gz=None,
        col_rec=torch.cat(rec_parts), runs=torch.cat(runs_parts + [pad]),
        runs_rev=torch.cat(runs_rev_parts + [pad]))


def terrain_colors(spec: SurfaceWorldSpec, top):
    """Height-palette colors for a band world (``dynamic.py:286``):
    (X, Z, depth) int32 ARGB bits, top voxel first.  The hash wraps in
    uint32 in the reference; here it runs in int64, masked to 32 bits."""
    X, Y, Z = spec.dims
    dev = top.device
    d = torch.arange(spec.depth, dtype=_I32, device=dev)[None, None, :]
    vy = (top[:, :, None] - d).clamp(min=0)
    # a divide by a 0-d tensor on the device: the reference's f32 divide
    t = (vy.to(torch.float32)
         / torch.tensor(float(Y), dtype=torch.float32, device=dev)).clamp(0, 1)
    xs = torch.arange(X, dtype=torch.int64, device=dev)[:, None, None]
    zs = torch.arange(Z, dtype=torch.int64, device=dev)[None, :, None]
    xz_hash = (((xs * 2654435761) & 0xFFFFFFFF)
               ^ ((zs * 40503) & 0xFFFFFFFF))
    noise = (((xz_hash + vy.to(torch.int64) * 97) & 0xFFFFFFFF) & 15).to(
        torch.float32) - 8.0

    def channel(base, slope):
        return (base + t * slope + noise).clamp(0, 255).to(_I32)

    r, g, b = channel(60.0, 160.0), channel(150.0, -60.0), channel(50.0, 120.0)
    return OPAQUE | (r << 16) | (g << 8) | b


_libm = None


def _libm_f32(name: str, x: np.ndarray) -> np.ndarray:
    """glibc's single-precision ``name`` (sinf, cosf) of each f32 of ``x``."""
    global _libm
    if _libm is None:
        _libm = ctypes.CDLL(ctypes.util.find_library("m"))
        for fn in ("sinf", "cosf"):
            getattr(_libm, fn).restype = ctypes.c_float
            getattr(_libm, fn).argtypes = [ctypes.c_float]
    fn = getattr(_libm, name)
    return np.array([fn(float(v)) for v in x], np.float32)


def _fma_f32(a: np.ndarray, b, c) -> np.ndarray:
    """f32 ``a * b + c`` rounded once, for f32 ``a``, ``b``, ``c``: the
    product of two f32 and its sum with an f32 of these magnitudes are exact
    in f64, so one rounding to f32 is the fused multiply-add's."""
    f64 = np.float64
    return (a.astype(f64) * f64(np.float32(b)) + f64(np.float32(c))).astype(
        np.float32)


def animate_heights(spec: SurfaceWorldSpec, base_top, t: float):
    """Example per-frame edit (``dynamic.py:304``): traveling waves over a
    base heightmap, rounded half to even and clamped to [depth, Y - 2].

    The wave is sin(x * 0.05 + t * 2) * cos(z * 0.07 + t * 1.3) * amp, an
    outer product of X sines and Z cosines.  Those are computed on the host
    as the reference computes them on the CPU: XLA contracts each argument
    into a fused multiply-add and calls glibc's ``sinf``/``cosf``.  torch's
    vectorised sin and the card's ``sinf`` are each an ulp off on some
    arguments, which the round turns into a different height where the wave
    is near a .5 tie; from the host's values the heights are the same bits
    on the CPU and on the card."""
    X, Y, Z = spec.dims
    dev = base_top.device
    tt = np.float32(t)
    sx = _libm_f32("sinf", _fma_f32(np.arange(X, dtype=np.float32), 0.05,
                                    tt * np.float32(2.0)))
    cz = _libm_f32("cosf", _fma_f32(np.arange(Z, dtype=np.float32), 0.07,
                                    tt * np.float32(1.3)))
    amp = float(np.float32(max(2.0, Y * 0.05)))
    wave = (torch.from_numpy(sx).to(dev)[:, None]
            * torch.from_numpy(cz).to(dev)[None, :] * amp)
    return (base_top + torch.round(wave).to(_I32)).clamp(spec.depth, Y - 2)


def surface_renderer(spec: SurfaceWorldSpec, top, colors, config=None,
                     device=None, compact: bool | None = None):
    """A Renderer over a dynamic surface world (``dynamic.py:315``).  Swap
    ``renderer._wa = build_surface_world_arrays(spec, top, colors)`` after
    an edit; the shapes stay the same."""
    from cpuvox_tpu_torch.config import RenderConfig
    from cpuvox_tpu_torch.render.frame import Renderer

    config = config or RenderConfig(width=640, height=360)
    wa = build_surface_world_arrays(spec, top, colors)
    return Renderer.from_arrays(wa, spec.dims, config,
                                device=device or top.device, compact=compact)


# --------------------------------------------------------------- general edits
#
# Every column owns a fixed-capacity record in the renderer's inline layout,
# so ``set_voxel_column`` (the reference's World.SetVoxelColumn) is a scatter
# on the device.  Live edits render LOD0 only (``editable_renderer``: LOD
# distances beyond the far clip); ``editable_chain_snapshot`` rebuilds a
# voxel-exact LOD chain on the device when the far field should catch up.


class EditableWorldSpec(NamedTuple):
    dims: tuple[int, int, int]
    max_runs: int  # per-column run capacity (K)
    col_colors: int  # per-column color capacity (>= max solid voxels/column)


class EditableWorld(NamedTuple):
    """Dense per-column records and fixed-stride colors, on the device."""

    rec_fwd: torch.Tensor  # (X*Z, RW) int32
    rec_rev: torch.Tensor  # (X*Z, RW) int32
    colors: torch.Tensor  # (1 + X*Z*col_colors,) int32 ARGB bits; [0] = skybox


def _rec_width(spec: EditableWorldSpec) -> int:
    # the inline record of render/device.py, 16-bit packed where that
    # shrinks the row, so the renderer reads editable records as it reads
    # static ones
    return ((world_device.REC_META + world_device.packed_run_words(
        spec.max_runs) + 7) // 8) * 8


def columns_from_occupancy(spec: EditableWorldSpec, occupancy, argb):
    """(N, Y) bool occupancy + (N, Y) int32 colors (bottom first) -> N record
    rows and color slots: (rows_fwd (N, RW), rows_rev (N, RW), slots (N,
    col_colors)): ``column_from_occupancy`` (``dynamic.py:390``) for N
    columns at once.  Runs are emitted top-first, colors top-first per solid voxel;
    a row's color offset (word 1) is 0 and set by the caller.  Columns of
    more than max_runs runs are not representable."""
    X, Y, Z = spec.dims
    K = spec.max_runs
    RW = _rec_width(spec)
    N = occupancy.shape[0]
    dev = occupancy.device
    occ = occupancy.flip(1)  # top voxel first
    col = argb.flip(1)

    first = torch.ones((N, Y), dtype=torch.bool, device=dev)
    first[:, 1:] = occ[:, 1:] != occ[:, :-1]
    run_id = torch.cumsum(first.to(_I32), 1, dtype=_I32) - 1
    n_runs = run_id[:, -1] + 1
    rid = run_id.clamp(max=K - 1).long()
    occ_i = occ.to(_I32)
    lengths = torch.zeros((N, K), dtype=_I32, device=dev).scatter_add_(
        1, rid, torch.ones_like(occ_i))
    is_solid = torch.zeros((N, K), dtype=_I32, device=dev).scatter_reduce_(
        1, rid, occ_i, "amax") > 0
    solid_before = torch.cumsum(occ_i, 1, dtype=_I32) - occ_i
    cidx = torch.full((N, K), BIG, dtype=_I32, device=dev).scatter_reduce_(
        1, rid, torch.where(occ, solid_before, BIG), "amin")
    cidx = torch.where(is_solid, cidx, 0)
    runs = torch.where(is_solid, (cidx << 16) | lengths, (-1 << 16) | lengths)
    kk = torch.arange(K, dtype=_I32, device=dev)[None, :]
    runs = torch.where(kk < n_runs[:, None], runs, 0)
    has_solid = occ.any(1)
    n_runs = torch.where(has_solid, n_runs, 0)  # air-only column: 0 runs

    # reversed run order for the upward iteration direction
    in_col = kk < n_runs[:, None]
    rev_idx = torch.where(in_col, n_runs[:, None] - 1 - kk, kk)
    runs_rev = torch.where(
        in_col, torch.gather(runs, 1, rev_idx.clamp(0, K - 1).long()), 0)

    ys = torch.arange(Y, dtype=_I32, device=dev)[None, :]
    cmin = torch.where(has_solid,
                       torch.where(occupancy, ys, BIG).amin(1), 0)
    cmax = torch.where(has_solid,
                       torch.where(occupancy, ys + 1, -BIG).amax(1), 0)

    # the solid colors compacted to the front of the column's slot, top first
    tgt = torch.where(occ, solid_before, spec.col_colors - 1)
    slot = _scatter_max_u32(N, spec.col_colors, tgt, torch.where(occ, col, 0))

    rwords = world_device.packed_run_words(K)

    def rows(rr):
        if rwords != K:
            # 16-bit packing, two runs a word (air bit 0x8000): the reader
            # rebuilds each solid run's color index from the solid lengths
            length = rr & 0xFFFF
            half = torch.where(rr < 0, 0x8000 | length, length)
            half = torch.where(kk < n_runs[:, None], half, 0)
            half = torch.cat([half, torch.zeros((N, 2 * rwords - K),
                                                dtype=_I32, device=dev)], 1)
            pairs = half.reshape(N, rwords, 2).to(torch.int64)
            rr = (pairs[..., 0] | (pairs[..., 1] << 16)).to(_I32)  # wraps
        meta = torch.stack([n_runs, torch.zeros_like(n_runs), cmin, cmax], 1)
        return torch.cat([meta, rr, torch.zeros(
            (N, RW - 4 - rr.shape[1]), dtype=_I32, device=dev)], 1)

    return rows(runs), rows(runs_rev), slot


def set_voxel_column(spec: EditableWorldSpec, ew: EditableWorld, x, z,
                     occupancy, argb) -> EditableWorld:
    """Replace column (x, z), all on the device (``dynamic.py:460``; the
    reference's SetVoxelColumn).  Returns a new EditableWorld."""
    X, Y, Z = spec.dims
    ci = int(x) * Z + int(z)
    rows_f, rows_r, slots = columns_from_occupancy(spec, occupancy[None],
                                                   argb[None])
    row_f, row_r, slot = rows_f[0], rows_r[0], slots[0]
    coff = 1 + ci * spec.col_colors
    row_f[1] = coff
    row_r[1] = coff
    rec_fwd, rec_rev, colors = (ew.rec_fwd.clone(), ew.rec_rev.clone(),
                                ew.colors.clone())
    rec_fwd[ci] = row_f
    rec_rev[ci] = row_r
    colors[coff:coff + spec.col_colors] = slot
    return EditableWorld(rec_fwd=rec_fwd, rec_rev=rec_rev, colors=colors)


def _expand_lod0(w):
    """WorldLOD -> (col_index, y, argb) voxel soup (host numpy, setup only;
    a copy of ``dynamic.py:475``)."""
    X, Y, Z = w.dims
    runs = np.asarray(w.runs)
    col_runs = np.asarray(w.col_runs)
    col_off = np.asarray(w.col_offset).astype(np.int64)
    occupied = np.nonzero(col_runs > 0)[0]
    if occupied.size == 0:
        e = np.zeros(0, np.int64)
        return e, e.copy(), np.zeros(0, np.uint32)
    starts = col_off[occupied]
    n = runs.shape[0]
    colmark = np.zeros(n, np.int64)
    colmark[starts] = 1
    col_of = np.cumsum(colmark) - 1
    col_id = occupied[col_of]
    lengths = (runs & 0xFFFF).astype(np.int64)
    cum = np.cumsum(lengths)
    col_start_cum = (cum[starts] - lengths[starts])[col_of]
    before = np.concatenate([[0], cum[:-1]]) - col_start_cum
    y_top = (Y - 1) - before  # first (highest) voxel y of each run
    sel = np.nonzero((runs >= 0) & (lengths > 0))[0]
    reps = lengths[sel]
    rid = np.repeat(sel, reps)
    k = np.arange(int(reps.sum()), dtype=np.int64) \
        - np.repeat(np.cumsum(reps) - reps, reps)
    ys = y_top[rid] - k
    cols = col_id[rid]
    cpos = (np.asarray(w.col_color_offset).astype(np.int64)[cols]
            + (runs[rid] >> 16) + k)
    return cols, ys, np.asarray(w.colors)[cpos]


def editable_from_lod0(w, max_runs: int | None = None,
                       col_colors: int | None = None, device="cuda"):
    """Static WorldLOD -> (spec, EditableWorld on ``device``) with a fixed
    record slot a column (``dynamic.py:508``).  The voxel soup is expanded
    on the host (``_expand_lod0``), the records are built on the device."""
    dims = w.dims
    spec_runs = max_runs or max(int(np.asarray(w.col_runs).max()), 1)
    X, Y, Z = dims
    n_cols = X * Z
    occ = np.zeros((n_cols, Y), bool)
    col = np.zeros((n_cols, Y), np.uint32)
    cols, ys, argb = _expand_lod0(w)
    occ[cols, ys] = True
    col[cols, ys] = argb
    ccap = col_colors or max(1, int(occ.sum(axis=1).max()))
    spec = EditableWorldSpec(dims=tuple(dims), max_runs=spec_runs,
                             col_colors=ccap)
    rows_f, rows_r, slots = columns_from_occupancy(
        spec, torch.from_numpy(occ).to(device),
        torch.from_numpy(col.view(np.int32)).to(device))
    coffs = 1 + torch.arange(n_cols, dtype=_I32, device=rows_f.device) * ccap
    rows_f[:, 1] = coffs
    rows_r[:, 1] = coffs
    sky = torch.full((1,), SKYBOX, dtype=_I32, device=rows_f.device)
    return spec, EditableWorld(rec_fwd=rows_f, rec_rev=rows_r,
                               colors=torch.cat([sky, slots.reshape(-1)]))


def editable_world_arrays(spec: EditableWorldSpec,
                          ew: EditableWorld) -> WorldArrays:
    """The renderer's arrays over an EditableWorld: LOD0 only, so pair them
    with LOD distances past the far clip (``editable_renderer``)."""
    X, Y, Z = spec.dims
    dev = ew.colors.device
    return WorldArrays(
        col_base=torch.zeros(8, dtype=_I32, device=dev),
        grid_z=torch.full((8,), Z, dtype=_I32, device=dev),
        rec_fwd=ew.rec_fwd, rec_rev=ew.rec_rev, colors=ew.colors,
        max_runs=spec.max_runs, occ_tiles=None, tile_base=None, tile_gz=None)


def editable_renderer(spec: EditableWorldSpec, ew: EditableWorld,
                      config=None, compact: bool | None = None):
    """A Renderer over an EditableWorld (``dynamic.py:552``), LOD0 only:
    every LOD distance is 4x the far clip.  Swap ``renderer._wa =
    editable_world_arrays(spec, new_ew)`` after edits."""
    from cpuvox_tpu_torch.config import RenderConfig
    from cpuvox_tpu_torch.render.frame import Renderer

    config = config or RenderConfig(width=640, height=360)
    far = float(2 * max(spec.dims))
    return Renderer.from_arrays(
        editable_world_arrays(spec, ew), spec.dims, config,
        device=ew.colors.device, compact=compact,
        lod_distances=np.full(max(config.lod_levels, 1), 4 * far, np.float32),
        far_clip=far)


# ------------------------------------- deferred exact LOD chain for edit worlds
#
# ``editable_chain_snapshot`` rebuilds a full voxel-exact LOD chain from an
# EditableWorld on the device.  The static builder (rle.downsample) colors
# every LOD-L voxel with the flat floor-mean over its 2^L cube of LOD0
# voxels, not a mean of means, so the pyramid carries channel sums and
# counts and divides only when a level is emitted.


def _editable_dense(spec: EditableWorldSpec, ew: EditableWorld):
    """EditableWorld records -> dense (N, Y) TOP-FIRST occupancy and ARGB
    (``dynamic.py:602``)."""
    X, Y, Z = spec.dims
    N, K = X * Z, spec.max_runs
    rec = ew.rec_fwd
    dev = rec.device
    n_runs = rec[:, 0]
    rwords = world_device.packed_run_words(K)
    meta = world_device.REC_META
    if rwords != K:
        words = rec[:, meta:meta + rwords]
        lo = words & 0xFFFF
        hi = (words >> 16) & 0xFFFF  # logical shift: the high half is unsigned
        halves = torch.stack([lo, hi], -1).reshape(N, 2 * rwords)[:, :K]
        length = halves & 0x7FFF
        air = (halves & 0x8000) != 0
    else:
        words = rec[:, meta:meta + K]
        length = words & 0xFFFF
        air = words < 0
    kk = torch.arange(K, dtype=_I32, device=dev)[None, :]
    valid_k = kk < n_runs[:, None]
    lengths = torch.where(valid_k, length, 0)
    is_solid = valid_k & ~air & (lengths > 0)
    start = torch.cumsum(lengths, 1, dtype=_I32) - lengths  # top-first

    marks = torch.zeros((N, Y + 1), dtype=_I32, device=dev).scatter_add_(
        1, start.clamp(0, Y).long(), valid_k.to(_I32))
    rid = torch.cumsum(marks[:, :Y], 1, dtype=_I32) - 1
    occ_t = (torch.gather(is_solid, 1, rid.clamp(0, K - 1).long())
             & (rid >= 0))
    occ_i = occ_t.to(_I32)
    solid_before = torch.cumsum(occ_i, 1, dtype=_I32) - occ_i
    slot = ew.colors[1:].reshape(N, spec.col_colors)
    argb_t = torch.where(
        occ_t, torch.gather(slot, 1, solid_before.clamp(
            0, spec.col_colors - 1).long()), 0)
    return occ_t, argb_t


def _chain_pyramid(dims, occ_t, argb_t, L: int):
    """Per-level (count, sum_r, sum_g, sum_b) dense pyramids, y ascending,
    (X >> l, Z >> l, Y >> l); the sums and counts aggregate LOD0 voxels."""
    X, Y, Z = dims
    occ0 = occ_t.flip(1).reshape(X, Z, Y)
    argb0 = argb_t.flip(1).reshape(X, Z, Y)
    cnt = occ0.to(_I32)
    sum_r = torch.where(occ0, (argb0 >> 16) & 0xFF, 0)
    sum_g = torch.where(occ0, (argb0 >> 8) & 0xFF, 0)
    sum_b = torch.where(occ0, argb0 & 0xFF, 0)
    out = [(cnt, sum_r, sum_g, sum_b)]
    for lvl in range(1, L):
        gx, gz, h = X >> lvl, Z >> lvl, Y >> lvl

        def down(a):
            return a.reshape(gx, 2, gz, 2, h, 2).sum(dim=(1, 3, 5),
                                                     dtype=_I32)

        cnt, sum_r, sum_g, sum_b = (down(cnt), down(sum_r), down(sum_g),
                                    down(sum_b))
        out.append((cnt, sum_r, sum_g, sum_b))
    return out


def _occupancy_runs(occ):
    """Runs a column of top-first (N, H) occupancy, 0 for an empty one."""
    first = torch.ones_like(occ)
    first[:, 1:] = occ[:, 1:] != occ[:, :-1]
    nr = first.to(_I32).sum(1, dtype=_I32)
    return torch.where(occ.any(1), nr, 0)


def _chain_required_runs(dims, pyramid) -> int:
    """The largest run count of a column over every chain level (sizes K)."""
    Y = dims[1]
    req = 1
    for lvl, (cnt, _r, _g, _b) in enumerate(pyramid):
        occ = (cnt > 0).flip(2).reshape(-1, Y >> lvl)
        req = max(req, int(_occupancy_runs(occ).max().item()))
    return req


def _chain_build(dims, pyramid, K: int) -> WorldArrays:
    """The pyramid -> a voxel-exact chain in the split layout (col_rec +
    runs + runs_rev + colors), on the device (``dynamic.py:686``)."""
    X, Y, Z = dims
    L = len(pyramid)
    dev = pyramid[0][0].device
    col_base, grid_z = _col_base_grid_z(dims, L)

    runs_parts, runs_rev_parts, colors_parts, rec_parts = [], [], [], []
    run_base, color_base = 0, 1  # colors[0] = skybox
    for lvl, (cnt, sum_r, sum_g, sum_b) in enumerate(pyramid):
        gx, gz, h = X >> lvl, Z >> lvl, Y >> lvl
        n_cols = gx * gz
        occ = cnt > 0
        argb = torch.where(occ, _argb(sum_r, sum_g, sum_b, cnt.clamp(min=1)),
                           0)
        occ_l = occ.flip(2).reshape(n_cols, h)  # top-first
        argb_l = argb.flip(2).reshape(n_cols, h)
        runs, runs_rev, n_runs = _runs_from_occupancy_batched(occ_l, K)
        occ_i = occ_l.to(_I32)
        solid_before = torch.cumsum(occ_i, 1, dtype=_I32) - occ_i
        tgt = torch.where(occ_l, solid_before, h - 1)
        slot = _scatter_max_u32(n_cols, h, tgt, torch.where(occ_l, argb_l, 0))

        ys = torch.arange(h, dtype=_I32, device=dev)[None, None, :]
        has_solid = occ.any(2)
        vs = 1 << lvl
        cmin = torch.where(has_solid,
                           torch.where(occ, ys, BIG).amin(2) * vs,
                           0).reshape(n_cols)
        cmax = torch.where(has_solid,
                           torch.where(occ, ys + 1, -BIG).amax(2) * vs,
                           0).reshape(n_cols)
        ar = torch.arange(n_cols, dtype=_I32, device=dev)
        rec_parts.append(_record(n_runs, ar * K + run_base,
                                 ar * h + color_base, cmin, cmax))
        runs_parts.append(runs.reshape(-1))
        runs_rev_parts.append(runs_rev.reshape(-1))
        colors_parts.append(slot.reshape(-1))
        run_base += n_cols * K
        color_base += n_cols * h

    pad = torch.zeros(K, dtype=_I32, device=dev)
    sky = torch.full((1,), SKYBOX, dtype=_I32, device=dev)
    return WorldArrays(
        col_base=torch.from_numpy(col_base).to(dev),
        grid_z=torch.from_numpy(grid_z).to(dev),
        rec_fwd=None, rec_rev=None, colors=torch.cat([sky, *colors_parts]),
        max_runs=K, occ_tiles=None, tile_base=None, tile_gz=None,
        col_rec=torch.cat(rec_parts), runs=torch.cat(runs_parts + [pad]),
        runs_rev=torch.cat(runs_rev_parts + [pad]))


def editable_chain_snapshot(spec: EditableWorldSpec, ew: EditableWorld,
                            lod_levels: int):
    """EditableWorld -> (WorldArrays of a voxel-exact LOD chain, max_runs)
    (``dynamic.py:757``): a sizing pass reads the chain's largest run count
    (one read from the device), then the build emits every level.  Equal to
    the static builder's chain (rle.build_lod_chain) on the same voxels."""
    occ_t, argb_t = _editable_dense(spec, ew)
    dims = tuple(spec.dims)
    pyramid = _chain_pyramid(dims, occ_t, argb_t, lod_levels)
    K = max(_chain_required_runs(dims, pyramid), 1)
    return _chain_build(dims, pyramid, K), K


def editable_chain_renderer(spec: EditableWorldSpec, ew: EditableWorld,
                            config=None, lod_levels: int | None = None,
                            compact: bool | None = None):
    """A Renderer over an EditableWorld's exact-chain snapshot
    (``dynamic.py:772``), with the camera's own LOD distances.  Re-call
    after edits to refresh the far field."""
    from cpuvox_tpu_torch.config import RenderConfig
    from cpuvox_tpu_torch.render.frame import Renderer

    config = config or RenderConfig(width=640, height=360)
    wa, _K = editable_chain_snapshot(spec, ew, lod_levels or config.lod_levels)
    return Renderer.from_arrays(wa, spec.dims, config,
                                device=ew.colors.device, compact=compact)
