"""Device-resident world: all LOD levels concatenated into flat arrays.

A copy of ``cpuvox_tpu/render/device.py`` (plain numpy), cut to the layouts
the port renders: the inline column records (one row per column, runs 16-bit
packed where that shrinks the row, the column's ARGB colors appended in ARGB
mode), the split layout for columns of more than ``INLINE_MAX_RUNS`` runs (an
8-int meta record plus the flat run arrays), the occupancy tiles of the gated
march, the LOD0 empty fraction and the solid Y bounds.  Left out: the lite
records, whose caller the port does not carry.  A (position, lod) pair
resolves to a column with integer math:

    ci = col_base[lod] + (x >> lod) * grid_z[lod] + (z >> lod)

``colors[0]`` is the skybox color; all color offsets are shifted by +1 so color
index 0 always resolves to skybox and -1 marks "unwritten" in raybuffers.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from cpuvox_tpu_torch.utils.colors import pack_argb
from cpuvox_tpu_torch.world.rle import WorldLOD

REC = 8  # ints per split-layout column record: n_runs, run_off, color_off, cmin, cmax
REC_META = 4  # leading meta ints in an inline record: n_runs, color_off, cmin, cmax
INLINE_MAX_RUNS = 60  # inline runs into the record while 4 + max_runs <= 64 ints
# occupancy tiles: one 8-int row per OCC_TILE_X x OCC_TILE_Z block of columns
# per LOD — [4 bitmap words (bit = column has runs), tile cmin, tile cmax, 2 pad].
# The gated march reads one tile row per distinct tile a ray crosses per chunk
# and fetches column records only for visits whose bit is set (the reference's
# empty-column `continue`, DrawSegmentRayJob.cs:251-256).
OCC_TILE_X = 16
OCC_TILE_Z = 8
OCC_ROW = 8

INLINE_MAX_COLORS = 24  # ARGB mode: also inline the column's voxel colors when
# every column has <= this many voxels; phase 1 then writes final ARGB texels
# and phase 2 skips the color resolve.  Colors ride with bit 31 (the alpha MSB,
# always 1 for opaque ARGB) CLEARED so the rasterizer's "unwritten < 0" sentinel
# keeps working; the final skybox pass restores it.


@dataclasses.dataclass
class DeviceWorld:
    """Flat world arrays (numpy, host side; the port copies them to torch)."""

    dims: tuple[int, int, int]
    lod_levels: int
    col_base: np.ndarray  # int32 [8]
    grid_z: np.ndarray  # int32 [8]  (Z >> lod per level)
    # split layout (max_runs > INLINE_MAX_RUNS, else None): [n_runs, run_off,
    # color_off, cmin, cmax, pad...] per column, and every column's runs in
    # one flat array; runs_rev holds each column's runs reversed in place
    col_rec: np.ndarray | None  # int32 [total_cols, REC]
    runs: np.ndarray | None  # int32 [total_runs + max_runs] (tail-padded)
    runs_rev: np.ndarray | None
    colors: np.ndarray  # uint32 [1 + total_colors], [0] = skybox
    max_runs: int  # max col_runs over every LOD (bounds the run loop)
    # inline layout (max_runs <= INLINE_MAX_RUNS): [n_runs, color_off, cmin,
    # cmax, runs...(, colors...)] per column in one row; rec_rev holds the
    # runs reversed for the upward iteration direction
    # (DrawSegmentRayJob.cs:432-437).  None for deeper worlds.
    rec_fwd: np.ndarray | None = None  # int32 [total_cols, 4 + padded max_runs]
    rec_rev: np.ndarray | None = None
    # ARGB mode (INLINE_MAX_COLORS): the column's voxel colors are inline too
    # (alpha MSB cleared), appended after the runs; > 0 marks it
    max_col_colors: int = 0
    lod0_voxels: int = 0
    # occupancy tiles (see OCC_TILE_X): per-LOD emptiness bitmaps + tile
    # cmin/cmax, all LODs concatenated like col_base
    occ_tiles: np.ndarray | None = None  # int32 [n_tiles, OCC_ROW]
    tile_base: np.ndarray | None = None  # int32 [8]
    tile_gz: np.ndarray | None = None  # int32 [8] (tiles per x-row per LOD)
    # fraction of LOD0 columns with zero runs (drives the occupancy auto policy)
    empty_frac: float = 0.0
    # world-Y bounds of SOLID content over every LOD: the march kills a ray
    # whose frozen frustum window provably cleared them (output-exact, see
    # raymarch._rasterize_step).  None = kill disabled.
    solid_min_y: float | None = None
    solid_max_y: float | None = None


def build_occ_tiles(lods: list[WorldLOD]):
    """Per-LOD occupancy tiles: (occ int32 [n_tiles, OCC_ROW], tile_base [8],
    tile_gz [8]).

    Tile (tx, tz) at LOD l covers column cells x in [tx*16, tx*16+16),
    z in [tz*8, tz*8+8); bit for local cell (lx, lz) lives in word (lx*8+lz)>>5
    at bit (lx*8+lz)&31.  Words 4/5 hold min(col_min)/max(col_max) over the
    tile's NONEMPTY columns (BIG/-BIG for all-empty tiles) for the conservative
    frustum-window gate."""
    BIGC = np.int32(1 << 24)
    tile_base = np.zeros(8, np.int32)
    tile_gz = np.ones(8, np.int32)
    parts = []
    base = 0
    lx = np.arange(OCC_TILE_X)
    lz = np.arange(OCC_TILE_Z)
    bitidx = (lx[:, None] * OCC_TILE_Z + lz[None, :]).reshape(-1)  # (128,)
    shifts = (bitidx & 31).astype(np.uint32)
    word_of = bitidx >> 5
    for i, w in enumerate(lods):
        gx, gz = w.dims[0] >> w.lod, w.dims[2] >> w.lod
        tgx = -(-gx // OCC_TILE_X)
        tgz = -(-gz // OCC_TILE_Z)
        tile_base[i] = base
        tile_gz[i] = tgz
        occ2d = (w.col_runs > 0).reshape(gx, gz)
        cmin2d = np.where(occ2d.reshape(-1), w.col_min, BIGC).reshape(gx, gz)
        cmax2d = np.where(occ2d.reshape(-1), w.col_max, -BIGC).reshape(gx, gz)

        def tiles(a, pad_val):
            ap = np.pad(a, ((0, tgx * OCC_TILE_X - gx), (0, tgz * OCC_TILE_Z - gz)),
                        constant_values=pad_val)
            return ap.reshape(tgx, OCC_TILE_X, tgz, OCC_TILE_Z).transpose(
                0, 2, 1, 3).reshape(tgx, tgz, OCC_TILE_X * OCC_TILE_Z)

        bits = tiles(occ2d, False).astype(np.uint32) << shifts[None, None, :]
        row = np.zeros((tgx, tgz, OCC_ROW), np.uint32)
        for wd in range(4):
            sel = bits[:, :, word_of == wd]
            row[:, :, wd] = np.bitwise_or.reduce(sel, axis=2) if sel.size else 0
        row[:, :, 4] = tiles(cmin2d, BIGC).min(axis=2).astype(np.int32) \
            .view(np.uint32)
        row[:, :, 5] = tiles(cmax2d, -BIGC).max(axis=2).astype(np.int32) \
            .view(np.uint32)
        parts.append(row.reshape(-1, OCC_ROW))
        base += tgx * tgz
    lod_levels = len(lods)
    tile_base[lod_levels:] = tile_base[lod_levels - 1]
    tile_gz[lod_levels:] = tile_gz[lod_levels - 1]
    occ = np.concatenate(parts).view(np.int32)
    return occ, tile_base, tile_gz


def reverse_runs(runs: np.ndarray, col_offset: np.ndarray, col_runs: np.ndarray
                 ) -> np.ndarray:
    """Per-column reversed copy of the packed runs array (same offsets)."""
    n = runs.shape[0]
    occupied = np.nonzero(col_runs > 0)[0]
    starts = col_offset[occupied].astype(np.int64)
    counts = col_runs[occupied].astype(np.int64)
    # index i within column -> start + (count - 1 - (i - start))
    idx = np.arange(n, dtype=np.int64)
    col_of = np.zeros(n, np.int64)
    col_of[starts] = 1
    col_of = np.cumsum(col_of) - 1
    s = starts[col_of]
    c = counts[col_of]
    return runs[s + (c - 1) - (idx - s)]


def build_device_world(lods: list[WorldLOD],
                       skybox_rgb: tuple[int, int, int] = (25, 25, 25),
                       inline_colors: bool = False) -> DeviceWorld:
    """Concatenate the LOD chain into the flat arrays: the inline records, or
    the split layout when a column has more than ``INLINE_MAX_RUNS`` runs.
    ``inline_colors`` asks for ARGB mode, which engages when no column holds
    more than ``INLINE_MAX_COLORS`` voxels (``max_col_colors`` > 0)."""
    lod_levels = len(lods)
    col_base = np.zeros(8, np.int32)
    grid_z = np.ones(8, np.int32)
    col_offset, col_runs, col_cols, col_min, col_max = [], [], [], [], []
    runs_parts, colors_parts = [], []
    run_base = 0
    color_base = 1  # colors[0] = skybox
    for i, w in enumerate(lods):
        col_base[i] = sum(x.shape[0] for x in col_runs)
        grid_z[i] = w.dims[2] >> w.lod
        col_offset.append(w.col_offset + run_base)
        col_runs.append(w.col_runs)
        col_cols.append(w.col_color_offset + color_base)
        col_min.append(w.col_min)
        col_max.append(w.col_max)
        runs_parts.append(w.runs)
        colors_parts.append(w.colors)
        run_base += w.runs.shape[0]
        color_base += w.colors.shape[0]
    col_base[lod_levels:] = col_base[lod_levels - 1]  # clamp overflow lods
    grid_z[lod_levels:] = grid_z[lod_levels - 1]
    max_runs = int(max((int(w.col_runs.max()) if w.col_runs.size else 0) for w in lods))

    co = np.concatenate(col_offset).astype(np.int32)
    cr = np.concatenate(col_runs).astype(np.int32)
    runs = np.concatenate(runs_parts).astype(np.int32)
    n_cols = co.shape[0]
    rec = np.zeros((n_cols, REC), np.int32)
    rec[:, 0] = cr
    rec[:, 1] = co
    rec[:, 2] = np.concatenate(col_cols).astype(np.int32)
    rec[:, 3] = np.concatenate(col_min).astype(np.int32)
    rec[:, 4] = np.concatenate(col_max).astype(np.int32)

    max_runs = max(max_runs, 1)
    pad = np.zeros(max_runs, np.int32)  # tail pad: slices never clamp/shift
    runs_fwd = np.concatenate([runs, pad])
    runs_bwd = np.concatenate([reverse_runs(runs, co, cr), pad])
    colors = np.concatenate(
        [[pack_argb(*skybox_rgb)], *colors_parts]).astype(np.uint32)
    dw = DeviceWorld(
        dims=lods[0].dims,
        lod_levels=lod_levels,
        col_base=col_base,
        grid_z=grid_z,
        col_rec=rec,
        runs=runs_fwd,
        runs_rev=runs_bwd,
        colors=colors,
        max_runs=max_runs,
        lod0_voxels=int(lods[0].colors.shape[0]),
    )
    dw.occ_tiles, dw.tile_base, dw.tile_gz = build_occ_tiles(lods)
    n0 = lods[0].col_runs.shape[0]
    dw.empty_frac = float((lods[0].col_runs == 0).sum() / max(n0, 1))
    occ_any = cr > 0
    if occ_any.any():
        dw.solid_min_y = float(rec[occ_any, 3].min())
        dw.solid_max_y = float(rec[occ_any, 4].max())
    if max_runs <= INLINE_MAX_RUNS:
        # per-column voxel-color count = sum of the column's solid-run lengths
        # (offsets are NOT monotone in column order for voxel-soup worlds)
        solid_len = np.where(runs_fwd >= 0, runs_fwd & 0xFFFF, 0).astype(np.int64)
        csum = np.concatenate([[0], np.cumsum(solid_len)])
        off64 = co.astype(np.int64)
        col_colors = csum[off64 + cr] - csum[off64]
        max_cc = int(col_colors.max()) if col_colors.size else 0
        mcc = max_cc if inline_colors and 0 < max_cc <= INLINE_MAX_COLORS else 0
        dw.rec_fwd = _inline_records(rec, runs_fwd, max_runs, colors, mcc)
        dw.rec_rev = _inline_records(rec, runs_bwd, max_runs, colors, mcc)
        dw.max_col_colors = mcc
        dw.col_rec = dw.runs = dw.runs_rev = None
    return dw


def packed_run_words(max_runs: int, max_cc: int = 0) -> int:
    """Run-region width in int32 words for the inline record, and whether the
    16-bit two-runs-per-word packing applies.  Packing halves the run region
    (run -> air bit | 15-bit length; the color index is RECONSTRUCTED after the
    fetch by a cumulative sum of solid lengths — raymarch._fetch_columns), and
    is used exactly when it shrinks the row padded to 8 ints."""
    rw_full = ((REC_META + max_runs + max_cc + 7) // 8) * 8
    w_packed = (max_runs + 1) // 2
    rw_packed = ((REC_META + w_packed + max_cc + 7) // 8) * 8
    return w_packed if rw_packed < rw_full else max_runs


def _inline_records(rec: np.ndarray, runs: np.ndarray, max_runs: int,
                    colors: np.ndarray, max_cc: int = 0) -> np.ndarray:
    """Pack [n_runs, color_off, cmin, cmax, run0..run_{max_runs-1}
    (, argb0..argb_{max_cc-1})] per column into one row padded to a multiple
    of 8 ints.  Inline colors carry the alpha MSB cleared (see
    INLINE_MAX_COLORS).  When packed_run_words() says the 16-bit packing
    shrinks the row, two runs ride per int32 word."""
    n_cols = rec.shape[0]
    k = np.arange(max_runs, dtype=np.int64)[None, :]
    idx = rec[:, 1].astype(np.int64)[:, None] + k  # run_offset + k (tail-padded)
    vals = runs[np.minimum(idx, runs.shape[0] - 1)]
    vals = np.where(k < rec[:, 0:1], vals, 0)

    rwords = packed_run_words(max_runs, max_cc)
    if rwords != max_runs:  # 16-bit packing
        length = vals & np.int32(0xFFFF)
        assert int(length.max(initial=0)) < 0x8000, "run length needs 15 bits"
        half = (length | np.where(vals < 0, np.int32(0x8000), np.int32(0))
                ).astype(np.uint32)
        if max_runs % 2:
            half = np.concatenate(
                [half, np.zeros((n_cols, 1), np.uint32)], axis=1)
        words = (half[:, 0::2] | (half[:, 1::2] << np.uint32(16))
                 ).astype(np.uint32).view(np.int32)
    else:
        words = vals

    rw = ((REC_META + rwords + max_cc + 7) // 8) * 8
    out = np.zeros((n_cols, rw), np.int32)
    out[:, 0] = rec[:, 0]
    out[:, 1] = rec[:, 2]  # color_off
    out[:, 2] = rec[:, 3]  # world min
    out[:, 3] = rec[:, 4]  # world max
    out[:, REC_META:REC_META + rwords] = words
    if max_cc:
        kc = np.arange(max_cc, dtype=np.int64)[None, :]
        cidx = rec[:, 2].astype(np.int64)[:, None] + kc  # global color offset
        cvals = (colors[np.minimum(cidx, colors.shape[0] - 1)]
                 & np.uint32(0x7FFFFFFF)).astype(np.int32)
        out[:, REC_META + rwords:REC_META + rwords + max_cc] = cvals
    return out
