"""Run-length-encoded column voxel world as packed arrays.

The reference stores a column-major RLE world behind raw pointers: per-column header
{storage offset, runCount, worldMin, worldMax} and a packed ``<guard><runs><guard><colors>``
allocation per column (Assets/Code/World.cs:161-240), with air runs encoded as
``ColorsIndex < 0`` (World.cs:258).  The TPU-native layout replaces pointers with flat
int arrays so columns are fetched by gather / DMA:

- ``col_offset[n_cols]``        start of the column's runs in ``runs``
- ``col_runs[n_cols]``          run count (0 = empty column; reference returns runCount)
- ``col_color_offset[n_cols]``  start of the column's colors in ``colors``
- ``col_min/col_max[n_cols]``   solid world-Y bounds scaled by voxel size (World.cs:211-233)
- ``runs[total_runs]``          int32, packed ``(colors_index << 16) | length``; air runs
                                have colors_index == -1 (sign bit = air test, one load)
- ``colors[total_colors]``      uint32 ARGB, per-run colors stored top-voxel-first
                                (matches the u=0-at-top perspective indexing in
                                DrawSegmentRayJob.cs:530)

Column index for (x, z) at LOD L: ``(x >> L) * (Z >> L) + (z >> L)``
(World.cs:145-149: indexingMulX = dimensions.z >> lod).

No guard elements are stored — the kernels use run counts, not sentinel termination.

The benchmark's frozen copy of ``cpuvox_tpu_torch/world/rle.py`` (plain
numpy), kept under the benchmark so that a change to the program cannot
move the yardstick; ``voxbench/tests/test_voxbench_copies.py`` holds it
equal to the program's at a small size.
"""
from __future__ import annotations

import dataclasses

import numpy as np

AIR = np.int32(-1)


def pack_run(colors_index: int, length: int) -> np.int32:
    return np.int32((np.int32(colors_index) << np.int32(16)) | np.int32(length))


def run_length(run):
    return np.asarray(run, np.int32) & np.int32(0xFFFF)


def run_colors_index(run):
    return np.asarray(run, np.int32) >> np.int32(16)  # arithmetic shift: air stays < 0


def run_is_air(run):
    return np.asarray(run, np.int32) < 0


@dataclasses.dataclass
class WorldLOD:
    """One LOD level of the world (reference: one ``World`` struct per LOD)."""

    dims: tuple[int, int, int]  # full-resolution (X, Y, Z), powers of two
    lod: int
    col_offset: np.ndarray  # int32 [n_cols]
    col_runs: np.ndarray  # int32 [n_cols]
    col_color_offset: np.ndarray  # int32 [n_cols]
    col_min: np.ndarray  # int32 [n_cols], world-Y units
    col_max: np.ndarray  # int32 [n_cols]
    runs: np.ndarray  # int32 [total_runs]
    colors: np.ndarray  # uint32 [total_colors]

    @property
    def grid_dims(self) -> tuple[int, int]:
        return (self.dims[0] >> self.lod, self.dims[2] >> self.lod)

    @property
    def n_cols(self) -> int:
        gx, gz = self.grid_dims
        return gx * gz

    @property
    def height(self) -> int:
        """Column height in LOD voxel units."""
        return self.dims[1] >> self.lod

    @property
    def voxel_scale(self) -> int:
        return 1 << self.lod

    @property
    def voxel_count(self) -> int:
        return int(self.colors.shape[0])

    def column_index(self, x: int, z: int) -> int:
        return (x >> self.lod) * (self.dims[2] >> self.lod) + (z >> self.lod)


def get_column(world: WorldLOD, x: int, z: int):
    """Fetch one column's (runs, colors) as numpy arrays; ([], []) if empty.

    Host-side accessor used by the oracle and tests (World.GetVoxelColumn, World.cs:130-142
    — the -1 out-of-bounds case is handled by callers here).
    """
    i = world.column_index(x, z)
    n = int(world.col_runs[i])
    if n == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.uint32)
    o = int(world.col_offset[i])
    co = int(world.col_color_offset[i])
    runs = world.runs[o : o + n]
    n_colors = int(np.sum(run_length(runs)[~run_is_air(runs)]))
    return runs, world.colors[co : co + n_colors]


def _dedupe_and_average(xz: np.ndarray, y: np.ndarray, rgba: np.ndarray):
    """Sort voxels by (column, -y) and merge duplicates by channel-mean.

    Mirrors WordBuilder.RLEColumnBuilder.ToFinalColumn's sort-descending + dedupe with
    truncating integer color averaging (WordBuilder.cs:186-228).
    Returns (xz_d, y_d, color_d_packed_uint32) deduped arrays in (xz asc, y desc) order.
    """
    xz = np.asarray(xz, np.int64)
    y = np.asarray(y, np.int64)
    # single combined int64 key + stable argsort (numpy radix-sorts integer
    # keys): ~5x faster than np.lexsort's per-key mergesort at 10M+ voxels,
    # identical order ((xz asc, y desc); key fits: xz < 2^40, y < 2^23)
    ymax = np.int64(y.max()) if y.size else np.int64(0)
    key = xz * (ymax + 1) + (ymax - y)
    order = np.argsort(key, kind="stable")
    xz, y = xz[order], y[order]
    r, g, b = (np.asarray(c, np.int64)[order] for c in rgba[:3])

    new = np.empty(xz.shape[0], bool)
    new[0] = True
    new[1:] = (xz[1:] != xz[:-1]) | (y[1:] != y[:-1])
    gid = np.cumsum(new) - 1
    n_groups = int(gid[-1]) + 1 if gid.size else 0
    counts = np.bincount(gid, minlength=n_groups)
    rs = np.bincount(gid, weights=r, minlength=n_groups).astype(np.int64) // counts
    gs = np.bincount(gid, weights=g, minlength=n_groups).astype(np.int64) // counts
    bs = np.bincount(gid, weights=b, minlength=n_groups).astype(np.int64) // counts
    color = ((np.uint32(255) << 24) | (rs.astype(np.uint32) << 16)
             | (gs.astype(np.uint32) << 8) | bs.astype(np.uint32))
    return xz[new], y[new], color


def build_lod_from_voxels(
    dims: tuple[int, int, int], lod: int, xz_index, y, colors_rgb
) -> WorldLOD:
    """Build one WorldLOD from a flat voxel soup.

    Args:
      dims: full-resolution world dims (powers of two).
      lod: LOD level of the produced world; y and xz_index are in LOD units
           (xz_index = (x >> lod) * (Z >> lod) + (z >> lod)).
      xz_index, y: int arrays of voxel coordinates (duplicates allowed — they are merged
           with color averaging, as in WordBuilder.cs:193-228).
      colors_rgb: (r, g, b) arrays of uint8 channel values.

    This is the vectorized equivalent of WorldBuilder.ToLOD0World + ToFinalColumn
    (WordBuilder.cs:99-268): per column, descending-Y voxels are compressed into solid
    runs with interleaved air runs from the column top, plus a trailing air run.
    """
    X, Y, Z = dims
    gx, gz = X >> lod, Z >> lod
    n_cols = gx * gz
    height = Y >> lod
    top_y = height - 1

    xz_index = np.asarray(xz_index)
    if xz_index.size == 0:
        z0 = np.zeros(n_cols, np.int32)
        return WorldLOD(dims, lod, z0, z0.copy(), z0.copy(), z0.copy(), z0.copy(),
                        np.zeros(0, np.int32), np.zeros(0, np.uint32))

    xz_d, y_d, color_d = _dedupe_and_average(xz_index, y, colors_rgb)

    # solid runs: consecutive descending y within a column
    new_run = np.empty(xz_d.shape[0], bool)
    new_run[0] = True
    new_run[1:] = (xz_d[1:] != xz_d[:-1]) | (y_d[:-1] - y_d[1:] != 1)
    run_start = np.nonzero(new_run)[0]
    run_end = np.append(run_start[1:], xz_d.shape[0])
    s_len = (run_end - run_start).astype(np.int64)
    s_col = xz_d[run_start]
    s_top = y_d[run_start]
    s_bottom = s_top - s_len + 1

    # per-column grouping of solid runs
    new_col = np.empty(s_col.shape[0], bool)
    new_col[0] = True
    new_col[1:] = s_col[1:] != s_col[:-1]
    first_in_col = new_col
    col_ord = np.cumsum(new_col) - 1  # dense ordinal of occupied columns, per solid run

    # air before each solid run (WordBuilder.cs:236-240): from column top for the first
    # run, else from below the previous run's bottom
    air_before = np.where(
        first_in_col, top_y - s_top, np.concatenate([[0], s_bottom[:-1] - 1]) - s_top
    ).astype(np.int64)

    # trailing air per occupied column (WordBuilder.cs:256-258)
    last_in_col = np.append(new_col[1:], True)
    occ_cols = s_col[first_in_col]
    trailing = s_bottom[last_in_col]  # bottom voxel y == air run length below it
    has_trailing = trailing > 0

    # destination layout: per solid run emit (air? , solid); per column append trailing
    emit = 1 + (air_before > 0).astype(np.int64)
    trail_before = np.cumsum(has_trailing) - has_trailing  # per occupied column ordinal
    dest = np.cumsum(emit) - emit + trail_before[col_ord]
    total_runs = int(emit.sum() + has_trailing.sum())

    runs = np.zeros(total_runs, np.int32)
    has_air = air_before > 0
    air_packed = (np.int64(-1 << 16) | air_before).astype(np.int32)
    runs[dest[has_air]] = air_packed[has_air]

    # colors_index of a solid run = deduped voxel count before it within its column
    vox_cum = np.cumsum(s_len) - s_len  # global deduped index of run start
    col_first_vox = vox_cum[first_in_col][col_ord]
    colors_index = vox_cum - col_first_vox
    solid_packed = ((colors_index << 16) | s_len).astype(np.int32)
    runs[dest + has_air] = solid_packed

    trail_dest = (np.cumsum(emit)[last_in_col] + trail_before[col_ord[last_in_col]])
    trail_packed = (np.int64(-1 << 16) | trailing).astype(np.int32)
    runs[trail_dest[has_trailing]] = trail_packed[has_trailing]

    # per-column tables (dense over all n_cols; empty columns keep zeros)
    runs_per_col = np.bincount(col_ord, weights=emit, minlength=col_ord[-1] + 1).astype(
        np.int64
    ) + has_trailing
    col_runs = np.zeros(n_cols, np.int32)
    col_runs[occ_cols] = runs_per_col
    col_offset = np.zeros(n_cols, np.int32)
    col_offset[occ_cols] = np.cumsum(runs_per_col) - runs_per_col
    col_color_offset = np.zeros(n_cols, np.int32)
    col_color_offset[occ_cols] = vox_cum[first_in_col]

    voxel_scale = 1 << lod
    col_min = np.zeros(n_cols, np.int32)
    col_max = np.zeros(n_cols, np.int32)
    col_min[occ_cols] = s_bottom[last_in_col] * voxel_scale  # lowest solid bottom
    col_max[occ_cols] = (s_top[first_in_col] + 1) * voxel_scale  # highest solid top+1

    return WorldLOD(
        dims, lod, col_offset, col_runs, col_color_offset, col_min, col_max, runs,
        color_d.astype(np.uint32),
    )


def _expand_soup(lod0: WorldLOD):
    """LOD0 -> (vox_col, vox_y, (r, g, b)) voxel soup (vectorized expansion);
    None when empty.  Shared by every downsample level."""
    n = lod0.runs.shape[0]
    if n == 0 or lod0.colors.shape[0] == 0:
        return None
    X, Y, Z = lod0.dims
    lengths = run_length(lod0.runs).astype(np.int64)
    is_air = run_is_air(lod0.runs)

    # per-run column id: runs are stored contiguously per occupied column in column order
    run_col = np.zeros(n, np.int64)
    occupied = np.nonzero(lod0.col_runs > 0)[0]
    run_col[lod0.col_offset[occupied]] = 1
    run_col = np.cumsum(run_col) - 1
    occ_of_run = occupied[run_col]

    # per-run top y: height - cumulative length within column
    cum = np.cumsum(lengths)
    col_start_cum = (cum - lengths)[lod0.col_offset[occupied]][run_col]
    top_y = (Y - 1) - ((cum - lengths) - col_start_cum)

    solid = ~is_air
    s_idx = np.nonzero(solid)[0]
    s_lengths = lengths[s_idx]
    # expand each solid run into voxels (descending y, colors already top-first)
    voxel_run = np.repeat(s_idx, s_lengths)
    within = np.arange(voxel_run.shape[0], dtype=np.int64)
    starts = np.cumsum(s_lengths) - s_lengths
    within -= np.repeat(starts, s_lengths)
    vox_y = top_y[voxel_run] - within
    vox_col = occ_of_run[voxel_run]

    c = lod0.colors  # colors are stored in deduped voxel order == expansion order
    r = (c >> 16) & 0xFF
    g = (c >> 8) & 0xFF
    b = c & 0xFF
    return vox_col, vox_y, (r, g, b)


def downsample(lod0: WorldLOD, extra_lods: int, soup=None) -> WorldLOD:
    """Build LOD ``extra_lods`` from LOD0 (World.DownSample, World.cs:45-127).

    Each output column merges a 2^L x 2^L block of LOD0 columns; voxel Y is collapsed by
    ``>> L``; duplicate (column, y) voxels are merged with color averaging — identical
    semantics to routing every source voxel through RLEColumnBuilder.SetVoxel
    (World.cs:101-127) and rebuilding.  ``soup`` is an optional precomputed
    ``_expand_soup(lod0)`` (the expansion is shared across the LOD chain).
    """
    if lod0.lod != 0:
        raise ValueError("downsample always runs from LOD0 (as the reference does)")
    X, Y, Z = lod0.dims
    L = extra_lods
    if soup is None:
        soup = _expand_soup(lod0)
    if soup is None:
        return build_lod_from_voxels(lod0.dims, L, np.zeros(0, np.int64),
                                     np.zeros(0, np.int64),
                                     (np.zeros(0, np.uint8),) * 3)
    vox_col, vox_y, rgb = soup
    gz0 = Z  # LOD0 grid z-dim
    vox_x = vox_col // gz0
    vox_z = vox_col % gz0
    new_xz = (vox_x >> L) * (Z >> L) + (vox_z >> L)
    new_y = vox_y >> L
    return build_lod_from_voxels(lod0.dims, L, new_xz, new_y, rgb)


def build_lod_chain(lod0: WorldLOD, lod_levels: int = 6) -> list[WorldLOD]:
    """LOD0 + downsamples 1..lod_levels-1 (UnityManager.cs:328-331)."""
    soup = _expand_soup(lod0)
    return [lod0] + [downsample(lod0, j, soup) for j in range(1, lod_levels)]


def validate_world(world: WorldLOD) -> None:
    """Assert the structural invariants the renderer relies on.

    - per-column run lengths sum to the column height (guards the RLE build)
    - solid-run color indices tile the column's color block contiguously
    - col_min/col_max match the solid extents (World.cs:211-233)
    """
    height = world.height
    for i in np.nonzero(world.col_runs)[0]:
        o, n = int(world.col_offset[i]), int(world.col_runs[i])
        runs = world.runs[o : o + n]
        lens = run_length(runs).astype(int)
        assert lens.sum() == height, f"column {i}: run lengths {lens.sum()} != {height}"
        assert np.all(lens > 0), f"column {i}: zero-length run"
        air = run_is_air(runs)
        cidx = run_colors_index(runs)
        assert np.all(cidx[air] == -1)
        expect = np.cumsum(np.where(air, 0, lens)) - np.where(air, 0, lens)
        assert np.all(cidx[~air] == expect[~air]), f"column {i}: colorsIndex mismatch"
        # world min/max
        tops = height - (np.cumsum(lens) - lens)
        bottoms = tops - lens
        vs = world.voxel_scale
        assert world.col_min[i] == bottoms[~air].min() * vs
        assert world.col_max[i] == tops[~air].max() * vs
    empty = world.col_runs == 0
    assert np.all(world.col_min[empty] == 0) and np.all(world.col_max[empty] == 0)
