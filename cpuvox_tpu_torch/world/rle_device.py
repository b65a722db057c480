"""The LOD chain built on the device, in torch: output-identical to rle.py.

The counterpart of ``cpuvox_tpu/world/rle_device.py``: the voxel soup ->
RLE -> LOD chain pipeline as integer tensor programs (stable sorts, segment
sums, prefix sums; no float rounding anywhere), and only the packed tables
cross to the host, where ``_to_world_lod`` (a numpy copy of the reference's)
builds each ``WorldLOD``.

Layout, as in rle.py:
- dedupe key: xz * (ymax+1) + (ymax - y), sorted stably: (xz asc, y desc);
- averaging: truncating integer channel means (sum // count);
- runs: air-before + solid per run, trailing air per column;
- the LOD-L soup is the LOD0 *deduped* voxel set with (x>>L, z>>L, y>>L)
  coordinates, identical to rle._expand_soup + downsample.

Cascade (the default): each level >= 1 is built from the previous level's
deduped voxels with their channel sums and LOD0 source counts carried, since
every LOD-L color is the floor mean of the LOD0-averaged channels over the
LOD0 voxels in its 2^L cube.  The sums are int64: a 2^L cube holds up to
8^L LOD0 voxels, and 255 * 8^L passes 2^31 at L = 8, where int32 sums (the
JAX package's) wrap and numpy's f64 ``bincount`` stays exact.
``cascade=False`` builds every level from the whole LOD0 deduped soup, the
same level function with a larger shift.

The JAX version's padding (fixed-shape buckets, pad keys, the empty-segment
fill of its segment maximum) and its bucketed transfers exist for the TPU's
fixed shapes and its host link; here every tensor has its exact size.
"""
from __future__ import annotations

import numpy as np
import torch

from .rle import WorldLOD

_I64 = torch.int64


def _sort_soup(key: torch.Tensor, *cargo: torch.Tensor):
    """``key`` sorted stably (equal keys keep their order, as
    ``np.argsort(kind="stable")`` and ``lax.sort`` do) and each cargo tensor
    in that order."""
    key_s, perm = torch.sort(key, stable=True)
    return (key_s, *(c[perm] for c in cargo))


def _firsts(*keys: torch.Tensor) -> torch.Tensor:
    """Where a run of equal values starts, in any of ``keys`` (sorted)."""
    new = torch.zeros_like(keys[0], dtype=torch.bool)
    new[0] = True
    for k in keys:
        new[1:] |= k[1:] != k[:-1]
    return new


def _level(xz, y, sums, height: int, lod: int):
    """One LOD from a voxel soup at that LOD's coordinates: ``xz`` the
    column index, ``y`` the height (both int64), ``sums`` (4, N) int64 the
    red, green and blue channel sums and the LOD0 source count of each row.

    Returns the packed tables of ``_to_world_lod`` (colors, runs3, tab_col
    and the three counts) and the deduped voxels with their sums (xz_d,
    y_d, sums_d), the next cascade level's input."""
    dev = xz.device
    if xz.shape[0] == 0:
        z = torch.zeros(0, dtype=_I64, device=dev)
        return dict(colors=z.to(torch.int32), runs3=z.to(torch.int32),
                    tab_col=torch.zeros((0, 3), dtype=_I64, device=dev),
                    n_dedupe=0, n_runs_total=0, n_occ=0, xz_d=z, y_d=z,
                    sums_d=torch.zeros((4, 0), dtype=_I64, device=dev))
    top_y = height - 1

    # ---- dedupe and average (rle._dedupe_and_average)
    ymax = y.max()
    key_s, xz_s, y_s, sums_s = _sort_soup(xz * (ymax + 1) + (ymax - y), xz, y,
                                          sums.T)
    new = _firsts(key_s)
    gid = torch.cumsum(new, 0) - 1
    n_dedupe = int(gid[-1]) + 1
    sums_d = torch.zeros((n_dedupe, 4), dtype=_I64, device=dev).index_add_(
        0, gid, sums_s).T.contiguous()
    mean = torch.div(sums_d[:3], sums_d[3], rounding_mode="floor")
    # ARGB with alpha 255 is >= 2^31: its int32 bits are the value - 2^32
    colors = ((255 << 24) | (mean[0] << 16) | (mean[1] << 8) | mean[2]) \
        - (1 << 32)
    xz_d, y_d = xz_s[new], y_s[new]

    # ---- solid runs: consecutive descending y within a column
    new_run = _firsts(xz_d)
    new_run[1:] |= y_d[:-1] - y_d[1:] != 1
    run_start = torch.nonzero(new_run).squeeze(1)
    run_end = torch.cat([run_start[1:], run_start.new_tensor([n_dedupe])])
    s_len = run_end - run_start
    s_col = xz_d[run_start]
    s_top = y_d[run_start]
    s_bottom = s_top - s_len + 1

    # ---- per-column grouping (rle.build_lod_from_voxels)
    new_col = _firsts(s_col)
    col_ord = torch.cumsum(new_col, 0) - 1
    n_occ = int(col_ord[-1]) + 1
    prev_bottom = torch.cat([s_bottom.new_zeros(1), s_bottom[:-1]])
    air_before = torch.where(new_col, top_y - s_top, prev_bottom - 1 - s_top)
    has_air = air_before > 0
    last_in_col = torch.cat([new_col[1:], new_col.new_ones(1)])
    occ = s_col[new_col]
    trailing = s_bottom[last_in_col]
    has_trailing = trailing > 0

    # ---- run slots: air-before + solid per run, trailing per column
    emit = 1 + has_air.to(_I64)
    emit_cum = torch.cumsum(emit, 0)
    trail_before = torch.cumsum(has_trailing, 0) - has_trailing.to(_I64)
    dest = emit_cum - emit + trail_before[col_ord]
    n_runs = int(emit_cum[-1]) + int(has_trailing.sum())
    runs = torch.zeros(n_runs, dtype=_I64, device=dev)
    runs[dest[has_air]] = (-1 << 16) | air_before[has_air]
    vox_cum = torch.cumsum(s_len, 0) - s_len
    colors_index = vox_cum - vox_cum[new_col][col_ord]
    runs[dest + has_air.to(_I64)] = (colors_index << 16) | s_len
    trail_dest = emit_cum[last_in_col] + trail_before
    runs[trail_dest[has_trailing]] = (-1 << 16) | trailing[has_trailing]

    # ---- the packed column table [occ, runs | cmin << 16, cmax]
    runs_per_col = torch.zeros(n_occ, dtype=_I64, device=dev).index_add_(
        0, col_ord, emit) + has_trailing.to(_I64)
    vs = 1 << lod
    tab_col = torch.stack([occ, runs_per_col | ((trailing * vs) << 16),
                           (s_top[new_col] + 1) * vs], 1)
    return dict(colors=colors.to(torch.int32), runs3=runs.to(torch.int32),
                tab_col=tab_col, n_dedupe=n_dedupe, n_runs_total=n_runs,
                n_occ=n_occ, xz_d=xz_d, y_d=y_d, sums_d=sums_d)


def _channels(colors: torch.Tensor) -> torch.Tensor:
    """(4, N) int64 [r, g, b, 1] of int32 ARGB bits."""
    c = colors.to(_I64) & 0xFFFFFFFF
    return torch.stack([(c >> 16) & 0xFF, (c >> 8) & 0xFF, c & 0xFF,
                        torch.ones_like(c)])


def level0(xz, y, rgbp, valid, dims) -> dict:
    """LOD 0's packed tables on the soup's device (``_level``'s dict).
    Arguments as ``build_lod_chain_device``'s."""
    dims = tuple(int(d) for d in dims)
    if dims[1] > 65535:
        raise ValueError("tab_col packing needs y_dim <= 65535 "
                         f"(got {dims[1]})")
    dev = torch.as_tensor(xz).device
    xz, y, rgbp = (torch.as_tensor(a, device=dev).to(_I64)
                   for a in (xz, y, rgbp))
    if valid is not None:
        valid = torch.as_tensor(valid, device=dev).to(torch.bool)
        xz, y, rgbp = xz[valid], y[valid], rgbp[valid]
    sums = torch.stack([rgbp & 0xFF, (rgbp >> 8) & 0xFF, (rgbp >> 16) & 0xFF,
                        torch.ones_like(rgbp)])
    return _level(xz, y, sums, dims[1], 0)


def chain_levels(out0: dict, dims, lod_levels: int = 6,
                 cascade: bool = True) -> list[dict]:
    """Levels 1..lod_levels-1 from LOD 0's tables (``level0``), on its
    device; returns every level's dict, LOD 0 first.  With ``cascade`` a
    level is built from the one before it, else from LOD 0."""
    Y, Z = int(dims[1]), int(dims[2])
    outs = [out0]
    # LOD 1 averages LOD 0's averaged colors: unit counts
    sums0 = _channels(out0["colors"])
    for L in range(1, lod_levels):
        src = out0 if not cascade or L == 1 else outs[-1]
        shift = L if not cascade else 1
        z_src = Z >> (L - shift)
        x, z = src["xz_d"] // z_src, src["xz_d"] % z_src
        outs.append(_level((x >> shift) * (Z >> L) + (z >> shift),
                           src["y_d"] >> shift,
                           sums0 if src is out0 else src["sums_d"],
                           Y >> L, L))
    return outs


def _to_world_lod(out, dims, lod) -> WorldLOD:
    """One level's packed tables -> a host ``WorldLOD`` (a numpy copy of the
    reference's; the tables come whole, at their exact sizes)."""
    gx, gz = dims[0] >> lod, dims[2] >> lod
    n_cols = gx * gz
    n_runs = int(out["n_runs_total"])
    n_occ = int(out["n_occ"])
    colors = out["colors"].cpu().numpy().view(np.uint32)
    runs = out["runs3"].cpu().numpy().astype(np.int32)
    tab = out["tab_col"].cpu().numpy()
    z0 = np.zeros(n_cols, np.int32)
    col_runs = z0.copy()
    col_offset = z0.copy()
    col_coloroff = z0.copy()
    col_min = z0.copy()
    col_max = z0.copy()
    if n_occ:
        occ = tab[:, 0].astype(np.int64)
        w1 = tab[:, 1].astype(np.int64) & 0xFFFFFFFF  # uint32 bits
        runs_p = (w1 & 0xFFFF).astype(np.int32)
        col_runs[occ] = runs_p
        # col_offset = exclusive cumsum of runs_per_col over the packed
        # occupied list
        off_p = np.cumsum(runs_p.astype(np.int64)) - runs_p
        col_offset[occ] = off_p.astype(np.int32)
        # col_color_offset = exclusive per-column cumsum of solid run lengths
        solid = np.where(runs >= 0, runs & 0xFFFF, 0).astype(np.int64)
        per_col = np.add.reduceat(solid, off_p) if n_runs else \
            np.zeros(n_occ, np.int64)
        col_coloroff[occ] = (np.cumsum(per_col) - per_col).astype(np.int32)
        col_min[occ] = (w1 >> 16).astype(np.int32)
        col_max[occ] = tab[:, 2]
    return WorldLOD(tuple(dims), lod, col_offset, col_runs, col_coloroff,
                    col_min, col_max, runs, colors)


def build_lod_chain_device(xz, y, rgbp, valid, dims, lod_levels: int = 6,
                           cascade: bool = True,
                           on_stage=lambda name, note: None) -> list[WorldLOD]:
    """The whole soup -> LOD chain on the soup's device; returns host
    WorldLODs equal in every field to ``rle.build_lod_chain`` of
    ``rle.build_lod_from_voxels`` on the same soup.

    xz, y, rgbp (r | g << 8 | b << 16): (N,) integer tensors (or arrays) of
    the raw LOD0 voxel soup, duplicates allowed; valid: (N,) bool, the rows
    that hold voxels (None: all).  ``cascade`` as the module doc says.
    ``on_stage(name, note)`` is called as each stage ends: ``"lod0"``,
    ``"cascade"``, ``"host_tables"``."""
    dims = tuple(int(d) for d in dims)
    out0 = level0(xz, y, rgbp, valid, dims)
    on_stage("lod0", f"{out0['n_dedupe']} voxels")
    outs = chain_levels(out0, dims, lod_levels, cascade)
    on_stage("cascade", f"LODs 1..{lod_levels - 1}: "
             f"{[o['n_dedupe'] for o in outs[1:]]} voxels")
    lods = [_to_world_lod(o, dims, L) for L, o in enumerate(outs)]
    on_stage("host_tables", "host tables")
    return lods
