"""Binary `.world` persistence.

The reference memory-maps the raw allocator blobs of all LOD worlds with a header +
(offset, length) table (Assets/Code/WorldSaveFile.cs:8-103); that format depends on C#
struct layout and raw pointers.  We keep the same logical shape — header, per-LOD
offset table, zero-parse array blobs — but define a stable packed little-endian layout
(SURVEY.md §5 "Checkpoint / resume").

Layout (little-endian):
  magic  u32 = 0x54505658 ('XVPT')     version u32 = 1
  dimX, dimY, dimZ u32                 lod_count u32
  per lod: n_cols u64, n_runs u64, n_colors u64
  per lod blobs, in order:
    col_offset i32[n_cols] | col_runs i32[n_cols] | col_color_offset i32[n_cols]
    col_min i32[n_cols]    | col_max i32[n_cols]
    runs i32[n_runs]       | colors u32[n_colors]

Load is np.fromfile into flat arrays + views — no per-element parsing, mirroring the
reference's mmap + pointer-rewrap load (WorldSaveFile.cs:57-94).

A copy of ``cpuvox_tpu/world/save.py`` (plain numpy): the port keeps its own
copy and imports nothing of the JAX package.  ``tests/test_torch_copies.py``
holds the two equal.
"""
from __future__ import annotations

import struct

import numpy as np

from .rle import WorldLOD

MAGIC = 0x54505658
VERSION = 1


def save_world(path: str, lods: list[WorldLOD]) -> None:
    d = lods[0].dims
    with open(path, "wb") as f:
        f.write(struct.pack("<IIIIII", MAGIC, VERSION, d[0], d[1], d[2], len(lods)))
        for w in lods:
            f.write(struct.pack("<QQQ", w.n_cols, w.runs.shape[0], w.colors.shape[0]))
        for w in lods:
            for arr, dt in [
                (w.col_offset, "<i4"), (w.col_runs, "<i4"), (w.col_color_offset, "<i4"),
                (w.col_min, "<i4"), (w.col_max, "<i4"),
                (w.runs, "<i4"), (w.colors, "<u4"),
            ]:
                f.write(np.ascontiguousarray(arr, dtype=dt).tobytes())


def load_world(path: str) -> list[WorldLOD]:
    with open(path, "rb") as f:
        magic, version, dx, dy, dz, lod_count = struct.unpack("<IIIIII", f.read(24))
        if magic != MAGIC:
            raise ValueError(f"{path}: not a cpuvox_tpu .world file")
        if version != VERSION:
            raise ValueError(f"{path}: unsupported version {version}")
        sizes = [struct.unpack("<QQQ", f.read(24)) for _ in range(lod_count)]
        lods = []
        for lod, (n_cols, n_runs, n_colors) in enumerate(sizes):
            def rd(count, dt):
                arr = np.fromfile(f, dtype=dt, count=count)
                if arr.shape[0] != count:
                    raise ValueError(f"{path}: truncated file (lod {lod})")
                return arr

            col_offset = rd(n_cols, "<i4")
            col_runs = rd(n_cols, "<i4")
            col_color_offset = rd(n_cols, "<i4")
            col_min = rd(n_cols, "<i4")
            col_max = rd(n_cols, "<i4")
            runs = rd(n_runs, "<i4")
            colors = rd(n_colors, "<u4")
            w = WorldLOD((dx, dy, dz), lod, col_offset, col_runs, col_color_offset,
                         col_min, col_max, runs, colors)
            if w.n_cols != n_cols:
                raise ValueError(f"{path}: lod {lod} column count mismatch")
            lods.append(w)
        return lods
