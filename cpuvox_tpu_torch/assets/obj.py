"""Streaming .obj importer.

Reference: Assets/Code/Utils/ObjModel.cs:10-196 — parses `v` (with optional vertex RGB),
`vt`, `f` with 1/2/3-entry faces, `mtllib`/`usemtl`; emits an unindexed triangle soup.

Differences from the reference (documented deviations):
- negative (relative) face indices resolve per the .obj spec (-1 = last defined vertex);
  the reference parses them (ObjModel.cs:173-196) but would throw on lookup.
- faces with >3 vertices are fan-triangulated; the reference silently reads only the
  first 3 entries.

A native C++ fast path lives in csrc/ (see cpuvox_tpu_torch.assets.native); this
pure-python parser is the portable fallback and the correctness reference for it.

A copy of ``cpuvox_tpu/assets/obj.py`` (plain numpy): the port keeps its own
copy and imports nothing of the JAX package.  ``tests/test_torch_copies.py``
holds the two equal.
"""
from __future__ import annotations

import os

import numpy as np

from .mesh import Material, SimpleMesh

F = np.float32


def _load_mtllib(obj_path: str, rel: str) -> list[Material]:
    """SimpleMesh.MaterialLib.ParseFromObj (SimpleMesh.cs:151-218)."""
    materials: list[Material] = []
    lib_path = os.path.join(os.path.dirname(os.path.abspath(obj_path)), rel.strip())
    if not os.path.exists(lib_path):
        return materials
    cur: Material | None = None
    with open(lib_path, "r", errors="replace") as f:
        for line in f:
            line = line.strip()
            if line.startswith("newmtl "):
                cur = Material(name=line[len("newmtl "):], index=len(materials))
                materials.append(cur)
            elif line.startswith("map_Kd ") and cur is not None:
                arg = line[len("map_Kd "):]
                if arg.startswith("-bm"):  # skip bump-multiplier option (:195-203)
                    arg = arg.split(None, 2)[-1]
                img_path = os.path.join(os.path.dirname(lib_path), arg)
                try:
                    from PIL import Image

                    img = Image.open(img_path).convert("RGBA")
                    cur.diffuse = np.asarray(img, dtype=np.uint8)
                except Exception:
                    cur.diffuse = None
    return materials


def import_obj(path: str, swap_yz: bool = False,
               use_native: bool = True) -> SimpleMesh:
    """Import an .obj as an unindexed triangle soup.

    Uses the native C++ parser (csrc/voxio.cpp via assets.native) when available —
    the reference reports ~30 s for the 800 MB powerplant with its C# reader
    (README.md:69); the native path parses at >200 MB/s.  Falls back to the
    pure-python reference parser below.
    """
    if use_native:
        from . import native

        parsed = None
        if native.available():
            parsed = native.parse_obj(path, swap_yz)
        if parsed is not None:
            positions, colors, uvs, mats, mtllib, names = parsed
            materials: list[Material] = []
            if mtllib and names:
                by_name = {m.name: m for m in _load_mtllib(path, mtllib)}
                for i, name in enumerate(names):
                    m = by_name.get(name, Material(name=name, index=i))
                    m.index = i
                    materials.append(m)
            return SimpleMesh(positions=positions, colors=colors, uvs=uvs,
                              material_index=mats, materials=materials)
    return _import_obj_python(path, swap_yz)


def _import_obj_python(path: str, swap_yz: bool = False) -> SimpleMesh:
    positions: list[list[float]] = []
    colors: list[list[float]] = []
    uvs: list[list[float]] = []

    out_pos: list[int] = []  # indices into positions per emitted vertex
    out_uv: list[int] = []  # indices into uvs, -1 = none
    out_mat: list[int] = []

    materials: list[Material] = []
    mat_by_name: dict[str, int] = {}
    active_mat = -1

    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                x, y, z = float(parts[1]), float(parts[2]), float(parts[3])
                if swap_yz:
                    y, z = z, y
                positions.append([x, y, z])
                if len(parts) > 6:  # vertex-color extension (ObjModel.cs:71-75)
                    colors.append([float(parts[4]), float(parts[5]), float(parts[6])])
                else:
                    colors.append([1.0, 1.0, 1.0])
            elif line.startswith("vt "):
                parts = line.split()
                uvs.append([float(parts[1]), float(parts[2])])
            elif line.startswith("f "):
                entries = line.split()[1:]
                idx = []
                for e in entries:
                    comps = e.split("/")
                    vi = int(comps[0])
                    vi = vi - 1 if vi > 0 else len(positions) + vi
                    ti = -1
                    if len(comps) > 1 and comps[1]:
                        t = int(comps[1])
                        ti = t - 1 if t > 0 else len(uvs) + t
                    idx.append((vi, ti))
                for k in range(1, len(idx) - 1):  # fan triangulation
                    for vi, ti in (idx[0], idx[k], idx[k + 1]):
                        out_pos.append(vi)
                        out_uv.append(ti)
                        out_mat.append(active_mat)
            elif line.startswith("mtllib "):
                materials = _load_mtllib(path, line[len("mtllib "):])
                mat_by_name = {m.name: m.index for m in materials}
            elif line.startswith("usemtl "):
                active_mat = mat_by_name.get(line[len("usemtl "):].strip(), -1)

    pos_arr = np.asarray(positions, F).reshape(-1, 3)
    col_arr = np.asarray(colors, F).reshape(-1, 3)
    uv_arr = np.asarray(uvs, F).reshape(-1, 2) if uvs else np.zeros((0, 2), F)

    pi = np.asarray(out_pos, np.int64)
    ui = np.asarray(out_uv, np.int64)
    v_pos = pos_arr[pi] if pi.size else np.zeros((0, 3), F)
    v_col255 = np.clip(np.round(col_arr[pi] * 255.0), 0, 255).astype(np.uint8) \
        if pi.size else np.zeros((0, 3), np.uint8)
    v_col = np.concatenate([v_col255, np.full((v_col255.shape[0], 1), 255, np.uint8)],
                           axis=1)
    v_uv = np.zeros((pi.size, 2), F)
    has_uv = ui >= 0
    if uv_arr.shape[0]:
        v_uv[has_uv] = uv_arr[ui[has_uv]]
    v_mat = np.asarray(out_mat, np.int32) if pi.size else np.zeros(0, np.int32)

    return SimpleMesh(positions=v_pos, colors=v_col, uvs=v_uv, material_index=v_mat,
                      materials=materials)
