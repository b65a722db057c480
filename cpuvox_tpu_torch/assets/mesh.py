"""Triangle-soup mesh container and world-fit rescale.

Reference: Assets/Code/Utils/SimpleMesh.cs — raw-pointer vertex storage (:13-31), a Burst
rescale kernel (:62-106), and a .mtl material lib with point-sampled diffuse textures
(:116-219).  Here the mesh is numpy arrays and rescale is vectorized numpy.

A copy of ``cpuvox_tpu/assets/mesh.py`` (plain numpy): the port keeps its own
copy and imports nothing of the JAX package.  ``tests/test_torch_copies.py``
holds the two equal.
"""
from __future__ import annotations

import dataclasses

import numpy as np

F = np.float32


@dataclasses.dataclass
class Material:
    name: str
    index: int
    diffuse: np.ndarray | None = None  # (H, W, 4) uint8 RGBA or None

    def sample_diffuse(self, uv: np.ndarray) -> np.ndarray:
        """Point-sample like SimpleMesh.Material.GetDiffusePixel (SimpleMesh.cs:130-134):
        pixel = floor(uv * (size-1)).  Returns float RGBA in 0..1, shape (..., 4)."""
        h, w = self.diffuse.shape[:2]
        uv = np.asarray(uv, F)
        px = np.clip(np.floor(uv[..., 0] * (w - 1)).astype(np.int64), 0, w - 1)
        py = np.clip(np.floor(uv[..., 1] * (h - 1)).astype(np.int64), 0, h - 1)
        return self.diffuse[py, px].astype(F) / F(255.0)


@dataclasses.dataclass
class SimpleMesh:
    """Unindexed triangle soup: 3 consecutive vertices per triangle."""

    positions: np.ndarray  # (n, 3) float32
    colors: np.ndarray  # (n, 4) uint8 RGBA vertex colors (white if absent)
    uvs: np.ndarray  # (n, 2) float32
    material_index: np.ndarray  # (n,) int32, -1 = none
    materials: list[Material] = dataclasses.field(default_factory=list)

    @property
    def vertex_count(self) -> int:
        return self.positions.shape[0]

    @property
    def triangle_count(self) -> int:
        return self.positions.shape[0] // 3


def next_power_of_two(v: int) -> int:
    if v <= 0:
        return 0
    return 1 << int(np.ceil(np.log2(v))) if (v & (v - 1)) else v


def rescale(mesh: SimpleMesh, max_dimension: float, flips=(True, False, False)):
    """Rescale/reposition mesh to fill 0..max_dimension; snap world dims to pow2.

    Mirrors SimpleMesh.Remap_Internal (SimpleMesh.cs:64-106): AABB -> scale by
    max_dimension / cmax(size) -> dims = NextPowerOfTwo((int)(size*scale)) -> translate
    to origin -> flip selected axes as v = dim - v.  The reference UI default flips X
    (UnityManager.cs:27, "text in meshes is inverted otherwise" :310).

    Returns the world dims (X, Y, Z).  Degenerate axes are clamped to >= 1 (the
    reference would produce a 0-dim world and fail downstream).
    """
    p = mesh.positions.astype(F)
    mn = p.min(axis=0)
    mx = p.max(axis=0)
    size = mx - mn
    scale = F(max_dimension) / np.max(size)
    dims = tuple(max(1, next_power_of_two(int(s * scale))) for s in size)
    p = (p - mn) * scale
    for axis in range(3):
        if flips[axis]:
            p[:, axis] = F(dims[axis]) - p[:, axis]
    mesh.positions = p
    return dims
