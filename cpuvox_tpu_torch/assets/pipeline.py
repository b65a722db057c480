"""The full mesh->world conversion pipeline (the reference's "Convert" button,
UnityManager.cs:297-361 / SURVEY.md §3.2), on a torch device or in numpy.

The counterpart of ``cpuvox_tpu/assets/pipeline.py``.  The device path
(``device="cuda"`` or ``"cpu"``) voxelizes and builds the LOD chain with
torch on that device; ``device=None`` runs the numpy path (the JAX package's
``device=False``).  Both give the same worlds, field for field.
"""
from __future__ import annotations

import time

import torch

from cpuvox_tpu_torch.world import rle, rle_device
from cpuvox_tpu_torch.world.save import save_world

from . import voxelizer
from .mesh import rescale
from .obj import import_obj


def convert_obj_to_world(
    obj_path: str,
    max_dimension: int = 1024,
    swap_yz: bool = False,
    flips=(True, False, False),
    lod_levels: int = 6,
    save_path: str | None = None,
    verbose: bool = False,
    device="cuda",
    timings: dict | None = None,
):
    """obj -> rescale -> voxelize -> LOD0 RLE build -> LOD chain [-> .world].

    Returns the list of WorldLOD.  Mirrors the reference's stage order and its
    default X-flip (UnityManager.cs:304-334).

    ``device`` names the torch device of the voxelizer and the LOD chain
    (``assets.voxelizer.voxelize_mesh_device``,
    ``world.rle_device.build_lod_chain_device``); None runs them in numpy.
    A mesh with a material is voxelized in numpy whatever the device
    (``voxelizer.textured``).  ``timings``, where given, receives each
    stage's seconds under its name; with ``timings`` or ``verbose`` the
    device is synchronized at the end of each stage, else never.
    """
    dev = None if device is None else torch.device(device)
    timed = timings is not None or verbose
    t0 = time.perf_counter()

    def tick(stage, note):
        nonlocal t0
        if not timed:
            return
        if dev is not None and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        if timings is not None:
            timings[stage] = t1 - t0
        if verbose:
            print(f"{stage}: {note} ; {t1 - t0:.2f}s")
        t0 = t1

    mesh = import_obj(obj_path, swap_yz=swap_yz)
    tick("parse", f"{mesh.vertex_count} vertices")
    dims = rescale(mesh, max_dimension, flips)
    tick("rescale", f"dims {dims}")
    if dev is not None:
        soup = voxelizer.voxelize_mesh_device(
            mesh, dims, device=dev, return_device=True, on_stage=tick)
        lods = rle_device.build_lod_chain_device(*soup, dims, lod_levels,
                                                 on_stage=tick)
    else:
        xz, y, rgb = voxelizer.voxelize_mesh(mesh, dims)
        tick("voxelize", f"{xz.shape[0]} voxel samples")
        lod0 = rle.build_lod_from_voxels(dims, 0, xz, y, rgb)
        tick("lod0", f"{lod0.voxel_count} voxels")
        lods = rle.build_lod_chain(lod0, lod_levels)
        tick("cascade", f"LODs 1..{lod_levels - 1}: "
             f"{[w.voxel_count for w in lods[1:]]} voxels")
    if save_path:
        save_world(save_path, lods)
        tick("save", f"serialized to {save_path}")
    return lods
