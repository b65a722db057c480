"""A configuration's world, built by its generator and cached on disk.

The world belongs to the configuration, as a saved ``.world`` belongs to the
scene a user loads: every run of a cell renders the same world, and only the
first run in a checkout pays for the build.  The cache lives at a fixed path
inside the checkout (``CACHE_DIR``), one ``.npz`` a configuration, named by a
hash of the generator's name, its parameters and the sources of the frozen
generator, so an edited generator or parameter builds anew.
"""
from __future__ import annotations

import dataclasses
import glob
import hashlib
import importlib
import json
import os
import time

import numpy as np

from voxbench.worldgen.rle import WorldLOD

VOXBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE_DIR = os.path.join(os.path.dirname(VOXBENCH), ".voxbench_cache", "worlds")
_FIELDS = [f.name for f in dataclasses.fields(WorldLOD) if f.name not in ("dims", "lod")]


def generator(name: str):
    """The generator module ``voxbench/generators/<name>.py``: its ``build(
    **params)`` returns the world's LOD chain (a list of ``WorldLOD``)."""
    return importlib.import_module(f"voxbench.generators.{name}")


def world_key(config: dict) -> str:
    """The cache file's name: the configuration's name and a hash of what
    the world is made from."""
    h = hashlib.sha256(json.dumps([config["generator"], config["params"]],
                                  sort_keys=True).encode())
    srcs = [generator(config["generator"]).__file__]
    srcs += glob.glob(os.path.join(VOXBENCH, "worldgen", "*.py"))
    for src in sorted(srcs):
        with open(src, "rb") as f:
            h.update(f.read())
    return f"{config['name']}-{h.hexdigest()[:16]}"


def save(path: str, lods: list[WorldLOD]) -> None:
    arrays = {"dims": np.asarray(lods[0].dims, np.int64),
              "n_lods": np.int64(len(lods))}
    for w in lods:
        for f in _FIELDS:
            arrays[f"{w.lod}.{f}"] = getattr(w, f)
    tmp = f"{path}.partial"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load(path: str) -> list[WorldLOD]:
    with np.load(path) as z:
        dims = tuple(int(d) for d in z["dims"])
        return [WorldLOD(dims=dims, lod=lod,
                         **{f: z[f"{lod}.{f}"] for f in _FIELDS})
                for lod in range(int(z["n_lods"]))]


def path(config: dict, cache_dir: str = CACHE_DIR) -> str:
    """The cache file of the configuration's world."""
    return os.path.join(cache_dir, world_key(config) + ".npz")


def world(config: dict, cache_dir: str = CACHE_DIR, log=print) -> list[WorldLOD]:
    """The configuration's LOD chain, from the cache or built and cached."""
    file = path(config, cache_dir)
    t0 = time.perf_counter()
    if os.path.exists(file):
        lods = load(file)
        log(f"[world] {config['name']}: loaded {file} in "
            f"{time.perf_counter() - t0:.2f} s")
        return lods
    lods = generator(config["generator"]).build(**config["params"])
    log(f"[world] {config['name']}: built {lods[0].voxel_count} LOD0 voxels "
        f"in {time.perf_counter() - t0:.1f} s")
    os.makedirs(cache_dir, exist_ok=True)
    save(file, lods)
    log(f"[world] cached {file} ({os.path.getsize(file)} bytes)")
    return lods
