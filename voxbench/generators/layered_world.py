"""A terrain shell under floating slabs, most columns empty inside a
structure footprint (``procedural.layered_world``)."""
from voxbench.worldgen import procedural


def build(dims, seed, shell_depth, n_layers, lod_levels, footprint):
    return procedural.layered_world(tuple(dims), seed=seed,
                                    shell_depth=shell_depth,
                                    n_layers=n_layers, lod_levels=lod_levels,
                                    footprint=footprint)
