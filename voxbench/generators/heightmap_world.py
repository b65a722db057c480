"""Dense fBm terrain: one solid shell a column (``procedural.heightmap_world``)."""
from voxbench.worldgen import procedural


def build(dims, seed, shell_depth, lod_levels):
    return procedural.heightmap_world(tuple(dims), seed=seed,
                                      shell_depth=shell_depth,
                                      lod_levels=lod_levels)
