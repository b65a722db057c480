"""A frame's state part way through the march, to hold the kernels against
their plain versions at the shapes and on the data of a real frame.

``capture(renderer, cam, k)`` runs the first ``k`` iterations of the
renderer's own march (dense or occupancy-gated, as ``occupancy_on``
resolves), then rolls the next one and builds the cells its rasterize call
would get: the chunk's visited cells on the dense march, the packed group
of gated cells on the gated march.  ``chip_smoke.py`` and the ``cuda`` tests
use it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cpuvox_tpu_torch.render import raymarch as rm


@dataclasses.dataclass
class Capture:
    """A frame's state after ``k`` march iterations, and its next one."""

    frame: object  # render.frame.FrameSetup
    rs: rm.RasterState  # the state the next rasterize call starts from
    consts: dict
    lod_distances: torch.Tensor
    far: float
    dda: rm.DDAState  # the DDA state before the next roll
    alive: torch.Tensor  # march-alive before the next roll
    cells: rm.CellFields  # the next rasterize call's cells
    chunk: int
    gated: bool


def clone(nt):
    """A copy of a NamedTuple of tensors (the kernels update in place)."""
    return type(nt)(*(t.clone() for t in nt))


def capture(renderer, cam, k: int) -> Capture:
    """March ``k`` iterations of one frame through the kernels' wrappers,
    then roll the next and build its cells, with the same steps as
    ``raymarch.march`` / ``raymarch.march_gated``."""
    f = renderer.frame_setup(cam)
    dev = renderer.device
    dims = renderer.device_world.dims
    chunk, _ = renderer.march_params
    gk = renderer.gated_group_cells if renderer.occupancy_on else 0
    rs = rm.init_raster_state(f.static, max(renderer.render_wh))
    consts = rm.raster_consts(dims[1], f.cam_data.position[1],
                              *renderer.solid_bounds, device=dev)
    ld = torch.from_numpy(f.cam_data.lod_distances).to(dev)
    far = float(np.float32(f.cam_data.far_clip))
    roll, raster = rm.march_ops(True)
    dda, alive = f.dda, f.alive0
    for i in range(k + 1):
        alive = alive & rs.alive
        before = clone(dda), alive.clone()
        dda, alive, visits = roll(dda, alive, f.static.dirs, ld, far, dims,
                                  chunk)
        if gk:
            rs, g = rm.gated_group(renderer._wa, visits, rs, consts,
                                   f.iteration_direction, gk)
            cells = g.cells
        else:
            cells = rm.chunk_cells(renderer._wa, visits, f.iteration_direction)
        if i < k:
            rs = raster(rs, cells, f.static, consts, f.iteration_direction)
            if gk:
                dda, needs = rm.rewind(dda, visits, rs, g)
                alive = alive | needs
    return Capture(f, rs, consts, ld, far, before[0], before[1], cells, chunk,
                   bool(gk))
