"""A frame's state part way through the march, to hold the kernels against
their plain versions at the shapes and on the data of a real frame.

``capture(renderer, cam, k)`` runs the first ``k`` iterations of the
renderer's own march (dense or occupancy-gated, as ``occupancy_on``
resolves), then rolls the next one and keeps what its rasterize call gets: the
chunk's visits on the dense march, the packed group of gated cells on the
gated march (``src``), and the same cells with their column records fetched
by torch (``cells``), the input of the previous kernel design.  Unless ``compact`` is False the march
compacts its live rays as the host loop does (``raymarch.live_rays``: an
ascending index of the live rays, rebuilt when their count halves), so a
capture deep enough into a frame holds a live-ray index like those the
kernels are given.  ``chip_smoke.py`` and the ``cuda`` tests use
it.
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
    src: object  # the next rasterize call's cells: visits or PackedCells
    cells: rm.CellFields  # ``src`` with the column records fetched
    wa: rm.WorldArrays  # the world tables the rasterize call reads
    chunk: int
    gated: bool
    index: torch.Tensor | None = None  # the live-ray index of the next calls


def clone(nt):
    """A copy of a NamedTuple of tensors (the kernels update in place)."""
    return type(nt)(*(t.clone() for t in nt))


def capture(renderer, cam, k: int, compact: bool = True) -> Capture:
    """March ``k`` iterations of one frame through the kernels' wrappers,
    then roll the next and take its cells, with the same steps as
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
    roll, raster, gate, rewind = rm.march_ops(True)
    dda, alive = clone(f.dda), f.alive0
    rewound = torch.zeros((), dtype=torch.int64, device=dev)
    counts = torch.zeros(3, dtype=torch.int64, device=dev)
    index = None
    for i in range(k + 1):
        alive = alive & rs.alive
        n, index = rm.live_rays(alive, index, compact)
        if not n:
            raise ValueError(f"the march ended after {i} iterations, before "
                             f"the capture at {k}")
        before = clone(dda), alive.clone()
        dda, alive, visits = roll(dda, alive, f.static.dirs, ld, far, dims,
                                  chunk, index=index)
        src = visits
        if gk:
            g = gate(renderer._wa, visits, rs, consts, gk, counts,
                     index=index)
            src = g.cells
        if i < k:
            rs = raster(rs, renderer._wa, src, f.static, consts,
                        f.iteration_direction, index=index)
            if gk:
                rewind(dda, alive, rewound, counts, rs, g, index=index)
    cells = rm.fetch_cells(renderer._wa, src, f.iteration_direction)
    return Capture(f, rs, consts, ld, far, before[0], before[1], src, cells,
                   renderer._wa, chunk, bool(gk), index)
