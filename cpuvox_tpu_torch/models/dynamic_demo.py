"""Dynamic terrain: per-frame height edits, the world's rebuild on the
device and a render (``cpuvox_tpu/models/dynamic_demo.py``)."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cpuvox_tpu_torch.config import RenderConfig
from cpuvox_tpu_torch.models.procedural import _fbm_heights
from cpuvox_tpu_torch.render import camera as cm
from cpuvox_tpu_torch.render.frame import Renderer
from cpuvox_tpu_torch.world.dynamic import (SurfaceWorldSpec, animate_heights,
                                            build_surface_world_arrays,
                                            surface_renderer, terrain_colors)


@dataclasses.dataclass
class DynamicTerrain:
    """Editable heightmap terrain: each frame rebuilds the world's arrays
    from the animated height field on the device and renders them."""

    spec: SurfaceWorldSpec
    renderer: Renderer
    base_top: torch.Tensor  # (X, Z) int32

    @classmethod
    def create(cls, dims=(512, 128, 512), depth: int = 6, seed: int = 11,
               config: RenderConfig | None = None, device="cuda",
               exact_lod1: bool = False, compact: bool | None = None):
        """``exact_lod1`` False is the demo's and the benchmark's setting, as
        the reference pins it (``models/dynamic_demo.py:38-47``: its max_runs
        9 records stalled the TPU march); True builds the voxel-exact LOD1."""
        X, Y, Z = dims
        spec = SurfaceWorldSpec(dims=tuple(dims), depth=depth, lod_levels=6,
                                exact_lod1=exact_lod1)
        h = _fbm_heights(X, Z, seed)
        base_top = np.clip((h * (Y * 0.5) + Y * 0.2).astype(np.int64), depth,
                           Y - 2)
        config = config or RenderConfig(width=640, height=360)
        top0 = torch.from_numpy(base_top.astype(np.int32)).to(device)
        renderer = surface_renderer(spec, top0, terrain_colors(spec, top0),
                                    config, compact=compact)
        return cls(spec=spec, renderer=renderer, base_top=top0)

    def rebuild(self, t: float) -> None:
        """The world at time ``t``: heights -> colors -> arrays, on the
        device, swapped into the Renderer."""
        top = animate_heights(self.spec, self.base_top, t)
        self.renderer._wa = build_surface_world_arrays(
            self.spec, top, terrain_colors(self.spec, top))

    def render_frame(self, t: float, cam: cm.Camera):
        """Rebuild and render: the screen (H, W) int32 ARGB bits."""
        self.rebuild(t)
        screen, _, _ = self.renderer.render_device(cam)
        return screen
