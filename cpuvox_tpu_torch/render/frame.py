"""Full-frame render orchestration (``cpuvox_tpu/render/frame.py``) with host
ray init.

Per frame: camera + vanishing-point segments on the host (numpy), host ray
init handed to the device, the phase-1 march, phase-2 reprojection in
color-index space, the color resolve of the screen's pixels, and the nearest
upscale of a ``render_scale`` frame.  The march is the dense one (roll ->
fetch -> rasterize per chunk) or, where ``occupancy_on`` resolves true, the
occupancy-gated one (``raymarch.march_gated``); both give the same raybuffer.

``RenderConfig.backend`` keeps its meaning from the JAX package: "xla" runs
the plain torch versions of the kernels (the twin), anything else the
hand-written CUDA kernels (which take their plain versions on a CPU tensor).
Unlike the JAX package, the gate does not depend on the backend: the plain
versions run the gated march too.  The Renderer works on the card unless it
is asked for another device.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from cpuvox_tpu_torch.config import RenderConfig

from . import camera as cm
from . import device as world_device
from . import ray_init, raymarch, reproject
from . import segments as sg


class FrameSetup(NamedTuple):
    """A frame's host-side setup and its initial rays on the device."""

    cam: cm.Camera
    cam_data: cm.CameraData
    segs: list
    ctxs: list
    vp_screen: np.ndarray
    tables: dict
    static: raymarch.RayStatic
    dda: raymarch.DDAState
    alive0: torch.Tensor
    iteration_direction: int


def _check_supported(config: RenderConfig):
    """Refuse the JAX package's settings that the port does not carry."""
    if config.argb_records:
        raise NotImplementedError("argb_records=True is not ported yet")
    if config.block_fetch == "on":
        raise NotImplementedError("block_fetch='on' (the block-conditional "
                                  "gated fetch) is not ported")
    if config.lite_records != "off":
        raise NotImplementedError(
            f"lite_records={config.lite_records!r} is not ported")
    if config.drain_groups:
        raise NotImplementedError(
            f"drain_groups={config.drain_groups} is not ported: the gated "
            "march drains one group per chunk, then rewinds")


@dataclasses.dataclass
class Renderer:
    """Holds the device world; render frames with ``render``."""

    device_world: world_device.DeviceWorld
    config: RenderConfig
    device: torch.device
    lod_distances: np.ndarray | None = None
    far_clip: float = 0.0
    _wa: raymarch.WorldArrays | None = None

    @classmethod
    def create(cls, lods, config: RenderConfig = RenderConfig(),
               device="cuda"):
        _check_supported(config)
        dw = world_device.build_device_world(lods, skybox_rgb=config.skybox_rgb)
        r = cls(device_world=dw, config=config, device=torch.device(device))
        r._wa = raymarch.world_arrays(dw, r.device)  # raises for split layouts
        return r

    @property
    def kernels(self) -> bool:
        return self.config.backend != "xla"

    @property
    def render_wh(self) -> tuple[int, int]:
        """Internal phase-1/2 resolution (the reference's scaled "fake camera");
        output is upscaled to (width, height)."""
        cfg = self.config
        return (max(2, int(round(cfg.width * cfg.render_scale))),
                max(2, int(round(cfg.height * cfg.render_scale))))

    @property
    def solid_bounds(self) -> tuple[float | None, float | None]:
        """(solid_min_y, solid_max_y) for the solid-bound ray kill, or
        (None, None) when disabled (RenderConfig.solid_kill)."""
        if self.config.solid_kill == "off":
            return (None, None)
        dw = self.device_world
        if dw.solid_min_y is None or dw.solid_max_y is None:
            return (None, None)
        return (dw.solid_min_y, dw.solid_max_y)

    @property
    def occupancy_on(self) -> bool:
        """The occupancy-gate policy resolved against the world's content
        (``frame.py:152-165``): "auto" gates when at least half the LOD0
        columns are empty."""
        mode = self.config.occupancy_gate
        if mode == "on":
            return True
        if mode == "off":
            return False
        return self.device_world.empty_frac >= 0.5

    @property
    def march_params(self) -> tuple[int, int]:
        """(chunk_steps, max_march_chunks) with 0 = auto (``frame.py:196``):
        gated worlds of 512 columns or more march in chunks of 128, the rest
        in chunks of 32.  The dense march gets a 3*max_dim-step march plus 64
        chunks; the gated march 3*max_dim + 64 iterations, since each
        iteration advances a ray by at least one rasterized cell or a whole
        chunk, so no busy-ray rewind rate can truncate a ray."""
        cfg = self.config
        max_dim = max(self.device_world.dims)
        chunk = cfg.chunk_steps
        if chunk == 0:
            chunk = 128 if (self.occupancy_on and max_dim >= 512) else 32
        max_chunks = cfg.max_march_chunks
        if max_chunks == 0:
            if self.occupancy_on:
                max_chunks = 3 * max_dim + 64
            else:
                max_chunks = (3 * max_dim) // chunk + 64
        return chunk, max_chunks

    @property
    def gated_group_cells(self) -> int:
        """Cells rasterized per ray per gated iteration (``raymarch.py:1040``):
        16 when the chunk is a multiple of 16, else 8, unless configured."""
        chunk = self.march_params[0]
        gk = self.config.gated_group_cells or (16 if chunk % 16 == 0 else 8)
        if gk > chunk:
            raise ValueError(f"gated group {gk} exceeds the chunk {chunk}")
        return gk

    @property
    def ray_capacity(self) -> int:
        """Worst-case padded ray count (RenderManager.cs:34-38), 128-quantum."""
        w, h = self.render_wh
        return ((3 * (w + h) + 127) // 128) * 128

    def setup_camera(self, cam: cm.Camera) -> tuple[cm.Camera, cm.CameraData]:
        """Per-camera snapshot with the LOD distances of the first camera
        (UnityManager.LateUpdate: horizon clamp :193-201, SetupLods :417-458)."""
        cfg = self.config
        cam = dataclasses.replace(cam, fov_y_deg=cfg.fov_y_deg,
                                  near=cfg.near_clip, screen=self.render_wh)
        cam = cm.limit_rotation_horizon(cam)
        if self.lod_distances is None:
            self.lod_distances, self.far_clip = cm.setup_lods(
                cam, max(self.device_world.dims), cfg.lod_levels, cfg.lod_error)
        return cam, cm.make_camera_data(cam, self.lod_distances, self.far_clip)

    def frame_setup(self, cam: cm.Camera) -> FrameSetup:
        """The host side of a frame: camera snapshot, segments, reprojection
        tables and the initial rays on the device."""
        cam, cam_data = self.setup_camera(cam)
        vp_screen = cm.vanishing_point_screen(cam, cm.vanishing_point_world(cam))
        segs = sg.build_segments(cam, vp_screen)
        ctxs = sg.build_segment_contexts(cam, segs, vp_screen)
        n_td = segs[0].ray_count + segs[1].ray_count
        tables = reproject.reproject_tables(segs, ctxs, vp_screen, n_td)
        static, dda, alive0, _meta = ray_init.init_rays(
            cam_data, segs, ctxs, self.device_world.dims,
            fixed_size=self.ray_capacity, device=self.device)
        return FrameSetup(
            cam=cam, cam_data=cam_data, segs=segs, ctxs=ctxs,
            vp_screen=vp_screen, tables=tables, static=static, dda=dda,
            alive0=alive0,
            iteration_direction=(
                -1 if cam_data.inverse_element_iteration_direction else 1))

    def march(self, f: FrameSetup) -> torch.Tensor:
        """Phase 1 of a frame: the raybuffer of color indices (R, P) int32."""
        dims = self.device_world.dims
        chunk, max_chunks = self.march_params
        smin, smax = self.solid_bounds
        return raymarch.phase1(
            self._wa, f.static, f.dda, f.alive0, f.cam_data.lod_distances,
            f.cam_data.far_clip, dims[1], f.cam_data.position[1],
            iteration_direction=f.iteration_direction, chunk=chunk,
            max_chunks=max_chunks, dims=dims, pixel_len=max(self.render_wh),
            solid_min_y=smin, solid_max_y=smax, kernels=self.kernels,
            gated_cells=self.gated_group_cells if self.occupancy_on else 0)

    def render_device(self, cam: cm.Camera):
        """Render one frame on the device.  Returns (screen (H, W) int32 ARGB
        bits, raybuffer of color indices (R, P) int32, frame geometry)."""
        f = self.frame_setup(cam)
        raybuf_idx = self.march(f)
        return self.phase2(f, raybuf_idx), raybuf_idx, (
            f.segs, f.ctxs, f.vp_screen, f.cam_data, f.cam)

    def phase2(self, f: FrameSetup, raybuf_idx: torch.Tensor) -> torch.Tensor:
        """The screen (H, W) int32 ARGB bits from a frame's raybuffer."""
        rw, rh = self.render_wh
        # reproject in color-INDEX space, then resolve only the screen's pixels
        screen_idx = reproject.reproject(raybuf_idx, f.tables, rw, rh,
                                         skybox=0, kernels=self.kernels)
        screen = raymarch.resolve_colors(screen_idx, self._wa.colors)
        cfg = self.config
        if (cfg.width, cfg.height) != (rw, rh):
            # nearest upscale of the scaled render (UnityManager.cs:57-63)
            dev = screen.device
            ys = (torch.arange(cfg.height, dtype=torch.int64, device=dev)
                  * rh) // cfg.height
            xs = (torch.arange(cfg.width, dtype=torch.int64, device=dev)
                  * rw) // cfg.width
            screen = screen[ys][:, xs]
        return screen

    def render(self, cam: cm.Camera, return_raybuffers: bool = False):
        """Render one frame; returns (H, W) uint32 ARGB numpy (row 0 = bottom),
        and with ``return_raybuffers`` also (td, lr, segs, ctxs, vp_screen,
        cam_data, cam) like the JAX Renderer."""
        screen, raybuf_idx, (segs, ctxs, vp_screen, cam_data, cam) = \
            self.render_device(cam)
        screen_np = screen.cpu().numpy().view(np.uint32)
        if not return_raybuffers:
            return screen_np
        n_td = segs[0].ray_count + segs[1].ray_count
        n_lr = segs[2].ray_count + segs[3].ray_count
        argb = raymarch.resolve_colors(raybuf_idx, self._wa.colors)
        argb_np = argb.cpu().numpy().view(np.uint32)
        rw, rh = self.render_wh
        td = argb_np[:n_td, :rh]
        lr = argb_np[n_td:n_td + n_lr, :rw]
        return screen_np, (td, lr, segs, ctxs, vp_screen, cam_data, cam)
