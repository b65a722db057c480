"""Full-frame render orchestration (``cpuvox_tpu/render/frame.py``), dense
branch with host ray init.

Per frame: camera + vanishing-point segments on the host (numpy), host ray
init handed to the device, the phase-1 march (roll -> fetch -> rasterize per
chunk), phase-2 reprojection in color-index space, the color resolve of the
screen's pixels, and the nearest upscale of a ``render_scale`` frame.

``RenderConfig.backend`` keeps its meaning from the JAX package: "xla" runs
the plain torch versions of the kernels (the twin), anything else the
hand-written CUDA kernels (which take their plain versions on a CPU tensor).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from cpuvox_tpu_torch.shared import RenderConfig
from cpuvox_tpu_torch.shared import camera as cm
from cpuvox_tpu_torch.shared import segments as sg
from cpuvox_tpu_torch.shared import device as shared_device

from . import ray_init, raymarch, reproject


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
    if config.argb_records:
        raise NotImplementedError("argb_records=True is not ported yet")
    if config.occupancy_gate == "on":
        raise NotImplementedError(
            "the occupancy-gated march is not ported yet (occupancy_gate='on'); "
            "'auto' and 'off' render through the output-identical dense march")


@dataclasses.dataclass
class Renderer:
    """Holds the device world; render frames with ``render``."""

    device_world: shared_device.DeviceWorld
    config: RenderConfig
    device: torch.device
    lod_distances: np.ndarray | None = None
    far_clip: float = 0.0
    _wa: raymarch.WorldArrays | None = None

    @classmethod
    def create(cls, lods, config: RenderConfig = RenderConfig(), device="cpu"):
        _check_supported(config)
        dw = shared_device.build_device_world(lods, skybox_rgb=config.skybox_rgb)
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
    def march_params(self) -> tuple[int, int]:
        """(chunk_steps, max_march_chunks) with 0 = auto: chunk 32 and a
        3*max_dim-step march plus 64 chunks of headroom (the dense policy)."""
        cfg = self.config
        max_dim = max(self.device_world.dims)
        chunk = cfg.chunk_steps or 32
        max_chunks = cfg.max_march_chunks or (3 * max_dim) // chunk + 64
        return chunk, max_chunks

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
            solid_min_y=smin, solid_max_y=smax, kernels=self.kernels)

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
