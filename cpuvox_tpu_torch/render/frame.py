"""Full-frame render orchestration (``cpuvox_tpu/render/frame.py``).

Per frame: camera + vanishing-point segments on the host (numpy), ray init
on the host (``ray_init``) or with ``host_init=False`` on the device
(``device_init``), the phase-1 march, and phase 2: the reprojection
in color-index space, the color resolve of the screen's pixels and the
nearest upscale of a ``render_scale`` frame, with the kernels one launch
(``ops/reproject_kernel.reproject_screen``).  The march is the dense one
(roll -> fetch -> rasterize per chunk) or, where ``occupancy_on`` resolves
true, the occupancy-gated one (``raymarch.march_gated``); both give the
same raybuffer.  On a CUDA Renderer with the kernels the march is one
launch of the Renderer's march graph (``march_graph.py``), at full width
or, with ``compact``, in stages of halving width on a live-ray index, and
the host rays go up from pinned memory (``ray_init.RayStaging``), so
``render_device`` reads nothing from the device and returns before the
frame is done; on the CPU and with the plain versions the host drives the
march (``graph_route``).  A camera batch (``parallel/batch.py``) marches
each direction group through a batch graph of its own
(``march_batch_graph``), and each shard of ``parallel/`` through one of
its own (``shard_graph``).
In ARGB mode (``argb_records`` on a world whose columns hold few enough
voxels, ``argb_on``) the records carry the columns' colors, phase 1 writes
final colors and phase 2 samples them with no resolve.

``RenderConfig.backend`` keeps its meaning from the JAX package: "xla" runs
the plain torch versions of the kernels (the twin), anything else the
hand-written CUDA kernels (which take their plain versions on a CPU tensor).
Unlike the JAX package, neither the gate nor ARGB mode depends on the
backend: the plain versions run the gated march and the ARGB write too.
The Renderer works on the card unless it is asked for another device.

``utils/profiling.PROFILER`` records each ``render_device`` call as a
frame, with host spans around the set-up's parts and the march and phase-2
enqueues, and the Renderer's creation as process spans; the march graph
times its kernels on the frames it samples.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from cpuvox_tpu_torch.config import RenderConfig
from cpuvox_tpu_torch.utils import profiling

from . import camera as cm
from . import device as world_device
from . import device_init, ray_init, raymarch, reproject
from . import segments as sg
from .march_graph import MarchGraph


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
class ArraysWorld:
    """What a Renderer reads of a world it is given as ``WorldArrays`` (a
    dynamic world, ``world/dynamic.py``) in place of a ``DeviceWorld``: the
    dims and the run capacity.  No occupancy tiles, no solid bounds, index
    mode."""

    dims: tuple[int, int, int]
    max_runs: int
    max_col_colors: int = 0
    solid_min_y: float | None = None
    solid_max_y: float | None = None


@dataclasses.dataclass
class Renderer:
    """Holds the device world; render frames with ``render``."""

    device_world: world_device.DeviceWorld
    config: RenderConfig
    device: torch.device
    lod_distances: np.ndarray | None = None
    far_clip: float = 0.0
    _wa: raymarch.WorldArrays | None = None
    # live-ray compaction in the march: in a march graph, stages of halving
    # width (``raymarch.stage_widths``); on the host loop, an index rebuilt
    # when the live count halves.  None: as ``compacts`` resolves it.  The
    # raybuffer is the same either way
    compact: bool | None = None
    # the march graph (``march_graph.py``), a camera batch's march graphs
    # by (rays, texels, device), the shards' by (role, slot, rays, texels,
    # device) (``shard_graph``), and the host rays' staging (by ray count
    # and device); not copied by ``dataclasses.replace``
    _graph: MarchGraph | None = dataclasses.field(
        default=None, init=False, repr=False, compare=False)
    _batch_graphs: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)
    _shard_graphs: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)
    _staging: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    @classmethod
    def create(cls, lods, config: RenderConfig = RenderConfig(),
               device="cuda", compact: bool | None = None):
        _check_supported(config)
        rec = profiling.PROFILER
        with rec.process_span("world_pack"):
            dw = world_device.build_device_world(
                lods, skybox_rgb=config.skybox_rgb,
                inline_colors=config.argb_records)
        r = cls(device_world=dw, config=config, device=torch.device(device),
                compact=compact)
        with rec.process_span("world_upload"):
            r._wa = raymarch.world_arrays(dw, r.device)
        return r

    @classmethod
    def from_arrays(cls, wa: raymarch.WorldArrays, dims, config: RenderConfig,
                    device="cuda", compact: bool | None = None, lod_distances=None,
                    far_clip: float = 0.0):
        """A Renderer over given world arrays (the dynamic worlds of
        ``world/dynamic.py``; the JAX package builds these through
        ``Renderer.__new__``).  Swap ``_wa`` for arrays of the same world to
        render an edit.  ``lod_distances`` None takes the first camera's."""
        _check_supported(config)
        return cls(device_world=ArraysWorld(tuple(dims), int(wa.max_runs)),
                   config=config, device=torch.device(device),
                   lod_distances=lod_distances, far_clip=far_clip, _wa=wa,
                   compact=compact)

    @property
    def kernels(self) -> bool:
        return self.config.backend != "xla"

    @property
    def argb_on(self) -> bool:
        """ARGB mode resolved against the world (``frame.py:57``): the
        records carry the columns' colors (``argb_records`` was asked for and
        no column holds more than ``INLINE_MAX_COLORS`` voxels)."""
        return self.device_world.max_col_colors > 0

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
        columns are empty.  A world without occupancy tiles (the dynamic
        worlds) marches densely whatever the setting."""
        if self._wa.occ_tiles is None:
            return False
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

    def frame_geometry(self, cam: cm.Camera) -> FrameSetup:
        """The host side of a frame without its rays: camera snapshot,
        segments and reprojection tables (``static``, ``dda`` and ``alive0``
        None)."""
        rec = profiling.PROFILER
        with rec.span("geometry"):
            cam, cam_data = self.setup_camera(cam)
            vp_screen = cm.vanishing_point_screen(
                cam, cm.vanishing_point_world(cam))
            segs = sg.build_segments(cam, vp_screen)
            ctxs = sg.build_segment_contexts(cam, segs, vp_screen)
        with rec.span("tables"):
            n_td = segs[0].ray_count + segs[1].ray_count
            tables = reproject.reproject_tables(segs, ctxs, vp_screen, n_td)
        return FrameSetup(
            cam=cam, cam_data=cam_data, segs=segs, ctxs=ctxs,
            vp_screen=vp_screen, tables=tables, static=None, dda=None,
            alive0=None,
            iteration_direction=(
                -1 if cam_data.inverse_element_iteration_direction else 1))

    def init_rays_device(self, f: FrameSetup, R: int | None = None,
                         device=None):
        """A frame's initial rays built on the device (``host_init=False``):
        (RayStatic, DDAState, alive0) of ``R`` rays (``ray_capacity`` for
        None) on ``device`` (the Renderer's for None)."""
        R = self.ray_capacity if R is None else R
        if sum(s.ray_count for s in f.segs) > R:
            raise ValueError(f"the frame's rays exceed capacity {R}")
        return device_init.init_rays_device(
            device_init.build_frame_params(f.cam_data, f.segs, f.ctxs),
            self.device_world.dims, R,
            self.device if device is None else device)

    def frame_setup(self, cam: cm.Camera, R: int | None = None,
                    device=None) -> FrameSetup:
        """The host side of a frame: camera snapshot, segments, reprojection
        tables and the initial rays, ``R`` of them (``ray_capacity`` for
        None) on ``device`` (the Renderer's for None), built on the host or
        on the device as ``config.host_init`` says."""
        rec = profiling.PROFILER
        with rec.span("frame_setup"):
            f = self.frame_geometry(cam)
            with rec.span("rays"):
                if self.config.host_init:
                    R = self.ray_capacity if R is None else R
                    device = torch.device(self.device if device is None
                                          else device)
                    staging = self._staging.get((R, device))
                    if staging is None:
                        staging = self._staging[(R, device)] = \
                            ray_init.RayStaging(R, device)
                    static, dda, alive0, _meta = ray_init.init_rays(
                        f.cam_data, f.segs, f.ctxs, self.device_world.dims,
                        fixed_size=R, device=device, staging=staging)
                else:
                    static, dda, alive0 = self.init_rays_device(
                        f, R=R, device=device)
        return f._replace(static=static, dda=dda, alive0=alive0)

    def graph_route(self, device=None) -> bool:
        """Whether a march on ``device`` (the Renderer's for None) is a
        launch of a march graph: a CUDA device with the kernels on, the
        march compacted or not.  Elsewhere (the CPU, the plain versions)
        the host drives the loop."""
        device = torch.device(self.device if device is None else device)
        return device.type == "cuda" and self.kernels

    def compacts(self, graph: bool) -> bool:
        """Live-ray compaction resolved against where the march runs, as
        ``occupancy_on`` resolves the gate: ``compact`` where it was given;
        else in a march graph (``graph``) yes, on the host loop no.  On the
        H100 the staged graph was no slower than the full-width one on
        either march kind (terrain2048 dense and layered2048 gated at 1080p,
        sequential and pipelined, in turns: ``PERF.md`` §6); on the host
        loop each index rebuild adds launches that a host-bound frame pays
        (``PERF.md`` §6)."""
        return graph if self.compact is None else self.compact

    def stage_widths(self, R: int, compact: bool | None = None) -> tuple:
        """The march graph's stage widths for ``R`` rays: the full width
        alone, or with ``compact`` (None: ``compacts``) the halving schedule
        ``raymarch.stage_widths``."""
        compact = self.compacts(graph=True) if compact is None else compact
        return raymarch.stage_widths(R) if compact else (R,)

    def march(self, f: FrameSetup, compact: bool | None = None) -> torch.Tensor:
        """Phase 1 of a frame: the raybuffer (R, P) int32 of color indices,
        or in ARGB mode of final colors.  ``compact`` True marches on a
        live-ray index, False marches every ray slot to the end, None does as
        the Renderer resolves it (``compacts``); the raybuffer is the same.
        On the graph route (``graph_route``) the march is one launch of the
        march graph (``march_graph``), staged when it compacts, with no host
        read; otherwise the host drives the loop."""
        if self.graph_route():
            return self.march_graph(f, compact)
        return self.march_rays(f.static, f.dda, f.alive0, f.cam_data,
                               f.cam_data.position[1], f.iteration_direction,
                               compact)

    def march_graph(self, f: FrameSetup,
                    compact: bool | None = None) -> torch.Tensor:
        """``march`` through the Renderer's ``MarchGraph``: buffers at the
        frame's ray count, one captured graph a variant (on a CPU device its
        plain version, the host reading the conditions)."""
        R = f.static.dirs.shape[0]
        P = max(self.render_wh)
        g = self._graph
        if g is None or g.shape != (R, P):
            g = self._graph = MarchGraph(R, P, self.device_world.dims[1],
                                         self.solid_bounds, self.device,
                                         timed=True)
        return self._graph_march(g, self._wa, f.cam_data,
                                 f.iteration_direction, f.static, f.dda,
                                 f.alive0, f.cam_data.position[1],
                                 compact=compact)

    def march_batch_graph(self, static, dda, alive0, cam_y, cam_y_norm,
                          cam_data, iteration_direction: int,
                          wa: raymarch.WorldArrays | None = None,
                          compact: bool | None = None):
        """A camera batch's march (``parallel/batch.py``) on the rays'
        device through one of the Renderer's batch graphs, a ``MarchGraph``
        for each (rays, texels, device), kept apart from the single frame's
        so that neither evicts the other.  ``cam_y`` and ``cam_y_norm`` are
        (R,) tensors a ray (``device_init.init_rays_batch``); the LOD
        distances and far clip are ``cam_data``'s; the world is the
        Renderer's or ``wa``, a replica of it on that device; staged as
        ``compact`` says (None: ``compacts``) at the group's ray count."""
        R, P = static.dirs.shape[0], max(self.render_wh)
        dev = static.dirs.device
        g = self._batch_graphs.get((R, P, dev))
        if g is None:
            g = self._batch_graphs[(R, P, dev)] = MarchGraph(
                R, P, self.device_world.dims[1], self.solid_bounds, dev)
        return self._graph_march(g, self._wa if wa is None else wa, cam_data,
                                 iteration_direction, static, dda, alive0,
                                 cam_y, cam_y_norm, compact)

    def shard_graph(self, role: str, slot: int, R: int,
                    device) -> MarchGraph:
        """The ``MarchGraph`` of shard ``slot`` of a sharded ``role`` ("ray":
        a slice of one camera's rays, ``parallel/mesh.py``; "cam": a camera
        block of a batch, ``parallel/batch.py``) at ``R`` rays on
        ``device``, with a stream of its own (``MarchGraph.stream``).
        Shards that run at once on one device each march in buffers of
        their own: a graph is never keyed by its rays, texels and device
        alone."""
        P, dev = max(self.render_wh), torch.device(device)
        key = (role, int(slot), int(R), P, dev)
        g = self._shard_graphs.get(key)
        if g is None:
            g = self._shard_graphs[key] = MarchGraph(
                R, P, self.device_world.dims[1], self.solid_bounds, dev,
                own_stream=True)
        return g

    def graph_variant(self, g: MarchGraph, wa, cam_data,
                      iteration_direction: int, compact: bool | None = None,
                      before_capture=None):
        """``g``'s variant for the Renderer's settings and stage schedule
        (``stage_widths`` at ``g``'s ray count) against ``wa``, captured
        on its first use (``MarchGraph.variant``)."""
        kw = self.march_kwargs()
        return g.variant(wa, cam_data.lod_distances, cam_data.far_clip,
                         kw["dims"], iteration_direction, kw["chunk"],
                         kw["max_chunks"], kw["gated_cells"],
                         self.stage_widths(g.shape[0], compact),
                         before_capture=before_capture)

    def _graph_march(self, g: MarchGraph, wa, cam_data,
                     iteration_direction: int, static, dda, alive0, cam_y,
                     cam_y_norm=None, compact: bool | None = None):
        """The march of these rays through ``g``'s variant for the
        Renderer's settings and stage schedule, captured on its first
        use."""
        v = self.graph_variant(g, wa, cam_data, iteration_direction, compact)
        return g.march(v, static, dda, alive0, cam_y, cam_y_norm)

    def march_kwargs(self, compact: bool | None = None) -> dict:
        """The keywords of ``raymarch.phase1`` that the Renderer resolves:
        the chunk and its budget, the dims, the raybuffer width, the solid
        bounds, kernels or plain versions, the gated group (0: the dense
        march) and the host loop's compaction (``compact`` None:
        ``compacts``)."""
        chunk, max_chunks = self.march_params
        smin, smax = self.solid_bounds
        return dict(
            chunk=chunk, max_chunks=max_chunks, dims=self.device_world.dims,
            pixel_len=max(self.render_wh), solid_min_y=smin,
            solid_max_y=smax, kernels=self.kernels,
            gated_cells=self.gated_group_cells if self.occupancy_on else 0,
            compact=self.compacts(graph=False) if compact is None
            else compact)

    def march_rays(self, static, dda, alive0, cam_data, cam_y,
                   iteration_direction: int, compact: bool | None = None,
                   wa: raymarch.WorldArrays | None = None):
        """``march`` on given rays: one camera's, or a batch of cameras'
        marched together with ``cam_y`` a ray's camera height (R,) and the
        LOD distances and far clip of ``cam_data`` (``parallel/batch.py``),
        against the Renderer's world or ``wa``, a replica of it on the rays'
        device (``parallel/mesh.py``)."""
        return raymarch.phase1(
            self._wa if wa is None else wa, static, dda, alive0,
            cam_data.lod_distances, cam_data.far_clip,
            self.device_world.dims[1], cam_y,
            iteration_direction=iteration_direction,
            **self.march_kwargs(compact))

    def render_device(self, cam: cm.Camera):
        """Render one frame on the device.  Returns (screen (H, W) int32 ARGB
        bits, raybuffer (R, P) int32 of color indices or, in ARGB mode, of
        colors, frame geometry).  On a CUDA Renderer with the kernels it
        returns before the frame is done and reads nothing from the device:
        the rays go up from pinned memory, the march is one graph launch,
        phase 2 one kernel launch; the raybuffer is the frame's own.  The
        call is a frame of ``profiling.PROFILER``."""
        rec = profiling.PROFILER
        with rec.frame():
            f = self.frame_setup(cam)
            with rec.span("march"):
                raybuf_idx = self.march(f)
            with rec.span("phase2"):
                screen = self.phase2(f, raybuf_idx)
        return screen, raybuf_idx, (
            f.segs, f.ctxs, f.vp_screen, f.cam_data, f.cam)

    def phase2_args(self, f: FrameSetup, raybuf_idx: torch.Tensor) -> tuple:
        """The arguments of ``ops/reproject_kernel.reproject_screen`` for a
        frame: the raybuffer, the segment tables, the render and the output
        size, and in index mode the color table (None in ARGB mode, where
        phase 1 wrote final colors) and the skybox value."""
        rw, rh = self.render_wh
        if self.argb_on:
            colors = None
            skybox = int(self.device_world.colors[:1].view(np.int32)[0])
        else:
            colors, skybox = self._wa.colors, 0
        return (raybuf_idx, f.tables, rw, rh, self.config.width,
                self.config.height, colors, skybox)

    def phase2(self, f: FrameSetup, raybuf_idx: torch.Tensor) -> torch.Tensor:
        """The screen (H, W) int32 ARGB bits from a frame's raybuffer: the
        reprojection at the render size, in index mode the resolve of the
        screen's color indices, and the nearest upscale of a scaled render
        (UnityManager.cs:57-63).  With kernels, one launch of the fused
        phase-2 kernel."""
        from cpuvox_tpu_torch.ops import reproject_kernel as rk

        fn = rk.reproject_screen if self.kernels else rk.reproject_screen_ref
        return fn(*self.phase2_args(f, raybuf_idx))

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
        argb = raybuf_idx if self.argb_on else raymarch.resolve_colors(
            raybuf_idx, self._wa.colors)
        argb_np = argb.cpu().numpy().view(np.uint32)
        rw, rh = self.render_wh
        td = argb_np[:n_td, :rh]
        lr = argb_np[n_td:n_td + n_lr, :rw]
        return screen_np, (td, lr, segs, ctxs, vp_screen, cam_data, cam)


def render_frame(lods, cam: cm.Camera, config: RenderConfig = RenderConfig(),
                 device="cuda"):
    """One frame, (H, W) uint32 ARGB numpy (``cpuvox_tpu/render/frame.py``'s
    one-shot convenience): builds the device world each call, so use a
    Renderer for interactive and benchmark loops."""
    return Renderer.create(lods, config, device=device).render(cam)
