"""World-sharded rendering: LOD0 striped over the devices as tiles, and a
camera-local window of them fetched for the frame (the counterpart of
``cpuvox_tpu/parallel/world_shard.py``).

- LOD0 holds most of a world's bytes.  It is cut into tiles of T x T
  columns, and tile t lives on device ``t % n`` (row ``t // n`` of that
  owner's shard), so the camera's near field never lands on one owner.  The
  coarse LODs are kept whole.
- A ray marches LOD0 only while its entry distance is below
  ``lod_distances[0]``, and distances are Euclidean in XZ, so a square
  window of tiles around the camera with half-extent
  ``ceil((lod_distances[0] + 2) / T)`` holds every LOD0 cell a frame
  visits.
- For a frame, the window's tiles are copied from their owners into an
  active world on the rendering device: the window blocks, an all-empty
  sentinel block, then the coarse rows.  The march finds a LOD0 column by
  arithmetic on the window (``raymarch._cell_index`` with
  ``WorldArrays.win``, a device tensor; in the kernel
  ``csrc/rasterize.cu::cell_index``).  The window is memoized by its
  corner: a still camera exchanges nothing.  A window that moves keeps its
  width, and so the active world's layout: the inner Renderer's march graph
  copies the new tables and window into its own (``MarchGraph.world``) and
  captures nothing anew.

Where JAX psum-gathers owner-masked tiles over the mesh, the exchange here
is one ``index_select`` an owner of the window tiles it holds, copied to the
rendering device and placed in their window slots.  Inline-record worlds
only: the split layout (more than ``INLINE_MAX_RUNS`` runs a column) and
ARGB records raise ``ValueError``, as in JAX.  The occupancy tiles are
striped the same way (tiles of 16 columns or more), so the gated march runs
on the active window too.  The lite records are not built: the port does
not carry them.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from cpuvox_tpu_torch.render import camera as cm
from cpuvox_tpu_torch.render import raymarch
from cpuvox_tpu_torch.render.device import build_device_world
from cpuvox_tpu_torch.render.frame import Renderer, _check_supported
from cpuvox_tpu_torch.world.rle import WorldLOD

from .mesh import RenderMesh, as_device


@dataclasses.dataclass
class _ActiveWorldMeta:
    """What the port's Renderer reads of its ``device_world``
    (``render/frame.py``): the march parameters and capacities, index mode,
    the occupancy auto policy and the solid bounds (world-global, so exact
    under the tile striping)."""

    dims: tuple[int, int, int]
    lod_levels: int
    max_runs: int
    lod0_voxels: int
    max_col_colors: int = 0
    empty_frac: float = 0.0
    solid_min_y: float | None = None
    solid_max_y: float | None = None


def _devices(mesh) -> list:
    """The devices of a ``RenderMesh`` or of a list of devices."""
    devs = mesh.devices if isinstance(mesh, RenderMesh) else mesh
    devs = [as_device(d) for d in devs]
    if not devs:
        raise ValueError("world sharding needs at least one device")
    return devs


@dataclasses.dataclass
class ShardedWorld:
    """LOD0 tiles owner-striped over the devices; coarse LODs whole.

    ``owned_*[k]`` is owner k's shard on ``devices[k]``: (ntl, ...) rows,
    row j holding tile ``j * n + k``; joined in owner order they are the
    JAX package's striped global layout.  Record slot 1 of a LOD0 tile holds
    the tile-local color offset."""

    devices: list
    dims: tuple[int, int, int]
    lod_levels: int
    max_runs: int
    lod0_voxels: int
    tl: int  # log2 tile side (columns)
    nt_x: int
    nt_z: int
    cb: int  # per-tile color-block capacity
    rec_w: int  # record row width (int32)
    owned_fwd: list  # n x (ntl, T*T, rec_w) int32
    owned_rev: list
    owned_colors: list  # n x (ntl, cb) int32 (uint32 bits)
    # the coarse chain (the original concat layout minus the LOD0 prefix)
    coarse_fwd: np.ndarray  # (coarse_cols, rec_w) int32, color_off 0-based
    coarse_rev: np.ndarray
    coarse_colors: np.ndarray  # uint32, without the skybox slot
    col_base: np.ndarray  # int32 [8] original concat bases
    grid_z: np.ndarray
    skybox: np.uint32
    # occupancy tiles, striped the same way: (T/16)*(T/8) rows a world tile
    owned_occ: list | None = None  # n x (ntl, T^2/128, 8) int32
    coarse_occ: np.ndarray | None = None
    tile_base: np.ndarray | None = None
    tile_gz: np.ndarray | None = None
    empty_frac: float = 0.0
    solid_min_y: float | None = None
    solid_max_y: float | None = None

    @property
    def n_chips(self) -> int:
        return len(self.devices)

    @classmethod
    def build(cls, lods: list[WorldLOD], mesh, tile_cols: int = 256,
              skybox_rgb: tuple[int, int, int] = (25, 25, 25)
              ) -> "ShardedWorld":
        """Stripe ``lods``' LOD0 over the devices of ``mesh`` (a
        ``RenderMesh`` or a list of devices) in tiles of ``tile_cols``
        columns a side (``world_shard.py:121-229``)."""
        devices = _devices(mesh)
        dw = build_device_world(lods, skybox_rgb=skybox_rgb)
        if dw.rec_fwd is None:
            raise ValueError("world sharding needs the inline record layout "
                             f"(max_runs {dw.max_runs} > INLINE limit)")
        x0, z0 = lods[0].grid_dims
        t = min(tile_cols, x0, z0)
        if t & (t - 1) or x0 % t or z0 % t:
            raise ValueError(f"tile_cols {t} must be a power of two dividing "
                             f"the LOD0 grid {x0}x{z0}")
        tl = t.bit_length() - 1
        nt_x, nt_z = x0 // t, z0 // t
        nt = nt_x * nt_z
        n0 = x0 * z0
        rec_w = dw.rec_fwd.shape[1]

        def tile_order(rows2d):  # (n0, ...) column-major -> (nt, T*T, ...)
            r = rows2d.reshape((nt_x, t, nt_z, t) + rows2d.shape[1:])
            r = np.moveaxis(r, 2, 1)  # (nt_x, nt_z, T, T, ...)
            return r.reshape((nt, t * t) + rows2d.shape[1:])

        fine_fwd = tile_order(dw.rec_fwd[:n0]).copy()
        fine_rev = tile_order(dw.rec_rev[:n0]).copy()

        # per-column solid-voxel counts -> per-tile color blocks + local offs
        runs0 = lods[0].runs
        solid = np.where(runs0 >= 0, runs0 & 0xFFFF, 0).astype(np.int64)
        csum = np.concatenate([[0], np.cumsum(solid)])
        off64 = lods[0].col_offset.astype(np.int64)
        cnt = csum[off64 + lods[0].col_runs] - csum[off64]  # (n0,)
        src = lods[0].col_color_offset.astype(np.int64) + 1  # into dw.colors
        cnt_t = tile_order(cnt.reshape(-1, 1))[..., 0]  # (nt, T*T)
        src_t = tile_order(src.reshape(-1, 1))[..., 0]
        loc = np.cumsum(cnt_t, axis=1) - cnt_t  # tile-local exclusive offsets
        cb = max(int((loc[:, -1] + cnt_t[:, -1]).max(initial=0)), 1)
        total = int(cnt_t.sum())
        if total != int(lods[0].colors.shape[0]):
            raise ValueError(f"LOD0's runs count {total} solid voxels, its "
                             f"colors {lods[0].colors.shape[0]}")
        colors_t = np.zeros((nt, cb), np.uint32)
        flat_cnt = cnt_t.ravel()
        rep = np.repeat(np.arange(nt * t * t, dtype=np.int64), flat_cnt)
        within = np.arange(total, dtype=np.int64) - np.repeat(
            np.cumsum(flat_cnt) - flat_cnt, flat_cnt)
        colors_t[rep // (t * t), loc.ravel()[rep] + within] = \
            dw.colors[src_t.ravel()[rep] + within]
        fine_fwd[:, :, 1] = loc.astype(np.int32)  # slot 1 -> tile-local
        fine_rev[:, :, 1] = loc.astype(np.int32)

        nc = len(devices)
        ntl = -(-nt // nc)
        tid = np.arange(nt)
        grow = (tid % nc) * ntl + tid // nc  # owner-striped global row

        def stripe(tiles):
            """Tiles (nt, ...) in the striped global layout, cut into one
            shard an owner on its device."""
            g = np.zeros((ntl * nc,) + tiles.shape[1:], np.int32)
            g[grow] = tiles
            return [torch.from_numpy(g[k * ntl:(k + 1) * ntl]).to(d)
                    for k, d in enumerate(devices)]

        coarse_fwd = dw.rec_fwd[n0:].copy()
        coarse_rev = dw.rec_rev[n0:].copy()
        n0c = int(lods[0].colors.shape[0])
        # coarse color offsets 0-based into coarse_colors (rebased per window)
        coarse_fwd[:, 1] -= 1 + n0c
        coarse_rev[:, 1] -= 1 + n0c
        extra = {"solid_min_y": dw.solid_min_y, "solid_max_y": dw.solid_max_y}
        if t >= 16 and dw.occ_tiles is not None:
            # occupancy tiles (16x8 columns a row) nest inside world tiles;
            # LOD0's rows are striped the same way so the gated march works
            tb = dw.tile_base
            occ0 = dw.occ_tiles[tb[0]:tb[1]]  # (gx/16 * gz/8, 8)
            r = occ0.reshape(nt_x, t // 16, nt_z, t // 8, 8)
            occ_t = np.moveaxis(r, 2, 1).reshape(nt, (t * t) // 128, 8)
            extra.update(
                owned_occ=stripe(occ_t),
                coarse_occ=dw.occ_tiles[tb[1]:].copy(),
                tile_base=tb.copy(), tile_gz=dw.tile_gz.copy(),
                empty_frac=dw.empty_frac)
        return cls(
            devices=devices, dims=dw.dims, lod_levels=dw.lod_levels,
            max_runs=dw.max_runs, lod0_voxels=dw.lod0_voxels,
            tl=tl, nt_x=nt_x, nt_z=nt_z, cb=cb, rec_w=rec_w,
            owned_fwd=stripe(fine_fwd), owned_rev=stripe(fine_rev),
            owned_colors=stripe(colors_t.view(np.int32)),
            coarse_fwd=coarse_fwd, coarse_rev=coarse_rev,
            coarse_colors=dw.colors[1 + n0c:].copy(),
            col_base=dw.col_base.copy(), grid_z=dw.grid_z.copy(),
            skybox=np.uint32(dw.colors[0]), **extra)

    def owned(self) -> dict:
        """The striped tables by name: records, colors, occupancy rows."""
        out = {"fwd": self.owned_fwd, "rev": self.owned_rev,
               "colors": self.owned_colors}
        if self.owned_occ is not None:
            out["occ"] = self.owned_occ
        return out

    def exchange(self, tids, device) -> tuple[dict, int]:
        """The window fetch (``make_exchange``, ``world_shard.py:231-271``):
        for each owner, one ``index_select`` of the window tiles it holds,
        copied to ``device`` and placed in their window slots; tile id -1
        (off the world) stays zeros, the sentinel's bits.  Then record slot
        1 is rebased to the slot's color block, ``1 + slot * cb`` (slot 0 of
        the colors is the skybox).  Returns (tables by name, each (W^2, ...)
        on ``device``; the bytes the owners' gathers moved)."""
        tids = np.asarray(tids, np.int64).ravel()
        w2, nc = tids.size, self.n_chips
        owned = self.owned()
        got = {k: torch.zeros((w2,) + v[0].shape[1:], dtype=torch.int32,
                              device=device) for k, v in owned.items()}
        moved = 0
        for k, d in enumerate(self.devices):
            slots = np.flatnonzero((tids >= 0) & (tids % nc == k))
            if not slots.size:
                continue
            local = torch.from_numpy(tids[slots] // nc).to(d)
            dest = torch.from_numpy(slots).to(device)
            for name, shards in owned.items():
                part = shards[k].index_select(0, local)
                moved += part.numel() * part.element_size()
                got[name].index_copy_(0, dest, part.to(device))
        base = 1 + torch.arange(w2, dtype=torch.int32, device=device) * self.cb
        for name in ("fwd", "rev"):
            got[name][:, :, 1] += base[:, None]
        return got, moved


class ShardedRenderer:
    """A Renderer over a world-sharded mesh: bit-equal to ``Renderer`` on the
    same LODs, with LOD0 striped over the devices and only the camera-local
    window on the rendering device (the mesh's first).

    With ``ray_mesh`` (a ``parallel.mesh.RenderMesh``) the two sharding
    modes compose: the active window is replicated over the ray mesh and one
    camera's rays shard over its devices (``mesh.render_frame_sharded``; on
    the graph route each shard in a march graph of its own, into whose own
    world a window move is copied, with no capture)."""

    def __init__(self, lods: list[WorldLOD], mesh, config=None,
                 tile_cols: int = 256, ray_mesh=None):
        from cpuvox_tpu_torch.config import RenderConfig

        cfg = config or RenderConfig()
        if cfg.argb_records:
            raise ValueError("world sharding: ARGB record mode not supported")
        _check_supported(cfg)
        self.sw = ShardedWorld.build(lods, mesh, tile_cols=tile_cols,
                                     skybox_rgb=cfg.skybox_rgb)
        sw = self.sw
        meta = _ActiveWorldMeta(
            dims=sw.dims, lod_levels=sw.lod_levels, max_runs=sw.max_runs,
            lod0_voxels=sw.lod0_voxels, empty_frac=sw.empty_frac,
            solid_min_y=sw.solid_min_y, solid_max_y=sw.solid_max_y)
        dev = sw.devices[0]
        self.inner = Renderer(device_world=meta, config=cfg, device=dev)
        self.ray_mesh = ray_mesh

        def put(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

        # the coarse tables on the rendering device, rebased per window
        self._coarse = {"fwd": put(sw.coarse_fwd), "rev": put(sw.coarse_rev),
                        "colors": put(sw.coarse_colors.view(np.int32)),
                        "skybox": put(np.array([sw.skybox]).view(np.int32))}
        if sw.owned_occ is not None:
            self._coarse["occ"] = put(sw.coarse_occ)
        self._window_key = None
        self._n_exchanges = 0
        self._exchange_bytes = 0  # the owners' gathers, all exchanges

    def _window(self, cam: cm.Camera):
        """Camera-centered tile window (tx0, tz0, W): half-extent
        ceil((lod_distances[0] + 2) / T) tiles holds every LOD0 visit (entry
        distance < lod_distances[0], +1 cell extent, +1 margin)."""
        sw = self.sw
        t = 1 << sw.tl
        r0 = float(self.inner.lod_distances[0])
        ntm = max(sw.nt_x, sw.nt_z)
        if not math.isfinite(r0) or 2 * math.ceil((r0 + 2) / t) + 1 >= ntm:
            return 0, 0, ntm  # the window covers the whole grid
        w = 2 * math.ceil((r0 + 2) / t) + 1
        tcx = int(np.floor(cam.position[0])) >> sw.tl
        tcz = int(np.floor(cam.position[2])) >> sw.tl
        return tcx - w // 2, tcz - w // 2, w

    def _activate(self, tx0: int, tz0: int, w: int):
        """Fetch the window and assemble the active ``WorldArrays``,
        memoized by the window's corner (``world_shard.py:320-398``)."""
        if self._window_key == (tx0, tz0, w):
            return
        sw, dev, co = self.sw, self.inner.device, self._coarse
        t = 1 << sw.tl
        wi = np.arange(w)
        txs, tzs = tx0 + wi[:, None], tz0 + wi[None, :]
        valid = (txs >= 0) & (txs < sw.nt_x) & (tzs >= 0) & (tzs < sw.nt_z)
        tids = np.where(valid, txs * sw.nt_z + tzs, -1)
        got, moved = sw.exchange(tids, dev)
        self._n_exchanges += 1
        self._exchange_bytes += moved
        w2 = w * w

        def fine_plus_coarse(key, cb_shift=True):
            """[window blocks, zero sentinel block, rebased coarse rows]."""
            blocks = got[key]
            sent = torch.zeros((1,) + blocks.shape[1:], dtype=torch.int32,
                               device=dev)
            fine = torch.cat([blocks, sent]).reshape(-1, blocks.shape[-1])
            coarse = co[key]
            if cb_shift:  # coarse colors follow the fine color blocks
                coarse = coarse.clone()
                coarse[:, 1] += 1 + w2 * sw.cb
            return torch.cat([fine, coarse])

        def put(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

        colors = torch.cat([co["skybox"], got["colors"].reshape(-1),
                            co["colors"]])
        col_base = sw.col_base.copy()
        n0 = sw.nt_x * sw.nt_z * t * t
        col_base[1:] = (w2 + 1) * t * t + (col_base[1:] - n0)
        col_base[0] = 0
        occ = tile_base = tile_gz = None
        if "occ" in got:
            occ = fine_plus_coarse("occ", cb_shift=False)
            tile_base = sw.tile_base.copy()
            tile_base[1:] = (w2 + 1) * ((t * t) // 128) + (
                sw.tile_base[1:] - sw.tile_base[1])
            tile_base[0] = 0
            tile_base, tile_gz = put(tile_base), put(sw.tile_gz)
        wa = raymarch.WorldArrays(
            col_base=put(col_base), grid_z=put(sw.grid_z),
            rec_fwd=fine_plus_coarse("fwd"), rec_rev=fine_plus_coarse("rev"),
            colors=colors, max_runs=int(sw.max_runs), occ_tiles=occ,
            tile_base=tile_base, tile_gz=tile_gz,
            win=put(np.array([tx0, tz0, sw.tl, w], np.int32)))
        self.inner._wa = wa
        if self.ray_mesh is not None:
            # composed mode: the active window replicated over the ray mesh
            for d in self.ray_mesh.devices:
                self.ray_mesh.replica(wa, d)
        self._window_key = (tx0, tz0, w)

    def render(self, cam: cm.Camera, **kw):
        """One frame, as ``Renderer.render``: (H, W) uint32 ARGB numpy (and
        the raybuffers with ``return_raybuffers``, not in composed mode)."""
        cam2, _ = self.inner.setup_camera(cam)  # resolves lod_distances
        self._activate(*self._window(cam2))
        if self.ray_mesh is not None:
            from cpuvox_tpu_torch.parallel.mesh import render_frame_sharded

            if kw:
                raise ValueError("composed sharded render: no raybuffer "
                                 "views")
            return render_frame_sharded(self.inner, cam, self.ray_mesh)
        return self.inner.render(cam, **kw)
