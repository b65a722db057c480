"""Rendering over several devices from one process (the counterpart of
``cpuvox_tpu/parallel/mesh.py``).

The JAX mesh has a single controller: one process jits a ``shard_map`` over
``jax.devices()`` and gets one screen back.  Here the mesh is that process's
list of ``torch.device``s, and a shard is a slice of the work placed on its
device:

- ``rays``: one camera's rays split into contiguous slices, one a device,
  each marched against a replica of the world on its device (the same
  tensors where the device already holds the world: no copy); the raybuffer
  rows are gathered onto the first device for one phase-2 launch
  (``render_frame_sharded``);
- ``cam``: a batch of cameras split in contiguous blocks over the devices
  (``parallel/batch.render_camera_batch(..., rmesh=)``).

A list may name a device more than once (``["cuda:0"] * 4``, ``["cpu"] *
8``): every split, gather and replica then runs on one card, as the JAX
tests' 8 virtual CPU devices run on one host.  The shards run one after
another from the host.  A ray shard's march reads its live count once a
chunk, so N shards on one card make about N times the launches of one
march; a camera block on the graph route is one launch of a batch march
graph on its device and reads nothing.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from cpuvox_tpu_torch.render import raymarch
from cpuvox_tpu_torch.render.raymarch import DDAState, RayStatic


def as_device(d) -> torch.device:
    """``d`` as a ``torch.device`` with its CUDA index filled in."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def on_device(d: torch.device):
    """A context that makes ``d`` the current CUDA device (the kernels
    launch on the current device's stream); nothing for another device."""
    return torch.cuda.device(d) if d.type == "cuda" else contextlib.nullcontext()


@dataclasses.dataclass
class RenderMesh:
    """The devices of a sharded render.  Every shard of a ray or camera
    split is one entry of ``devices``."""

    devices: list
    # device -> (the world it was made from, its replica there)
    _replicas: dict = dataclasses.field(default_factory=dict, repr=False)

    @classmethod
    def create(cls, devices=None) -> "RenderMesh":
        """A mesh over ``devices`` (every CUDA device for None; a list may
        repeat a device).  With no card and no list it raises: the mesh
        never falls back to the CPU."""
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "RenderMesh.create: no CUDA device (name the devices, "
                    "e.g. devices=['cpu'] * 8, to shard over another kind)")
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        devices = [as_device(d) for d in devices]
        if not devices:
            raise ValueError("RenderMesh.create: an empty list of devices")
        return cls(devices=devices)

    @property
    def n_ray_shards(self) -> int:
        return len(self.devices)

    def replica(self, wa: raymarch.WorldArrays,
                device: torch.device) -> raymarch.WorldArrays:
        """``wa`` on ``device``: ``wa`` itself where it lies there already,
        else a copy, made once for each world and device."""
        if all(x.device == device for x in wa
               if isinstance(x, torch.Tensor)):
            return wa
        hit = self._replicas.get(device)
        if hit is not None and hit[0] is wa:
            return hit[1]
        rep = raymarch.WorldArrays(*(
            x.to(device) if isinstance(x, torch.Tensor) else x for x in wa))
        self._replicas[device] = (wa, rep)
        return rep


def shard_bounds(n_items: int, n_shards: int) -> list[tuple[int, int]]:
    """Contiguous [start, stop) slices of ``n_items``, one a shard."""
    cut = [n_items * i // n_shards for i in range(n_shards + 1)]
    return list(zip(cut[:-1], cut[1:]))


def _put(x: torch.Tensor, a: int, b: int, device):
    """Rows [a, b) of ``x`` as a contiguous tensor on ``device``."""
    return x[a:b].to(device).contiguous()


def shard_ray_state(rmesh: RenderMesh, static: RayStatic, dda: DDAState,
                    alive0):
    """Per-ray state split along the ray axis into contiguous slices, one a
    shard, each on its shard's device: a list of (static, dda, alive0)."""
    R = alive0.shape[0]
    n = rmesh.n_ray_shards
    if R % n:
        raise ValueError(f"{R} rays do not split over {n} shards")
    return [(RayStatic(*(_put(x, a, b, d) for x in static)),
             DDAState(*(_put(x, a, b, d) for x in dda)),
             _put(alive0, a, b, d))
            for d, (a, b) in zip(rmesh.devices, shard_bounds(R, n))]


def sharded_march(rmesh: RenderMesh, wa: raymarch.WorldArrays, static, dda,
                  alive0, lod_distances, far_clip, world_max_y, cam_y,
                  **kw) -> torch.Tensor:
    """Phase 1 with the rays sharded over the mesh and the world replicated
    (``mesh.py:71-91``): each slice runs ``raymarch.phase1`` (``kw``: its
    keywords, ``Renderer.march_kwargs``) on its device, one after another.
    ``cam_y`` is a scalar or an (R,) numpy array a ray.  Returns the
    (R, P) raybuffer, its rows gathered onto the mesh's first device."""
    shards = shard_ray_state(rmesh, static, dda, alive0)
    bounds = shard_bounds(alive0.shape[0], rmesh.n_ray_shards)
    per_ray = np.ndim(cam_y) > 0
    parts = []
    for d, (st, dd, al), (a, b) in zip(rmesh.devices, shards, bounds):
        with on_device(d):
            parts.append(raymarch.phase1(
                rmesh.replica(wa, d), st, dd, al, lod_distances, far_clip,
                world_max_y, cam_y[a:b] if per_ray else cam_y, **kw))
    dev0 = rmesh.devices[0]
    return torch.cat([p.to(dev0) for p in parts])


def render_frame_sharded(renderer, cam, rmesh: RenderMesh) -> np.ndarray:
    """Render ONE camera's frame with phase 1 sharded over all the mesh's
    devices (``mesh.py:162-232``): the ray capacity padded to a multiple of
    128 a shard (the padding slots are dead rays), the rays initialised as
    the Renderer does (host or device: the same bits), each shard marched
    through the kernels or the plain versions, compacted or not, as the
    Renderer resolves it, and phase 2 in one launch on the first device.
    Returns the (H, W) uint32 ARGB numpy screen, bit-equal to
    ``renderer.render(cam)``."""
    from cpuvox_tpu_torch.ops import reproject_kernel as rk

    rw, rh = renderer.render_wh
    quantum = 128 * rmesh.n_ray_shards
    R = ((3 * (rw + rh) + quantum - 1) // quantum) * quantum
    dev0 = rmesh.devices[0]
    with on_device(dev0):
        f = renderer.frame_setup(cam, R=R, device=dev0)
    raybuf = sharded_march(
        rmesh, renderer._wa, f.static, f.dda, f.alive0,
        f.cam_data.lod_distances, f.cam_data.far_clip,
        renderer.device_world.dims[1], f.cam_data.position[1],
        iteration_direction=f.iteration_direction, **renderer.march_kwargs())
    args = list(renderer.phase2_args(f, raybuf))
    if args[6] is not None:  # index mode: the color table on the first device
        args[6] = rmesh.replica(renderer._wa, dev0).colors
    phase2 = rk.reproject_screen if renderer.kernels else rk.reproject_screen_ref
    with on_device(dev0):
        screen = phase2(*args)
    return screen.cpu().numpy().view(np.uint32)
