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
  (``render_frame_sharded_device``);
- ``cam``: a batch of cameras split in contiguous blocks over the devices
  (``parallel/batch.render_camera_batch(..., rmesh=)``).

A list may name a device more than once (``["cuda:0"] * 4``, ``["cpu"] *
8``): every split, gather and replica then runs on one card, as the JAX
tests' 8 virtual CPU devices run on one host.

On the graph route (``Renderer.graph_route`` on every device of the mesh)
the shards are JAX's one program: shard k marches in a staged
``MarchGraph`` of its own (``Renderer.shard_graph``, at the shard's ray
count) on that graph's own CUDA stream (``MarchGraph.stream``), so the
shards of one card run at once, and the first device's stream waits on an
event a shard before it reads the gathered rows.  No host read happens
until the caller copies the screen.  Every shard's variant is resolved
before any shard launches, and a capture first waits for the mesh's
devices (``sync_once``), so a capture never overlaps a running graph.  Off
the graph route (the CPU, the plain versions) the host drives each shard's
loop in turn (``sharded_march``): the plain version.

Streams: a shard's stream waits for the first device's stream (an event
after the rays and the world) before it reads either, and the first
device's stream waits for each shard's event before anything more is
queued on it, so what a shard reads is not freed and handed out again
while the shard still reads it; what a shard makes and the first device
reads is copied into a tensor made on the first device's stream, or is
marked with ``record_stream``.  Across cards torch copies on the source
device's current stream and makes the two devices' streams wait for each
other, so every shard's march is queued before any shard's rows are
copied back: a copy back makes the first device's stream wait for that
shard, and the next shard's input copies, queued on that stream, would
wait with it.
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

    def on_graphs(self, renderer) -> bool:
        """Whether the shards march through graphs: ``renderer`` takes the
        graph route on every device of the mesh."""
        return all(renderer.graph_route(d) for d in self.devices)

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


def record(stream, timing: bool = False):
    """A CUDA event recorded on ``stream`` now (None for no stream)."""
    if stream is None:
        return None
    e = torch.cuda.Event(enable_timing=timing)
    e.record(stream)
    return e


def sync_once(devices):
    """A callable that, on its first call only, waits for every CUDA
    device of ``devices``: the shards' ``before_capture``, so that no
    graph still runs while one is captured."""
    done = []

    def sync():
        if not done:
            for d in dict.fromkeys(devices):
                if d.type == "cuda":
                    torch.cuda.synchronize(d)
            done.append(True)
    return sync


def shard_variants(renderer, rmesh: RenderMesh, jobs) -> list:
    """Every shard's graph variant before any shard launches.  ``jobs``:
    a (graph, world, cam_data, iteration direction) a shard.  Each graph's
    stream first waits for an event on the first device's stream (after
    the rays and the world's replicas), then resolves its variant: its
    world copied in, and on first use a capture, after a sync of the
    mesh's devices (``sync_once``)."""
    ready = record(raymarch.current_stream(rmesh.devices[0]))
    sync = sync_once(rmesh.devices)
    variants = []
    for g, wa, cam_data, direction in jobs:
        with torch.cuda.stream(g.stream):
            if g.stream is not None:
                g.stream.wait_event(ready)
            variants.append(renderer.graph_variant(
                g, wa, cam_data, direction, before_capture=sync))
    return variants


def join(stream, events) -> None:
    """``stream`` waits for each shard's event (None: nothing to wait
    for)."""
    for e in events:
        if e is not None:
            stream.wait_event(e)


def sharded_march_graphs(renderer, rmesh: RenderMesh, f,
                         spans: list | None = None) -> torch.Tensor:
    """Phase 1 of frame ``f`` (its rays on the mesh's first device) on the
    graph route, JAX's ``shard_map`` program (``mesh.py:96-160``): shard k
    marches its contiguous slice of the rays through its own
    ``MarchGraph`` (``Renderer.shard_graph("ray", k, ...)``, staged as the
    Renderer compacts, at the shard's ray count) on the graph's stream
    against the world's replica on its device; once every shard is queued,
    each copies its rows into the gather on its stream, and the first
    device's stream waits on each shard's event, holding an (R, P)
    raybuffer.  Nothing is read from a device.  ``spans``, where given,
    takes a pair of timing events around each shard's input and march on
    its stream."""
    devs = rmesh.devices
    R, n = f.alive0.shape[0], rmesh.n_ray_shards
    if R % n:
        raise ValueError(f"{R} rays do not split over {n} shards")
    bounds = shard_bounds(R, n)
    dev0 = devs[0]
    graphs = [renderer.shard_graph("ray", k, b - a, d)
              for k, (d, (a, b)) in enumerate(zip(devs, bounds))]
    variants = shard_variants(renderer, rmesh, [
        (g, rmesh.replica(renderer._wa, d), f.cam_data, f.iteration_direction)
        for g, d in zip(graphs, devs)])
    parts = []
    for g, v, d, (a, b) in zip(graphs, variants, devs, bounds):
        s = g.stream
        with torch.cuda.stream(s):
            start = record(s, True) if spans is not None else None
            # the shard's rows: views on the first device, else copies
            static = RayStatic(*(x[a:b].to(d) for x in f.static))
            dda = DDAState(*(x[a:b].to(d) for x in f.dda))
            parts.append(g.march(v, static, dda, f.alive0[a:b].to(d),
                                 f.cam_data.position[1]))
            if spans is not None:
                spans.append([start, record(s, True)])
    raybuf = torch.empty(R, graphs[0].shape[1], dtype=torch.int32,
                         device=dev0)  # on the first device's stream
    done = []
    for g, part, (a, b) in zip(graphs, parts, bounds):
        with torch.cuda.stream(g.stream):
            raybuf[a:b].copy_(part)
            done.append(record(g.stream))
    join(raymarch.current_stream(dev0), done)
    return raybuf


def sharded_frame_rays(renderer, rmesh: RenderMesh) -> int:
    """The ray-sharded frame's ray count: the Renderer's capacity padded
    to a multiple of 128 a shard (``mesh.py:155-156``; the padding slots
    are dead rays)."""
    rw, rh = renderer.render_wh
    quantum = 128 * rmesh.n_ray_shards
    return ((3 * (rw + rh) + quantum - 1) // quantum) * quantum


def render_frame_sharded_device(renderer, cam, rmesh: RenderMesh,
                                spans: list | None = None) -> torch.Tensor:
    """Render ONE camera's frame with phase 1 sharded over all the mesh's
    devices (``mesh.py:162-232``): the rays initialised on the first
    device as the Renderer does (host or device: the same bits), each
    shard marched through the kernels or the plain versions, in graphs
    (``sharded_march_graphs``: no host read) or on the host loop
    (``sharded_march``), compacted or not, as the Renderer resolves it,
    and phase 2 in one launch on the first device.  Returns the (H, W)
    int32 ARGB screen there, as ``Renderer.render_device`` does; ``spans``
    as ``sharded_march_graphs`` takes it (the graph route only)."""
    from cpuvox_tpu_torch.ops import reproject_kernel as rk

    R = sharded_frame_rays(renderer, rmesh)
    dev0 = rmesh.devices[0]
    with on_device(dev0):
        f = renderer.frame_setup(cam, R=R, device=dev0)
        if rmesh.on_graphs(renderer):
            raybuf = sharded_march_graphs(renderer, rmesh, f, spans)
        else:
            raybuf = sharded_march(
                rmesh, renderer._wa, f.static, f.dda, f.alive0,
                f.cam_data.lod_distances, f.cam_data.far_clip,
                renderer.device_world.dims[1], f.cam_data.position[1],
                iteration_direction=f.iteration_direction,
                **renderer.march_kwargs())
        args = list(renderer.phase2_args(f, raybuf))
        if args[6] is not None:  # index mode: the color table there
            args[6] = rmesh.replica(renderer._wa, dev0).colors
        phase2 = (rk.reproject_screen if renderer.kernels
                  else rk.reproject_screen_ref)
        return phase2(*args)


def render_frame_sharded(renderer, cam, rmesh: RenderMesh) -> np.ndarray:
    """``render_frame_sharded_device`` and the screen's copy to the host
    (``np.asarray(screen)``, ``mesh.py:232``): the (H, W) uint32 ARGB
    numpy screen, bit-equal to ``renderer.render(cam)``."""
    screen = render_frame_sharded_device(renderer, cam, rmesh)
    return screen.cpu().numpy().view(np.uint32)
