"""Batched multi-camera rendering, the RL-rollout mode
(``cpuvox_tpu/parallel/batch.py:56-193``).

The march is ray-agnostic, so a batch of cameras is more rays: each camera
gets a contiguous block of ``Renderer.ray_capacity`` (R1) rays, the rays of
all cameras that iterate the same way march together in one phase 1 (a
camera height a ray), and phase 2 reads each camera's block of the
raybuffer.  Cameras split by iteration direction (the sign of the pitch),
so a batch is at most two marches.

A direction group is the JAX batch's device program (``_batch_frame_fn``):

- its cameras' parameters go up in one copy and its rays are built on the
  device in one vectorised pass (``device_init.init_rays_batch``), whatever
  ``host_init`` says, as the JAX batch does;
- the group is padded to a bucket of cameras with no rays, the next power
  of two at or above its size, capped at the batch's (``batch.py:138-163``),
  so that a new pitch split finds its march already built;
- on the graph route (``Renderer.graph_route``: a CUDA Renderer with the
  kernels on) the march is one launch of a batch march graph
  (``Renderer.march_batch_graph``), staged at the group's bucketed ray
  count when the Renderer compacts, as JAX's batch compacts through
  ``phase1_pallas`` (``batch.py:85``); the CPU and the plain versions march
  on the host loop (``Renderer.march_rays``);
- phase 2 runs over the real cameras only, one launch
  (``reproject_kernel.reproject_screens``).

On the graph route nothing reads the device, so the host sets up the next
step while the card runs this one.  Over a ``parallel.mesh.RenderMesh``
(``rmesh``) a group's cameras split in contiguous blocks over the mesh's
devices, which may be uneven, each block bucketed on its own, and each
block runs the same program on its device against its replica of the
world.  On the graph route block k of either direction runs in a batch
graph of its own (``Renderer.shard_graph("cam", k, ...)``) on that
graph's stream, so the blocks of one card run at once; every block's
variant is resolved before any block launches, every block is queued
before any block's screens are copied to the first device, and the first
device's stream waits on each block's event before it takes the screens.
Off it the host runs the blocks in turn on the host loop.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cpuvox_tpu_torch.parallel.mesh import (join, on_device, record,
                                            shard_bounds, shard_variants)
from cpuvox_tpu_torch.render import device_init, raymarch


def bucket_size(n: int, cap: int) -> int:
    """The cameras a group of ``n`` is padded to (``batch.py:142-146``): the
    next power of two at or above ``n``, at most ``cap`` (the batch's)."""
    bucket = 1
    while bucket < n:
        bucket *= 2
    return min(bucket, cap)


def march_group(renderer, frames, direction: int, bucket: int, wa=None,
                device=None):
    """Phase 1 of a direction group's cameras in one march, padded to
    ``bucket`` cameras: the (bucket * R1, P) raybuffer, camera b's rows in
    block b, the padded cameras' last.  The rays are built in one pass on
    ``device`` (the Renderer's for None), then marched against ``wa`` (a
    replica of the Renderer's world there; its own for None) through a
    batch march graph on the graph route (staged where the Renderer
    compacts), else on the host loop."""
    device = torch.device(renderer.device if device is None else device)
    R1 = renderer.ray_capacity
    p, (static, dda, alive0, cam_y, cam_y_norm) = group_rays(
        renderer, frames, bucket, device)
    if renderer.graph_route(device):
        return renderer.march_batch_graph(static, dda, alive0, cam_y,
                                          cam_y_norm, frames[0].cam_data,
                                          direction, wa)
    return renderer.march_rays(static, dda, alive0, frames[0].cam_data,
                               np.repeat(p.cam_pos[:, 1], R1), direction,
                               wa=wa)


def group_rays(renderer, frames, bucket: int, device):
    """A direction group's rays built on ``device`` in one pass, padded to
    ``bucket`` cameras: (the stacked ``FrameParams``, ``init_rays_batch``'s
    (static, dda, alive0, cam_y, cam_y_norm))."""
    p = device_init.stack_frame_params(
        [device_init.build_frame_params(f.cam_data, f.segs, f.ctxs)
         for f in frames], bucket)
    return p, device_init.init_rays_batch(
        p, renderer.device_world.dims, renderer.ray_capacity, device)


def phase2_group_args(renderer, raybuf, frames, wa=None) -> tuple:
    """The arguments of ``reproject_kernel.reproject_screens`` for a group's
    raybuffer: the raybuffer, each camera's tables, R1, the render and the
    output size, the color table (None in ARGB mode; ``wa``'s where given)
    and the skybox."""
    _rb, _tables, rw, rh, W, H, colors, skybox = renderer.phase2_args(
        frames[0], raybuf)
    if colors is not None and wa is not None:
        colors = wa.colors
    return (raybuf, [f.tables for f in frames], renderer.ray_capacity, rw, rh,
            W, H, colors, skybox)


def phase2_group(renderer, raybuf, frames, wa=None):
    """Phase 2 of a group's cameras from their joined raybuffer: (B, H, W)
    int32 ARGB bits.  With kernels, one launch of the batched phase-2 kernel
    (``reproject_kernel.reproject_screens``)."""
    from cpuvox_tpu_torch.ops import reproject_kernel as rk

    fn = rk.reproject_screens if renderer.kernels else rk.reproject_screens_ref
    return fn(*phase2_group_args(renderer, raybuf, frames, wa))


def render_camera_batch(renderer, cams, rmesh=None,
                        spans: list | None = None) -> torch.Tensor:
    """Render a batch of cameras in at most two marches (one an iteration
    direction), or over ``rmesh`` (a ``parallel.mesh.RenderMesh``) at most
    two a device.  Returns (B, H, W) int32 ARGB bits in the order of
    ``cams``, on the Renderer's device, or with ``rmesh`` on its first.

    Each camera is set up with the Renderer's own setup; the LOD distances
    and the far clip are the first camera's (``Renderer.setup_camera`` keeps
    them), as in the reference (``batch.py:82-83``).  The march is dense or
    gated as the Renderer resolves it, in index or ARGB mode, through a
    batch march graph or on the host loop as ``Renderer.graph_route`` says.
    With ``rmesh`` each direction group's cameras split in contiguous
    blocks over the devices (``batch.py:103-112``), each block bucketed,
    marched and reprojected on its device against a replica of the
    world, on the blocks' graphs' streams on the graph route
    (``blocks_on_streams``, ``spans`` as it takes them)."""
    frames = [renderer.frame_geometry(cam) for cam in cams]
    devices = [renderer.device] if rmesh is None else rmesh.devices
    blocks = []  # (slot, device, direction, the cameras' indices)
    for direction in (1, -1):
        ids = [i for i, f in enumerate(frames)
               if f.iteration_direction == direction]
        for k, (dev, (a, b)) in enumerate(
                zip(devices, shard_bounds(len(ids), len(devices)))):
            if a < b:
                blocks.append((k, dev, direction, ids[a:b]))
    if rmesh is not None and rmesh.on_graphs(renderer):
        return blocks_on_streams(renderer, frames, blocks, rmesh, spans)
    R1 = renderer.ray_capacity
    out = [None] * len(cams)
    for _k, dev, direction, ids in blocks:
        group = [frames[i] for i in ids]
        wa = None if rmesh is None else rmesh.replica(renderer._wa, dev)
        with on_device(dev):
            raybuf = march_group(renderer, group, direction,
                                 bucket_size(len(group), len(cams)), wa, dev)
            screens = phase2_group(renderer, raybuf[:len(group) * R1],
                                   group, wa)
        for j, i in enumerate(ids):
            out[i] = screens[j].to(devices[0])
    return torch.stack(out)


class _Block(NamedTuple):
    """A camera block on the graph route: its device, its cameras' frames
    and indices, their direction and bucket, the world's replica there and
    the block's batch graph (whose stream it runs on)."""

    device: torch.device
    group: list
    ids: list
    direction: int
    bucket: int
    wa: object
    graph: object


def blocks_on_streams(renderer, frames, blocks, rmesh,
                      spans: list | None = None) -> torch.Tensor:
    """The camera blocks (``render_camera_batch``'s (slot, device,
    direction, indices)) on the graph route: block k builds its rays,
    marches in its batch graph (``Renderer.shard_graph("cam", k, bucket *
    R1, device)``) and makes its phase-2 launch, all on the graph's stream;
    once every block is queued, each block's screens go to the first
    device on its stream, the first device's stream waits on each block's
    event, then stacks the screens, (B, H, W) int32 there.  Nothing is read
    from a device.  ``spans``, where given, takes a pair of timing events
    around each block's rays, march and phase 2 on its stream."""
    R1 = renderer.ray_capacity
    dev0 = rmesh.devices[0]
    plans = []
    for k, dev, direction, ids in blocks:
        group = [frames[i] for i in ids]
        bucket = bucket_size(len(group), len(frames))
        plans.append(_Block(dev, group, ids, direction, bucket,
                            rmesh.replica(renderer._wa, dev),
                            renderer.shard_graph("cam", k, bucket * R1, dev)))
    variants = shard_variants(renderer, rmesh, [
        (b.graph, b.wa, b.group[0].cam_data, b.direction) for b in plans])
    screens = []
    for b, v in zip(plans, variants):
        s = b.graph.stream
        with torch.cuda.stream(s):
            start = record(s, True) if spans is not None else None
            _p, (static, dda, alive0, cam_y, cam_y_norm) = group_rays(
                renderer, b.group, b.bucket, b.device)
            raybuf = b.graph.march(v, static, dda, alive0, cam_y, cam_y_norm)
            screens.append(phase2_group(renderer, raybuf[:len(b.group) * R1],
                                        b.group, b.wa))
            if spans is not None:
                spans.append([start, record(s, True)])
    moved, done = [], []
    for b, sc in zip(plans, screens):
        with torch.cuda.stream(b.graph.stream):
            # across devices: copied on the block's stream into a tensor of
            # the first device's stream, which waits for the copy
            moved.append(sc.to(dev0))
            done.append(record(b.graph.stream))
    s0 = raymarch.current_stream(dev0)
    join(s0, done)
    out = [None] * len(frames)
    for b, m in zip(plans, moved):
        if b.graph.stream is not None and b.device == dev0:
            m.record_stream(s0)  # made on the block's stream, read on s0
        for j, i in enumerate(b.ids):
            out[i] = m[j]
    return torch.stack(out)
