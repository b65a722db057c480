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
devices, which may be uneven, each block bucketed on its own: each device
runs the same program on its block against its replica of the world, the
host queuing every block before it waits for any.
"""
from __future__ import annotations

import numpy as np
import torch

from cpuvox_tpu_torch.parallel.mesh import on_device, shard_bounds
from cpuvox_tpu_torch.render import device_init


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
    p = device_init.stack_frame_params(
        [device_init.build_frame_params(f.cam_data, f.segs, f.ctxs)
         for f in frames], bucket)
    static, dda, alive0, cam_y, cam_y_norm = device_init.init_rays_batch(
        p, renderer.device_world.dims, R1, device)
    if renderer.graph_route(device):
        return renderer.march_batch_graph(static, dda, alive0, cam_y,
                                          cam_y_norm, frames[0].cam_data,
                                          direction, wa)
    return renderer.march_rays(static, dda, alive0, frames[0].cam_data,
                               np.repeat(p.cam_pos[:, 1], R1), direction,
                               wa=wa)


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


def render_camera_batch(renderer, cams, rmesh=None) -> torch.Tensor:
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
    world."""
    frames = [renderer.frame_geometry(cam) for cam in cams]
    devices = [renderer.device] if rmesh is None else rmesh.devices
    R1 = renderer.ray_capacity
    out = [None] * len(cams)
    for direction in (1, -1):
        ids = [i for i, f in enumerate(frames)
               if f.iteration_direction == direction]
        for dev, (a, b) in zip(devices, shard_bounds(len(ids), len(devices))):
            if a == b:
                continue
            group = [frames[i] for i in ids[a:b]]
            wa = None if rmesh is None else rmesh.replica(renderer._wa, dev)
            with on_device(dev):
                raybuf = march_group(renderer, group, direction,
                                     bucket_size(len(group), len(cams)), wa,
                                     dev)
                screens = phase2_group(renderer, raybuf[:len(group) * R1],
                                       group, wa)
            for j, i in enumerate(ids[a:b]):
                out[i] = screens[j].to(devices[0])
    return torch.stack(out)
