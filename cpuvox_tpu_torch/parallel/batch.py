"""Batched multi-camera rendering, the RL-rollout mode
(``cpuvox_tpu/parallel/batch.py:103-193``).

The march is ray-agnostic, so a batch of cameras is more rays: each camera
gets a contiguous block of ``Renderer.ray_capacity`` (R1) rays, the rays of
all cameras that iterate the same way march together in one phase 1 (a
camera height a ray, ``raymarch.phase1``'s ``cam_y``), and phase 2 reads each
camera's block of the raybuffer.  Cameras split by iteration direction (the
sign of the pitch), so a batch is at most two marches.

Unlike the JAX package, nothing is padded to a bucket of cameras: that kept
jit signatures stable across steps, and eager torch has none.  The
multi-card camera sharding (``rmesh``) is not carried here.
"""
from __future__ import annotations

import numpy as np
import torch

from cpuvox_tpu_torch.render import ray_init
from cpuvox_tpu_torch.render.raymarch import DDAState, RayStatic

# fields of the host ray init, in the order they are copied to the card
_STATIC = RayStatic._fields
_DDA = DDAState._fields


def _group_rays_host(renderer, frames):
    """Every camera's rays built with numpy on the host, each field of the
    group copied to the card once (13 copies a group, not 13 a camera)."""
    dims, R1 = renderer.device_world.dims, renderer.ray_capacity
    parts = [ray_init.init_rays_np(f.cam_data, f.segs, f.ctxs, dims,
                                   fixed_size=R1)[:3] for f in frames]

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(renderer.device)

    static = RayStatic(**{k: put(np.concatenate([p[0][k] for p in parts]))
                          for k in _STATIC})
    dda = DDAState(**{k: put(np.concatenate([p[1][k] for p in parts]))
                      for k in _DDA})
    return static, dda, put(np.concatenate([p[2] for p in parts]))


def _group_rays_device(renderer, frames):
    """Every camera's rays built on the device (``host_init=False``), a
    camera at a time, then joined."""
    parts = [renderer.init_rays_device(f) for f in frames]
    static = RayStatic(*(torch.cat(x) for x in zip(*(p[0] for p in parts))))
    dda = DDAState(*(torch.cat(x) for x in zip(*(p[1] for p in parts))))
    return static, dda, torch.cat([p[2] for p in parts])


def march_group(renderer, frames, direction: int):
    """Phase 1 of a direction group's cameras in one march: their rays in
    consecutive blocks of R1, each ray with its camera's height; returns
    the group's (B * R1, P) raybuffer."""
    init = (_group_rays_host if renderer.config.host_init
            else _group_rays_device)
    static, dda, alive0 = init(renderer, frames)
    cam_y = np.repeat(np.asarray([f.cam_data.position[1] for f in frames],
                                 np.float32), renderer.ray_capacity)
    return renderer.march_rays(static, dda, alive0, frames[0].cam_data, cam_y,
                               direction)


def phase2_group_args(renderer, raybuf, frames) -> tuple:
    """The arguments of ``reproject_kernel.reproject_screens`` for a group's
    raybuffer: the raybuffer, each camera's tables, R1, the render and the
    output size, the color table (None in ARGB mode) and the skybox."""
    _rb, _tables, rw, rh, W, H, colors, skybox = renderer.phase2_args(
        frames[0], raybuf)
    return (raybuf, [f.tables for f in frames], renderer.ray_capacity, rw, rh,
            W, H, colors, skybox)


def phase2_group(renderer, raybuf, frames):
    """Phase 2 of a group's cameras from their joined raybuffer: (B, H, W)
    int32 ARGB bits.  With kernels, one launch of the batched phase-2 kernel
    (``reproject_kernel.reproject_screens``)."""
    from cpuvox_tpu_torch.ops import reproject_kernel as rk

    fn = rk.reproject_screens if renderer.kernels else rk.reproject_screens_ref
    return fn(*phase2_group_args(renderer, raybuf, frames))


def render_camera_batch(renderer, cams) -> torch.Tensor:
    """Render a batch of cameras in at most two marches (one an iteration
    direction).  Returns (B, H, W) int32 ARGB bits on the Renderer's device,
    in the order of ``cams``.

    Each camera is set up with the Renderer's own setup; the LOD distances
    and the far clip are the first camera's (``Renderer.setup_camera`` keeps
    them), as in the reference (``batch.py:82-83``).  The march is dense or
    gated and compacted or not as the Renderer resolves it, in index or ARGB
    mode."""
    frames = [renderer.frame_geometry(cam) for cam in cams]
    out = [None] * len(cams)
    for direction in (1, -1):
        ids = [i for i, f in enumerate(frames)
               if f.iteration_direction == direction]
        if not ids:
            continue
        group = [frames[i] for i in ids]
        screens = phase2_group(renderer, march_group(renderer, group,
                                                     direction), group)
        for j, i in enumerate(ids):
            out[i] = screens[j]
    return torch.stack(out)
