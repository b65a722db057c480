"""Per-frame ray init on the device (plain PyTorch).

Counterpart of ``cpuvox_tpu/render/device_init.py``: the per-ray setup that
``ray_init.init_rays_np`` builds with numpy on the host (DDASetupJob +
TraceToFirstColumnJob + SetupProjectedPlaneParams,
DrawSegmentRayJob.cs:49-143,622-651), as tensor ops on a tiny per-segment
parameter table.  A frame then sends the device one copy of 69 words in
place of the per-ray arrays.

Every float operation keeps the host init's order, so every field is
bit-equal to ``ray_init.init_rays(fixed_size=R)`` in every lane, padded and
dead lanes included.  What the reference needed for that on its TPU and the
port does not carry:

- ``_pin_one`` (FMA pins): torch runs eagerly, one kernel an operation, so
  every product is rounded before it meets a sum;
- ``utils/ieee.py``'s soft ``div_rn``/``sqrt_rn``: the card's f32 ``/`` and
  ``sqrt`` are correctly rounded.  Divisors and dividends that are constants
  stay 0-d tensors on the device: torch divides a CUDA tensor by a host
  scalar as a multiply by its reciprocal.  On a CPU tensor the one square
  root goes through f64 (``_sqrt``): torch's vectorised CPU ``sqrt`` is an
  ulp off numpy's on about 0.65 % of f32 inputs.

Where torch differs from numpy, the port follows numpy: the two tiny matrix
products are written out left to right (no ``torch.matmul``), min/max go
through ``raymarch._min``/``_max`` (like ``np.minimum``/``np.maximum`` they
return the NaN operand itself, the first where both are, not a canonical NaN), and f32 -> i32 casts give INT32_MIN out of range and for NaN on every
device (``_to_i32_host``).  ``jax.lax.cond(any_outside, ...)`` is a host
``if`` (every ray starts in its camera's cell, which the host knows) and,
within a batch, a select by each camera's flag.

A camera batch (``parallel/batch.py``) builds a direction group's rays in
one pass, ``init_rays_batch``, as the JAX batch vmaps ``init_rays_device``
over the group's cameras (``cpuvox_tpu/parallel/batch.py:69-70``): the
group's parameters go up in one copy, padded to a bucket of cameras with
no rays (``stack_frame_params``).  A single camera is the batch of one.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import camera as cm
from . import segments as sg
from .raymarch import I32_MIN, DDAState, RayStatic, _max, _min

F = np.float32


class FrameParams(NamedTuple):
    """Tiny per-frame arrays built on the host (see ``build_frame_params``);
    with a leading camera axis, a batch's (``stack_frame_params``)."""

    seg_ray_start: np.ndarray  # (4,) i32, first global ray index of a segment
    seg_ray_count: np.ndarray  # (4,) i32
    seg_plane_min: np.ndarray  # (4, 2) f32 CamLocalPlaneRayMin
    seg_plane_max: np.ndarray  # (4, 2) f32
    seg_axis_y: np.ndarray  # (4,) i32
    seg_orig_min: np.ndarray  # (4,) i32
    seg_orig_max: np.ndarray  # (4,) i32
    world_to_screen: np.ndarray  # (4, 4) f32
    cam_pos: np.ndarray  # (3,) f32
    lod_distances: np.ndarray  # (10,) f32 (padded with +inf)
    far_clip: np.ndarray  # () f32


def build_frame_params(cam_data: cm.CameraData, segs: list[sg.SegmentData],
                       ctxs: list[sg.SegmentContext]) -> FrameParams:
    """A copy of ``cpuvox_tpu/render/device_init.py:74`` that keeps its
    arrays in numpy."""
    start = np.zeros(4, np.int32)
    count = np.zeros(4, np.int32)
    pmin = np.zeros((4, 2), F)
    pmax = np.zeros((4, 2), F)
    axis = np.zeros(4, np.int32)
    omin = np.zeros(4, np.int32)
    omax = np.full(4, -1, np.int32)
    acc = 0
    for i, (seg, ctx) in enumerate(zip(segs, ctxs)):
        start[i] = acc
        count[i] = seg.ray_count
        acc += seg.ray_count
        if seg.ray_count > 0:
            pmin[i] = seg.cam_local_plane_ray_min
            pmax[i] = seg.cam_local_plane_ray_max
            axis[i] = ctx.axis_mapped_to_y
            omin[i] = ctx.next_free_pixel_min
            omax[i] = ctx.next_free_pixel_max
    lodd = np.append(cam_data.lod_distances.astype(F), [np.float32(np.inf)] * 4)
    return FrameParams(
        seg_ray_start=start, seg_ray_count=count, seg_plane_min=pmin,
        seg_plane_max=pmax, seg_axis_y=axis, seg_orig_min=omin,
        seg_orig_max=omax,
        world_to_screen=np.asarray(cam_data.world_to_screen, F),
        cam_pos=np.asarray(cam_data.position, F),
        lod_distances=lodd[:10], far_clip=np.float32(cam_data.far_clip))


def stack_frame_params(params: list[FrameParams], bucket: int) -> FrameParams:
    """B cameras' ``FrameParams`` stacked along a leading camera axis and
    padded with zero cameras up to ``bucket`` (``cpuvox_tpu/parallel/
    batch.py:157-163``).  A zero camera has ``seg_ray_count`` 0: none of its
    rays is in use, none alive."""
    if not 0 < len(params) <= bucket:
        raise ValueError(f"{len(params)} cameras for a bucket of {bucket}")

    def stack(xs):
        x = np.stack([np.asarray(v) for v in xs])
        pad = np.zeros((bucket - len(xs),) + x.shape[1:], x.dtype)
        return np.concatenate([x, pad])

    return FrameParams(*(stack(xs) for xs in zip(*params)))


def arrays_to(arrays, device) -> list[torch.Tensor]:
    """numpy arrays (f32, or integers that fit in int32) as tensors on
    ``device``, sent as one buffer of int32 words (f32 as their bits) and
    viewed apart there.  To a card the buffer goes from pinned memory,
    ``non_blocking``: the copy does not wait for the card, and the pinned
    allocator keeps the block until the copy is done."""
    arrays = [np.asarray(x) for x in arrays]
    words = np.concatenate([
        np.ascontiguousarray(x, F).reshape(-1).view(np.int32)
        if x.dtype == F else x.astype(np.int32).reshape(-1) for x in arrays])
    buf = torch.from_numpy(words)
    if torch.device(device).type == "cuda":
        buf = buf.pin_memory().to(device, non_blocking=True)
    else:
        buf = buf.to(device)
    out, at = [], 0
    for x in arrays:
        t = buf[at:at + x.size]
        at += x.size
        if x.dtype == F:
            t = t.view(torch.float32)
        out.append(t.reshape(x.shape))
    return out


def _to_i32_host(x):
    """f32 -> i32 as numpy and torch convert on the host: truncate, and
    INT32_MIN for NaN and whatever is out of range (a CUDA cast saturates and
    maps NaN to 0 instead)."""
    ok = (x >= -2147483648.0) & (x < 2147483648.0)
    return torch.where(ok, torch.where(ok, x, 0.0).to(torch.int32), I32_MIN)


def _sqrt(x):
    """The correctly rounded f32 square root, as numpy takes it.  The card's
    ``sqrt`` is; torch's vectorised CPU one is not (an ulp off on about
    0.65 % of inputs), so a CPU tensor takes the root in f64 and rounds it
    to f32: f64's 53 bits leave the f32 rounding unmoved (2 * 24 + 2 <= 53)."""
    return torch.sqrt(x) if x.is_cuda else x.double().sqrt().float()


def _mat4_vec(m, v4):
    """``camera.mat4_vec`` on tensors: (..., 4, 4) @ (4,) accumulated left
    to right, every product and sum rounded on its own; ``v4``'s entries
    broadcast against ``m[..., 0]``."""
    acc = m[..., 0] * v4[0]
    acc = acc + m[..., 1] * v4[1]
    acc = acc + m[..., 2] * v4[2]
    return acc + m[..., 3] * v4[3]


def init_rays_device(p: FrameParams, dims, R: int, device):
    """(RayStatic, DDAState, alive0) for R padded rays, on ``device``
    (``device_init.py:106``): ``init_rays_batch`` of the one camera.  ``p``
    holds numpy arrays (``build_frame_params``)."""
    return init_rays_batch(stack_frame_params([p], 1), dims, R, device)[:3]


def init_rays_batch(p: FrameParams, dims, R1: int, device):
    """A group of B cameras' rays in one vectorised pass on ``device``:
    (RayStatic, DDAState, alive0) of B * R1 rays, camera b's in the block
    [b * R1, (b + 1) * R1), then each ray's camera height and its
    ``cam_y / world_max_y``, (B * R1,) f32 (``cpuvox_tpu/parallel/
    batch.py:69-76``, ``jax.vmap(init_rays_device)``).  ``p`` holds numpy
    arrays with a leading camera axis (``stack_frame_params``); the LOD
    distances are the first camera's (a batch shares them).

    A ray's camera is ``ray // R1``, and each per-camera value is gathered
    by it: every operation keeps the single camera's order, so each block
    is bit-equal to the camera's init alone in every field and lane.  The
    host knows each camera's cell, so whether it starts outside the world
    travels as a flag a camera; where any camera does, the world entry and
    the LOD fast-forward run for every ray and ``torch.where`` keeps them
    on the rays of the cameras outside (what ``lax.cond`` under ``vmap``
    does), dropping the ``inf`` and NaN they make elsewhere.  The camera
    heights' quotient is numpy's f32 divide, as ``raymarch.raster_consts``
    takes it, computed on the host."""
    X, Z = dims[0], dims[2]
    B = p.cam_pos.shape[0]
    N = B * R1
    n_lods = int(np.isfinite(p.lod_distances[0]).sum())
    cell = np.floor(p.cam_pos[:, [0, 2]])
    outside = ((cell[:, 0] < 0) | (cell[:, 0] >= X) | (cell[:, 1] < 0)
               | (cell[:, 1] >= Z))
    cam_y = p.cam_pos[:, 1].astype(F)
    cam_y_norm = cam_y / F(dims[1])  # numpy's f32 divide
    *fields, cam_y, cam_y_norm, cam_out = arrays_to(
        (*p, cam_y, cam_y_norm, outside), device)
    p = FrameParams(*fields)
    f32 = dict(dtype=torch.float32, device=device)
    one = torch.ones((), **f32)
    zero = torch.zeros(N, **f32)
    world_max_y = torch.full((), float(dims[1]), **f32)
    ray_ids = torch.arange(N, dtype=torch.int32, device=device)
    cam = torch.div(ray_ids, R1, rounding_mode="floor")
    lid = ray_ids - cam * R1  # the ray's index in its camera's block
    cam = cam.long()

    # segment membership: seg_ray_start is cumulative
    ends = (p.seg_ray_start + p.seg_ray_count)[cam]  # (N, 4)
    seg_id = (lid[:, None] >= ends).sum(1).clamp(0, 3)
    in_use = lid < ends[:, 3]

    plane_index = lid - p.seg_ray_start[cam, seg_id]
    rc = p.seg_ray_count[cam, seg_id].clamp(min=1)
    # DDASetupJob (DrawSegmentRayJob.cs:58-69): lerp + normalize
    t = plane_index.float() / rc.float()
    lo = p.seg_plane_min[cam, seg_id]
    hi = p.seg_plane_max[cam, seg_id]
    d = lo + (hi - lo) * t[:, None]
    norm = _sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])[:, None]
    unit_x = (torch.arange(2, device=device) == 0).float()[None, :]
    dirs = torch.where(in_use[:, None], d / norm, unit_x)

    axis_y = p.seg_axis_y[cam, seg_id]
    orig_min = torch.where(in_use, p.seg_orig_min[cam, seg_id], 0)
    orig_max = torch.where(in_use, p.seg_orig_max[cam, seg_id], -1)

    # --- SegmentDDAData ctor (SegmentDDAData.cs:17-28)
    start_b = torch.stack([p.cam_pos[:, 0], p.cam_pos[:, 2]], dim=1)  # (B, 2)
    start = start_b[cam]
    pos = torch.floor(start).to(torch.int32)
    tdelta = one / torch.clamp(torch.abs(dirs), min=1e-7)
    sign_dir = torch.sign(dirs)
    stp = sign_dir.to(torch.int32)
    frac = start - torch.floor(start)
    tmax = (sign_dir * -frac + sign_dir * 0.5 + 0.5) * tdelta
    tprev = tmax - tdelta
    ids = torch.stack([_max(tprev[:, 0], tprev[:, 1]),
                       _min(tmax[:, 0], tmax[:, 1])], dim=1)
    alive = in_use
    lod = torch.zeros(N, dtype=torch.int32, device=device)

    # --- TraceToFirstColumnJob (:95-143): every ray of a camera starts in
    # its cell, so a camera's rays are all inside the world or all outside
    if outside.any():
        o_alive, o_state = _enter_world(
            start, dirs, (pos, tmax, tdelta, stp, ids, lod), alive,
            p.lod_distances[cam], p.far_clip[cam], n_lods, (float(X), float(Z)))
        out = cam_out[cam] != 0
        alive = torch.where(out, o_alive, alive)
        pos, tmax, tdelta, stp, ids, lod = (
            torch.where(out[:, None] if x.dim() == 2 else out, o, x)
            for o, x in zip(o_state, (pos, tmax, tdelta, stp, ids, lod)))

    # --- SetupProjectedPlaneParams (:622-651), a camera's points once and
    # gathered, its directions a ray
    m = p.world_to_screen  # (B, 4, 4)
    sx, sz = start_b[:, :1], start_b[:, 1:]
    pb4 = _mat4_vec(m, (sx, zero[0], sz, one))[cam]  # (N, 4)
    pt4 = _mat4_vec(m, (sx, world_max_y, sz, one))[cam]
    mr = m[cam]  # (N, 4, 4)
    # pd4[:, i] = sum_j dir4[j] * m[i, j], left to right like the host's;
    # dir4 = (dirs.x, 0, dirs.z, 0), the zero terms kept
    pd4 = [((dirs[:, 0] * mr[:, i, 0] + zero * mr[:, i, 1])
            + dirs[:, 1] * mr[:, i, 2]) + zero * mr[:, i, 3] for i in range(4)]
    # the plane keeps (x or y, z, w): x where the segment maps X to pixels
    first = axis_y == 0

    def plane(v4):
        return torch.stack([torch.where(first, v4[0], v4[1]), v4[2], v4[3]],
                           dim=1)

    static = RayStatic(dirs=dirs, plane_bottom=plane(pb4.unbind(1)),
                       plane_top=plane(pt4.unbind(1)), plane_dir=plane(pd4),
                       orig_min=orig_min, orig_max=orig_max)
    dda = DDAState(pos=pos, tmax=tmax, tdelta=tdelta, stp=stp, ids=ids,
                   lod=lod)
    return static, dda, alive, cam_y[cam], cam_y_norm[cam]


def _enter_world(start, dirs, state, alive, lod_distances, far_clip,
                 n_lods: int, dims_f):
    """TraceToFirstColumnJob's outside branch (:95-143) for every ray, each
    with its camera's ``start``, (R, 10) ``lod_distances`` and (R,)
    ``far_clip``: (alive, (pos, tmax, tdelta, stp, ids, lod))."""
    pos, tmax, tdelta, stp, ids, lod = state
    hit, n_pos, n_tmax, n_ids = _step_to_world_intersection(
        start, dirs, tdelta, dims_f)
    # the host init only touches the `outside & alive` lanes: mask the same
    # way, so dead and padded lanes keep their ctor values
    upd = alive[:, None]
    alive = alive & hit
    pos = torch.where(upd, n_pos, pos)
    tmax = torch.where(upd, n_tmax, tmax)
    ids = torch.where(upd, n_ids, ids)
    for _ in range(n_lods):  # LOD fast-forward (:123-128)
        lodd = lod_distances.gather(1, lod.clamp(0, 9).long()[:, None])[:, 0]
        adv = alive & (ids[:, 0] >= lodd)
        vsize = 1 << lod
        rem = pos & (2 * vsize - 1)[:, None]
        tmax_prev = tmax - tdelta
        low = rem < vsize[:, None]
        inc = (dirs >= 0) == low
        tmax_n = torch.where(inc, tmax + tdelta, tmax)
        tmax_prev = torch.where(~inc, tmax_prev - tdelta, tmax_prev)
        ids_n = torch.stack([_max(tmax_prev[:, 0], tmax_prev[:, 1]),
                             _min(tmax_n[:, 0], tmax_n[:, 1])], dim=1)
        a2 = adv[:, None]
        pos = torch.where(a2, pos - rem, pos)
        tmax = torch.where(a2, tmax_n, tmax)
        tdelta = torch.where(a2, tdelta * 2.0, tdelta)
        stp = torch.where(a2, stp * 2, stp)
        ids = torch.where(a2, ids_n, ids)
        lod = torch.where(adv, lod + 1, lod)
    beyond = _min(tmax[:, 0], tmax[:, 1]) >= far_clip  # IsBeyondFarClip
    return alive & ~beyond, (pos, tmax, tdelta, stp, ids, lod)


def _step_to_world_intersection(start, dirs, tdelta, dims_f):
    """SegmentDDAData.StepToWorldIntersection (:75-130), batched
    (``device_init.py:221``), each ray from its (R, 2) ``start``:
    (hit, pos, tmax, ids)."""
    inf = float("inf")
    tmin, tmax_ = [], []
    for ax in range(2):
        nz = dirs[:, ax] != 0.0
        t1 = -start[:, ax] / dirs[:, ax]
        t2 = (dims_f[ax] - start[:, ax]) / dirs[:, ax]
        tmin.append(torch.where(nz, _min(t1, t2), -inf))
        tmax_.append(torch.where(nz, _max(t1, t2), inf))
    tmint = _max(tmin[0], tmin[1])
    tmaxt = _min(tmax_[0], tmax_[1])
    hit = ~((tmaxt < tmint) | (tmint <= 0.0))

    use_x = (tmin[0] < tmin[1]) & (tmin[0] != -inf)
    t_last = [torch.zeros_like(tmint), torch.zeros_like(tmint)]
    for ax, other in ((0, 1), (1, 0)):
        mask = use_x if ax == 0 else ~use_x
        off = tmint * dirs[:, ax]
        hitpos = start[:, ax] + off
        hitpos = torch.where(dirs[:, ax] > 0, torch.floor(hitpos),
                             torch.ceil(hitpos))
        tl = (hitpos - start[:, ax]) / dirs[:, ax]
        t_last[ax] = torch.where(mask, tl, t_last[ax])
        t_last[other] = torch.where(mask, tmin[other], t_last[other])
    t_last = torch.stack(t_last, dim=1)
    new_tmax = t_last + tdelta
    ids = torch.stack([_max(t_last[:, 0], t_last[:, 1]),
                       _min(new_tmax[:, 0], new_tmax[:, 1])], dim=1)
    mid = ids[:, 0] + (ids[:, 1] - ids[:, 0]) * 0.5
    pos = _to_i32_host(torch.floor(start + mid[:, None] * dirs))
    return hit, pos, new_tmax, ids
