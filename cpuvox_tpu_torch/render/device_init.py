"""Per-frame ray init on the device (plain PyTorch).

Counterpart of ``cpuvox_tpu/render/device_init.py``: the per-ray setup that
``ray_init.init_rays_np`` builds with numpy on the host (DDASetupJob +
TraceToFirstColumnJob + SetupProjectedPlaneParams,
DrawSegmentRayJob.cs:49-143,622-651), as tensor ops on a tiny per-segment
parameter table.  A frame then sends the device one copy of 66 words in
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
``if``: every ray starts in the camera's cell, which the host knows.
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
    """Tiny per-frame arrays built on the host (see ``build_frame_params``)."""

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


def frame_params_to(p: FrameParams, device) -> FrameParams:
    """``p`` as tensors on ``device``, sent as one buffer (f32 fields as
    their bits) and viewed apart there."""
    parts = [np.ascontiguousarray(x).reshape(-1) for x in p]
    words = np.concatenate([x.view(np.int32) if x.dtype == F else
                            x.astype(np.int32) for x in parts])
    buf = torch.from_numpy(words).to(device)
    out, at = [], 0
    for x in p:
        x = np.asarray(x)
        t = buf[at:at + x.size]
        at += x.size
        if x.dtype == F:
            t = t.view(torch.float32)
        out.append(t.reshape(x.shape))
    return FrameParams(*out)


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
    """``camera.mat4_vec`` on tensors: (4, 4) @ (4,) accumulated left to
    right, every product and sum rounded on its own."""
    acc = m[:, 0] * v4[0]
    acc = acc + m[:, 1] * v4[1]
    acc = acc + m[:, 2] * v4[2]
    return acc + m[:, 3] * v4[3]


def init_rays_device(p: FrameParams, dims, R: int, device):
    """(RayStatic, DDAState, alive0) for R padded rays, on ``device``
    (``device_init.py:106``).  ``p`` holds numpy arrays
    (``build_frame_params``)."""
    X, Z = dims[0], dims[2]
    n_lods = int(np.isfinite(p.lod_distances).sum())
    cell = np.floor(np.asarray(p.cam_pos)[[0, 2]])
    any_outside = bool(cell[0] < 0 or cell[0] >= X or cell[1] < 0
                       or cell[1] >= Z)
    p = frame_params_to(p, device)
    f32 = dict(dtype=torch.float32, device=device)
    one = torch.ones((), **f32)
    zero = torch.zeros(R, **f32)
    world_max_y = torch.full((), float(dims[1]), **f32)
    ray_ids = torch.arange(R, dtype=torch.int32, device=device)

    # segment membership: seg_ray_start is cumulative
    ends = p.seg_ray_start + p.seg_ray_count  # (4,)
    seg_id = (ray_ids[:, None] >= ends[None, :]).sum(1).clamp(0, 3)
    in_use = ray_ids < ends[3]

    plane_index = ray_ids - p.seg_ray_start[seg_id]
    rc = p.seg_ray_count[seg_id].clamp(min=1)
    # DDASetupJob (DrawSegmentRayJob.cs:58-69): lerp + normalize
    t = plane_index.float() / rc.float()
    lo = p.seg_plane_min[seg_id]
    hi = p.seg_plane_max[seg_id]
    d = lo + (hi - lo) * t[:, None]
    norm = _sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])[:, None]
    unit_x = (torch.arange(2, device=device) == 0).float()[None, :]
    dirs = torch.where(in_use[:, None], d / norm, unit_x)

    axis_y = p.seg_axis_y[seg_id]
    orig_min = torch.where(in_use, p.seg_orig_min[seg_id], 0)
    orig_max = torch.where(in_use, p.seg_orig_max[seg_id], -1)

    # --- SegmentDDAData ctor (SegmentDDAData.cs:17-28)
    start = torch.stack([p.cam_pos[0], p.cam_pos[2]])
    pos = torch.floor(start).to(torch.int32)[None, :].expand(R, 2)
    tdelta = one / torch.clamp(torch.abs(dirs), min=1e-7)
    sign_dir = torch.sign(dirs)
    stp = sign_dir.to(torch.int32)
    frac = start - torch.floor(start)
    tmax = (sign_dir * -frac[None, :] + sign_dir * 0.5 + 0.5) * tdelta
    tprev = tmax - tdelta
    ids = torch.stack([_max(tprev[:, 0], tprev[:, 1]),
                       _min(tmax[:, 0], tmax[:, 1])], dim=1)
    alive = in_use
    lod = torch.zeros(R, dtype=torch.int32, device=device)

    # --- TraceToFirstColumnJob (:95-143): every ray starts in the camera's
    # cell, so all of them are inside the world or all outside
    if any_outside:
        hit, n_pos, n_tmax, n_ids = _step_to_world_intersection(
            start, dirs, tdelta, (float(X), float(Z)))
        # the host init only touches the `outside & alive` lanes: mask the
        # same way, so dead and padded lanes keep their ctor values
        upd = alive[:, None]
        alive = alive & hit
        pos = torch.where(upd, n_pos, pos)
        tmax = torch.where(upd, n_tmax, tmax)
        ids = torch.where(upd, n_ids, ids)
        for _ in range(n_lods):  # LOD fast-forward (:123-128)
            adv = alive & (ids[:, 0]
                           >= p.lod_distances[lod.clamp(0, 9).long()])
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
        beyond = _min(tmax[:, 0], tmax[:, 1]) >= p.far_clip  # IsBeyondFarClip
        alive = alive & ~beyond

    # --- SetupProjectedPlaneParams (:622-651)
    m = p.world_to_screen
    pb4 = _mat4_vec(m, (start[0], zero[0], start[1], one))
    pt4 = _mat4_vec(m, (start[0], world_max_y, start[1], one))
    # pd4[:, i] = sum_j dir4[j] * m[i, j], left to right like the host's;
    # dir4 = (dirs.x, 0, dirs.z, 0), the zero terms kept
    pd4 = [((dirs[:, 0] * m[i, 0] + zero * m[i, 1]) + dirs[:, 1] * m[i, 2])
           + zero * m[i, 3] for i in range(4)]
    # the plane keeps (x or y, z, w): x where the segment maps X to pixels
    first = axis_y == 0

    def plane(v4):
        return torch.stack([torch.where(first, v4[0], v4[1]),
                            v4[2].expand(R), v4[3].expand(R)], dim=1)

    static = RayStatic(dirs=dirs, plane_bottom=plane(pb4), plane_top=plane(pt4),
                       plane_dir=plane(pd4), orig_min=orig_min,
                       orig_max=orig_max)
    dda = DDAState(pos=pos.contiguous(), tmax=tmax, tdelta=tdelta, stp=stp,
                   ids=ids, lod=lod)
    return static, dda, alive


def _step_to_world_intersection(start, dirs, tdelta, dims_f):
    """SegmentDDAData.StepToWorldIntersection (:75-130), batched
    (``device_init.py:221``): (hit, pos, tmax, ids)."""
    inf = float("inf")
    tmin, tmax_ = [], []
    for ax in range(2):
        nz = dirs[:, ax] != 0.0
        t1 = -start[ax] / dirs[:, ax]
        t2 = (dims_f[ax] - start[ax]) / dirs[:, ax]
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
        hitpos = start[ax] + off
        hitpos = torch.where(dirs[:, ax] > 0, torch.floor(hitpos),
                             torch.ceil(hitpos))
        tl = (hitpos - start[ax]) / dirs[:, ax]
        t_last[ax] = torch.where(mask, tl, t_last[ax])
        t_last[other] = torch.where(mask, tmin[other], t_last[other])
    t_last = torch.stack(t_last, dim=1)
    new_tmax = t_last + tdelta
    ids = torch.stack([_max(t_last[:, 0], t_last[:, 1]),
                       _min(new_tmax[:, 0], new_tmax[:, 1])], dim=1)
    mid = ids[:, 0] + (ids[:, 1] - ids[:, 0]) * 0.5
    pos = _to_i32_host(torch.floor(start[None, :] + mid[:, None] * dirs))
    return hit, pos, new_tmax, ids
