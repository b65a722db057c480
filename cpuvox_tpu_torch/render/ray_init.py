"""Host-side per-frame ray init (numpy float32), handed to torch.

A copy of ``init_rays``, ``_np_next_lod`` and ``_step_to_world_intersection``
from ``cpuvox_tpu/render/raymarch.py:252-413``: those helpers are numpy, but
they live in a module that imports jax, so the port carries its own copy.
The float operation order is unchanged, so both packages start every frame
from the same bits.  Vectorizes DDASetupJob + TraceToFirstColumnJob +
SetupProjectedPlaneParams (DrawSegmentRayJob.cs:49-143,622-651).
"""
from __future__ import annotations

import numpy as np
import torch

from . import camera as cm
from . import segments as sg
from .raymarch import DDAState, RayStatic

F = np.float32


def init_rays_np(cam_data: cm.CameraData, segs: list[sg.SegmentData],
                 ctxs: list[sg.SegmentContext], dims: tuple[int, int, int],
                 pad_to: int = 128, fixed_size: int | None = None):
    """Per-ray static data + initial DDA state as numpy arrays.

    Returns (static fields dict, dda fields dict, alive0 (R,), meta dict).
    Ray order: segment 0 rays, then 1, 2, 3 (the raybuffer row layout with
    the topdown buffer first)."""
    X, Z = dims[0], dims[2]
    world_max_y = F(dims[1])
    m = cam_data.world_to_screen
    start = cam_data.position_xz.astype(F)

    dirs_l, axis_l, omin_l, omax_l = [], [], [], []
    for seg, ctx in zip(segs, ctxs):
        if seg.ray_count <= 0:
            continue
        d = sg.ray_directions(seg)
        dirs_l.append(d)
        axis_l.append(np.full(d.shape[0], ctx.axis_mapped_to_y, np.int32))
        omin_l.append(np.full(d.shape[0], ctx.next_free_pixel_min, np.int32))
        omax_l.append(np.full(d.shape[0], ctx.next_free_pixel_max, np.int32))
    n_rays = sum(x.shape[0] for x in dirs_l) if dirs_l else 0
    R = max(pad_to, int(np.ceil(max(n_rays, 1) / pad_to)) * pad_to)
    if fixed_size is not None:
        if n_rays > fixed_size:
            raise ValueError(f"{n_rays} rays exceed fixed_size={fixed_size}")
        R = fixed_size

    dirs = np.zeros((R, 2), F)
    axis_y = np.zeros(R, np.int32)
    orig_min = np.zeros(R, np.int32)
    orig_max = np.full(R, -1, np.int32)  # padded rays: empty pixel range
    if n_rays:
        dirs[:n_rays] = np.concatenate(dirs_l)
        axis_y[:n_rays] = np.concatenate(axis_l)
        orig_min[:n_rays] = np.concatenate(omin_l)
        orig_max[:n_rays] = np.concatenate(omax_l)
    dirs[n_rays:] = np.array([1.0, 0.0], F)  # no 0-direction padding rays

    # --- SegmentDDAData ctor (SegmentDDAData.cs:17-28)
    pos = np.floor(start)[None, :].astype(np.int32).repeat(R, 0)
    with np.errstate(divide="ignore"):
        tdelta = F(1.0) / np.maximum(F(1e-7), np.abs(dirs))
    sign_dir = np.sign(dirs).astype(F)
    stp = sign_dir.astype(np.int32)
    frac = start - np.floor(start)
    tmax = (sign_dir * -frac[None, :] + sign_dir * F(0.5) + F(0.5)) * tdelta
    ids = np.stack([(tmax - tdelta).max(1), tmax.min(1)], axis=1)

    alive = np.zeros(R, bool)
    alive[:n_rays] = True
    lod = np.zeros(R, np.int32)

    # --- TraceToFirstColumnJob (DrawSegmentRayJob.cs:95-143)
    outside = (pos[:, 0] < 0) | (pos[:, 0] >= X) | (pos[:, 1] < 0) | (pos[:, 1] >= Z)
    if np.any(outside & alive):
        sel = np.nonzero(outside & alive)[0]
        hit, n_pos, n_tmax, n_ids = _step_to_world_intersection(
            start, dirs[sel], tdelta[sel], np.array([X, Z], F))
        alive[sel] = hit
        pos[sel] = n_pos
        tmax[sel] = n_tmax
        ids[sel] = n_ids
        # LOD fast-forward (:123-128)
        lod_dist = np.append(cam_data.lod_distances.astype(F), [F(np.inf)] * 2)
        for _ in range(len(lod_dist) - 2):
            adv = alive & outside & (ids[:, 0] >= lod_dist[lod])
            if not np.any(adv):
                break
            a = np.nonzero(adv)[0]
            vsize = (1 << lod[a]).astype(np.int32)
            pos[a], tmax[a], tdelta[a], stp[a], ids[a] = _np_next_lod(
                pos[a], tmax[a], tdelta[a], stp[a], dirs[a], vsize)
            lod[a] += 1
        # IsBeyondFarClip (:130)
        beyond = alive & outside & (tmax.min(1) >= F(cam_data.far_clip))
        alive &= ~beyond

    # --- SetupProjectedPlaneParams (:622-651); start is the camera for all rays.
    # Sequential products and sums (camera.mat4_vec), never BLAS `@`.
    pb4 = cm.mat4_vec(m, (start[0], F(0.0), start[1], F(1.0)))
    pt4 = cm.mat4_vec(m, (start[0], world_max_y, start[1], F(1.0)))
    zero = np.zeros(R, F)
    pd4 = np.stack([
        ((dirs[:, 0] * m[i, 0] + zero * m[i, 1]) + dirs[:, 1] * m[i, 2])
        + zero * m[i, 3]
        for i in range(4)], axis=1)
    sel_xzw = np.array([0, 2, 3])
    sel_yzw = np.array([1, 2, 3])
    take = np.where(axis_y[:, None] == 0, sel_xzw[None, :], sel_yzw[None, :])
    static = dict(dirs=dirs, plane_bottom=pb4[take], plane_top=pt4[take],
                  plane_dir=np.take_along_axis(pd4, take, axis=1),
                  orig_min=orig_min, orig_max=orig_max)
    dda = dict(pos=pos, tmax=tmax, tdelta=tdelta, stp=stp, ids=ids, lod=lod)
    return static, dda, alive, {"n_rays": n_rays, "R": R}


def init_rays(cam_data: cm.CameraData, segs: list[sg.SegmentData],
              ctxs: list[sg.SegmentContext], dims: tuple[int, int, int], *,
              device, pad_to: int = 128, fixed_size: int | None = None,
              staging: RayStaging | None = None):
    """``init_rays_np`` as tensors on ``device``:
    (RayStatic, DDAState, alive0 (R,) bool, meta).  With ``staging`` (of
    the frame's R on ``device``) the rays go through its pinned buffers in
    one copy that does not wait for the card."""
    static, dda, alive, meta = init_rays_np(cam_data, segs, ctxs, dims,
                                            pad_to, fixed_size)
    if staging is not None:
        return (*staging.put(static, dda, alive), meta)

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return (RayStatic(**{k: put(v) for k, v in static.items()}),
            DDAState(**{k: put(v) for k, v in dda.items()}),
            put(alive), meta)


# the rays' fields, in RayStatic's and DDAState's order, then alive0: name,
# columns a ray (0 for an (R,) field), dtype
RAY_FIELDS = (
    ("dirs", 2, np.float32), ("plane_bottom", 3, np.float32),
    ("plane_top", 3, np.float32), ("plane_dir", 3, np.float32),
    ("orig_min", 0, np.int32), ("orig_max", 0, np.int32),
    ("pos", 2, np.int32), ("tmax", 2, np.float32), ("tdelta", 2, np.float32),
    ("stp", 2, np.int32), ("ids", 2, np.float32), ("lod", 0, np.int32),
    ("alive", 0, np.bool_))
_TORCH = {np.float32: torch.float32, np.int32: torch.int32,
          np.bool_: torch.bool}


class RayStaging:
    """Host-built rays to the device without a wait: two sets of pinned
    host memory (plain memory on a CPU device), each holding every field of
    ``R`` rays at 16-byte aligned offsets.  ``put`` writes a frame's fields
    into the next set, copies the whole set in one ``non_blocking`` copy to
    a new device buffer of the frame's own, and returns its views.  Before
    a set is written again, the host waits on the CUDA event of the copy
    that last read it (two frames back: with a frame in flight, the one
    before has been read)."""

    def __init__(self, R: int, device):
        self.R = R
        self.device = torch.device(device)
        self.offsets, at = [], 0
        for _name, cols, dtype in RAY_FIELDS:
            self.offsets.append(at)
            n = R * max(cols, 1) * np.dtype(dtype).itemsize
            at += -(-n // 16) * 16
        self.nbytes = at
        pin = self.device.type == "cuda"
        self.host = [torch.empty(at, dtype=torch.uint8, pin_memory=pin)
                     for _ in range(2)]
        self.events = [None, None]
        self.next = 0

    def _views(self, buf):
        out = []
        for (_name, cols, dtype), at in zip(RAY_FIELDS, self.offsets):
            n = self.R * max(cols, 1) * np.dtype(dtype).itemsize
            v = buf[at:at + n].view(_TORCH[dtype])
            out.append(v.view(self.R, cols) if cols else v)
        return out

    def put(self, static: dict, dda: dict, alive):
        """(RayStatic, DDAState, alive0) on the device from ``init_rays_np``'s
        numpy fields."""
        k = self.next
        self.next ^= 1
        if self.events[k] is not None:
            self.events[k].synchronize()
        values = {**static, **dda, "alive": alive}
        for (name, _cols, dtype), v in zip(RAY_FIELDS, self._views(self.host[k])):
            x = values[name]
            if x.dtype != dtype or x.shape != tuple(v.shape):
                raise ValueError(f"ray field {name}: {x.dtype} {x.shape}, "
                                 f"expected {np.dtype(dtype)} {tuple(v.shape)}")
            v.numpy()[...] = x
        dev = torch.empty(self.nbytes, dtype=torch.uint8, device=self.device)
        dev.copy_(self.host[k], non_blocking=True)
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self.events[k] = ev
        f = self._views(dev)
        return RayStatic(*f[:6]), DDAState(*f[6:12]), f[12]


def _np_next_lod(pos, tmax, tdelta, stp, dirs, vsize):
    """Vectorized SegmentDDAData.NextLOD (numpy, used at init)."""
    rem = pos & (2 * vsize - 1)[:, None]
    tmax_prev = tmax - tdelta
    low = rem < vsize[:, None]
    inc = (dirs >= 0) == low
    tmax = np.where(inc, tmax + tdelta, tmax)
    tmax_prev = np.where(~inc, tmax_prev - tdelta, tmax_prev)
    ids = np.stack([tmax_prev.max(1), tmax.min(1)], axis=1)
    return pos - rem, tmax, tdelta * F(2.0), stp * 2, ids


def _step_to_world_intersection(start, dirs, tdelta, dims_f):
    """Vectorized SegmentDDAData.StepToWorldIntersection (:75-130)."""
    n = dirs.shape[0]
    with np.errstate(divide="ignore", invalid="ignore"):
        tmin = np.full((n, 2), -np.inf, F)
        tmax_ = np.full((n, 2), np.inf, F)
        for ax in range(2):
            nz = dirs[:, ax] != 0.0
            t1 = -start[ax] / dirs[:, ax]
            t2 = (dims_f[ax] - start[ax]) / dirs[:, ax]
            tmin[nz, ax] = np.minimum(t1, t2)[nz]
            tmax_[nz, ax] = np.maximum(t1, t2)[nz]
        tmint = tmin.max(1)
        tmaxt = tmax_.min(1)
        hit = ~((tmaxt < tmint) | (tmint <= 0.0))

        t_last = np.zeros((n, 2), F)
        use_x = (tmin[:, 0] < tmin[:, 1]) & (tmin[:, 0] != -np.inf)
        # the axis with the later entry keeps its plain tmin; the other snaps
        # to the last grid boundary before the entry point
        for ax, other in ((0, 1), (1, 0)):
            m = use_x if ax == 0 else ~use_x
            off = tmint * dirs[:, ax]
            hitpos = start[ax] + off
            hitpos = np.where(dirs[:, ax] > 0, np.floor(hitpos), np.ceil(hitpos))
            t_last[m, ax] = ((hitpos - start[ax]) / dirs[:, ax])[m]
            t_last[m, other] = tmin[m, other]
        new_tmax = t_last + tdelta
        ids = np.stack([t_last.max(1), new_tmax.min(1)], axis=1)
        mid = ids[:, 0] + (ids[:, 1] - ids[:, 0]) * F(0.5)
        pos = np.floor(start[None, :] + mid[:, None] * dirs).astype(np.int32)
    return hit, pos, new_tmax, ids
