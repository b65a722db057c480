"""The plain reference of one frame, worked out from the world and the camera
alone: the camera snapshot and segments, the raybuffer rows of chosen rays
(the scalar oracle, ``oracle.py``) and the reprojection of every screen pixel
to its raybuffer row and texel.

Plain numpy; it imports nothing of the program.  ``dtype`` float16 computes
the rays' march and the reprojection in the precision below the float32
that the reference states: that is the control (``voxbench/control.py``),
which has to come out as not correct.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import sys

import numpy as np

from . import camera as cm
from . import segments as sg
from .colors import SKYBOX

F32 = np.float32


@dataclasses.dataclass
class Geometry:
    """A frame's host-side geometry, as the reference computes it."""

    cam: cm.Camera
    cam_data: cm.CameraData
    segs: list
    ctxs: list
    vp_screen: np.ndarray
    render_wh: tuple[int, int]

    @property
    def n_topdown(self) -> int:
        return self.segs[0].ray_count + self.segs[1].ray_count

    def rays(self) -> list[tuple[int, int, int]]:
        """Every ray of the frame as (segment, ray in segment, row of the
        raybuffer: top-down rays first, then left-right rays)."""
        out = []
        for si, (seg, ctx) in enumerate(zip(self.segs, self.ctxs)):
            base = (0 if si < 2 else self.n_topdown) + ctx.ray_index_offset
            out += [(si, i, base + i) for i in range(max(seg.ray_count, 0))]
        return out


def render_wh(width: int, height: int, render_scale: float) -> tuple[int, int]:
    """Phases 1 and 2 run at the scaled size (UnityManager.cs:35-36)."""
    return (max(2, int(round(width * render_scale))),
            max(2, int(round(height * render_scale))))


def _camera(pose: dict, render: dict, wh) -> cm.Camera:
    cam = cm.Camera(**pose, fov_y_deg=render["fov_y_deg"],
                    near=render["near_clip"], screen=tuple(wh))
    return cm.limit_rotation_horizon(cam)


def lod_distances(first_pose: dict, render: dict, wh, max_dim: int):
    """The LOD distances and far clip, fixed once from the first camera a
    viewer shows (UnityManager.cs:417-458 SetupLods)."""
    return cm.setup_lods(_camera(first_pose, render, wh), max_dim,
                         render["lod_levels"], render["lod_error"])


def geometry(pose: dict, render: dict, wh, lods_and_far) -> Geometry:
    cam = _camera(pose, render, wh)
    cam_data = cm.make_camera_data(cam, *lods_and_far)
    vp = cm.vanishing_point_screen(cam, cm.vanishing_point_world(cam))
    segs = sg.build_segments(cam, vp)
    ctxs = sg.build_segment_contexts(cam, segs, vp)
    return Geometry(cam, cam_data, segs, ctxs, vp, tuple(wh))


def oracle_module(dtype=F32):
    """The oracle with its scalars in ``dtype``: the module itself for
    float32, a second instance of it with ``F`` replaced otherwise."""
    from . import oracle

    if dtype == F32:
        return oracle
    name = f"{oracle.__name__}_{np.dtype(dtype).name}"
    mod = sys.modules.get(name)
    if mod is None:
        spec = importlib.util.spec_from_file_location(name, oracle.__file__)
        mod = importlib.util.module_from_spec(spec)
        mod.__package__ = oracle.__package__
        spec.loader.exec_module(mod)
        mod.F = dtype
        mod.INF = dtype(np.inf)
        sys.modules[name] = mod
    return mod


def ray_row(lods, g: Geometry, si: int, i: int, dtype=F32) -> np.ndarray:
    """One ray's raybuffer row in ARGB: the render height of texels for a
    top-down ray (segments 0 and 1), the render width for a left-right ray;
    texels the ray may not write keep the unwritten magenta."""
    from .colors import DEBUG_MAGENTA

    orc = oracle_module(dtype)
    w, h = g.render_wh
    row = np.full(h if si < 2 else w, DEBUG_MAGENTA, np.uint32)
    seg, ctx = g.segs[si], g.ctxs[si]
    direction = sg.ray_directions(seg)[i]
    dims_xz = (lods[0].dims[0], lods[0].dims[2])
    it = -1 if g.cam_data.inverse_element_iteration_direction else 1
    with np.errstate(all="ignore"):
        ray = orc.SegmentDDA(g.cam_data.position_xz, direction)
        alive, lod = orc.trace_to_first_column(ray, g.cam_data, dims_xz)
        if not alive:
            row[ctx.next_free_pixel_min: ctx.next_free_pixel_max + 1] = SKYBOX
        else:
            orc.execute_ray(ray, lod, lods, g.cam_data, ctx, row, it)
    return row


def pixel_texels(g: Geometry, dtype=F32):
    """Every render pixel's raybuffer (row, texel), each (h, w) int64, row -1
    where no segment takes the pixel: the scalar reprojection of
    ``oracle.reproject_oracle`` (a pixel centre belongs to the first segment
    triangle that holds it, else to the one with the largest least
    barycentric weight; ray = floor(RayCount * bMax / (bMax + bMin)); texel =
    screen y for segments 0 and 1, x for 2 and 3), elementwise over the
    screen in the same operations and order."""
    F = dtype
    w, h = g.render_wh
    px = (np.arange(w) + 0.5).astype(F)[None, :]
    py = (np.arange(h) + 0.5).astype(F)[:, None]
    vp = np.asarray(g.vp_screen, F)
    shape = (h, w)
    found = np.zeros(shape, bool)  # a segment with score >= 0 was taken
    best_seg = np.full(shape, -1, np.int64)
    best_score = np.full(shape, -np.inf, F)
    b_max = np.zeros(shape, F)
    b_min = np.zeros(shape, F)
    with np.errstate(all="ignore"):
        for si, seg in enumerate(g.segs):
            if seg.ray_count <= 0:
                continue
            a = vp
            b = np.asarray(seg.max_screen, F)
            c = np.asarray(seg.min_screen, F)
            v0 = b - a
            v1 = c - a
            den = v0[0] * v1[1] - v1[0] * v0[1]
            if den == 0:
                continue
            v2x = px - a[0]
            v2y = py - a[1]
            bb = (v2x * v1[1] - v1[0] * v2y) / den
            cc = (v0[0] * v2y - v2x * v0[1]) / den
            bvp = F(1.0) - bb - cc
            score = np.minimum(np.minimum(bvp, bb), cc)
            take = ~found & ((score >= 0) | (score > best_score))
            best_seg = np.where(take, si, best_seg)
            best_score = np.where(take, score, best_score)
            b_max = np.where(take, bb, b_max)
            b_min = np.where(take, cc, b_min)
            found |= take & (score >= 0)
        denom = b_max + b_min
        x = np.where(denom != 0, b_max / denom, F(0.0)).astype(F)
    row = np.full(shape, -1, np.int64)
    texel = np.zeros(shape, np.int64)
    xs = np.broadcast_to(np.arange(w)[None, :], shape)
    ys = np.broadcast_to(np.arange(h)[:, None], shape)
    for si, (seg, ctx) in enumerate(zip(g.segs, g.ctxs)):
        sel = best_seg == si
        if seg.ray_count <= 0 or not sel.any():
            continue
        with np.errstate(all="ignore"):
            fl = np.floor(x[sel] * F(seg.ray_count))
        ri = np.where(np.isfinite(fl), fl, 0).astype(np.int64)
        ri = np.minimum(np.maximum(ri, 0), seg.ray_count - 1)
        base = (0 if si < 2 else g.n_topdown) + ctx.ray_index_offset
        row[sel] = ri + base
        texel[sel] = (ys if si < 2 else xs)[sel]
    return row, texel
