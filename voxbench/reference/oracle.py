"""Scalar reference renderer — the correctness oracle.

A direct, per-ray transliteration of the reference's Burst hot path into numpy float32
scalars (SURVEY.md §7 step 1).  Every vectorized / Pallas implementation is diffed
against this on small scenes.  Sources (file:line into the reference C# project):

- SegmentDDAData            Assets/Code/Utils/SegmentDDAData.cs:17-155
- near-plane / frustum clip Assets/Code/Utils/CameraData.cs:51-163
- TraceToFirstColumnJob     Assets/Code/Rendering/DrawSegmentRayJob.cs:95-143
- ExecuteRay                Assets/Code/Rendering/DrawSegmentRayJob.cs:195-620
- ReducePixelHorizon        Assets/Code/Rendering/DrawSegmentRayJob.cs:660-697
- WriteSkybox               Assets/Code/Rendering/DrawSegmentRayJob.cs:699-716

Deliberate deviation: the `float.Epsilon` sentinel on frustumDirMaxWorld
(DrawSegmentRayJob.cs:220-221,261,522) is a separate boolean here — denormals flush to
zero on TPU, so a denormal sentinel can't survive on device; the oracle defines the
portable semantics.

This is deliberately slow (python loops) — use tiny worlds/screens.

The benchmark's frozen copy of ``cpuvox_tpu_torch/render/oracle.py`` (plain
numpy), kept under the benchmark so that a change to the program cannot
move the yardstick; ``voxbench/tests/test_voxbench_copies.py`` holds it
equal to the program's at a small size.
"""
from __future__ import annotations

import numpy as np

from voxbench.reference.colors import DEBUG_MAGENTA, SKYBOX
from voxbench.worldgen import rle
from voxbench.worldgen.rle import WorldLOD

from . import segments as sg
from .camera import Camera, CameraData, mat4_vec

F = np.float32
INF = F(np.inf)


def f2(x, y):
    return np.array([x, y], dtype=F)


def f3(x, y, z):
    return np.array([x, y, z], dtype=F)


def lerp(a, b, t):
    return a + (b - a) * F(t)


def unlerp(a, b, v):
    with np.errstate(invalid="ignore", divide="ignore"):
        return (F(v) - a) / (b - a)


class SegmentDDA:
    """SegmentDDAData (SegmentDDAData.cs:4-156)."""

    def __init__(self, start, direction):
        self.start = np.asarray(start, F).copy()
        self.dir = np.asarray(direction, F).copy()
        self.position = np.floor(self.start).astype(np.int32)
        with np.errstate(divide="ignore"):
            self.t_delta = F(1.0) / np.maximum(F(1e-7), np.abs(self.dir))
        sign_dir = np.sign(self.dir).astype(F)
        self.step = sign_dir.astype(np.int32)
        self.t_max = (sign_dir * -(self.start - np.floor(self.start))
                      + (sign_dir * F(0.5)) + F(0.5)) * self.t_delta
        self.intersection_distances = f2(np.max(self.t_max - self.t_delta),
                                         np.min(self.t_max))

    def next_lod(self, current_voxel_size: int):
        """SegmentDDAData.NextLOD (:31-73)."""
        remainders = self.position & np.int32(current_voxel_size * 2 - 1)
        t_max_previous = self.t_max - self.t_delta
        for axis in range(2):
            if self.dir[axis] >= 0.0:
                if remainders[axis] < current_voxel_size:
                    self.t_max[axis] += self.t_delta[axis]
                else:
                    t_max_previous[axis] -= self.t_delta[axis]
            else:
                if remainders[axis] < current_voxel_size:
                    t_max_previous[axis] -= self.t_delta[axis]
                else:
                    self.t_max[axis] += self.t_delta[axis]
        self.intersection_distances = f2(np.max(t_max_previous), np.min(self.t_max))
        self.position = self.position - remainders
        self.t_delta = self.t_delta * F(2.0)
        self.step = self.step * np.int32(2)

    def step_to_world_intersection(self, dimensions) -> bool:
        """SegmentDDAData.StepToWorldIntersection (:75-130)."""
        dims = np.asarray(dimensions, F)
        with np.errstate(divide="ignore", invalid="ignore"):
            tmin = f2(-INF, -INF)
            tmax = f2(INF, INF)
            if self.dir[0] != 0.0:
                tx1 = -self.start[0] / self.dir[0]
                tx2 = (dims[0] - self.start[0]) / self.dir[0]
                tmin[0] = min(tx1, tx2)
                tmax[0] = max(tx1, tx2)
            if self.dir[1] != 0.0:
                ty1 = -self.start[1] / self.dir[1]
                ty2 = (dims[1] - self.start[1]) / self.dir[1]
                tmin[1] = min(ty1, ty2)
                tmax[1] = max(ty1, ty2)
            tmint = np.max(tmin)
            tmaxt = np.min(tmax)
            if tmaxt < tmint or tmint <= 0.0:
                return False
            t_last = f2(0, 0)
            if tmin[0] < tmin[1] and tmin[0] != -INF:
                t_last[1] = tmin[1]
                offset = tmint * self.dir[0]
                hit = self.start[0] + offset
                hit = np.floor(hit) if self.dir[0] > 0.0 else np.ceil(hit)
                t_last[0] = (hit - self.start[0]) / self.dir[0]
            else:
                t_last[0] = tmin[0]
                offset = tmint * self.dir[1]
                hit = self.start[1] + offset
                hit = np.floor(hit) if self.dir[1] > 0.0 else np.ceil(hit)
                t_last[1] = (hit - self.start[1]) / self.dir[1]
            self.t_max = t_last + self.t_delta
            self.intersection_distances = f2(np.max(t_last), np.min(self.t_max))
            mid = lerp(self.intersection_distances[0],
                       self.intersection_distances[1], 0.5)
            self.position = np.floor(self.start + mid * self.dir).astype(np.int32)
        return True

    def step_cell(self, farclip) -> bool:
        """SegmentDDAData.Step (:135-150). True when the far clip is reached."""
        if self.t_max[0] < self.t_max[1]:
            crossed = self.t_max[0]
            self.t_max[0] += self.t_delta[0]
            self.position[0] += self.step[0]
        else:
            crossed = self.t_max[1]
            self.t_max[1] += self.t_delta[1]
            self.position[1] += self.step[1]
        self.intersection_distances = f2(crossed, np.min(self.t_max))
        return bool(crossed >= farclip)

    def is_beyond_far_clip(self, farclip) -> bool:
        return bool(np.min(self.t_max) >= farclip)


# ---------------------------------------------------------------- clipping helpers


def get_world_bounds_clipping_cam_space(p_min, p_max, frustum_min, frustum_max):
    """CameraData.GetWorldBoundsClippingCamSpace (CameraData.cs:51-121).

    Returns (fully_clipped, min_lerp, max_lerp).
    """

    def cross2(ax, ay, bx, by):
        return ax * by - ay * bx

    def clip_min(frustum):
        finv = F(1.0) / F(frustum)
        c0 = cross2(F(1.0), finv, p_max[0], p_max[2])
        c1 = cross2(F(1.0), finv, p_min[0], p_min[2])
        return F(1.0) - (c0 / (c0 - c1))

    def clip_max(frustum):
        finv = F(1.0) / F(frustum)
        c0 = cross2(F(1.0), finv, p_max[0], p_max[2])
        c1 = cross2(F(1.0), finv, p_min[0], p_min[2])
        return c1 / (c1 - c0)

    min_lerp = F(0.0)
    max_lerp = F(1.0)
    if p_min[0] > p_min[2] * frustum_max:
        if p_max[0] > p_max[2] * frustum_max:
            return True, F(0.0), F(1.0)
        min_lerp = clip_min(frustum_max)
        if p_max[0] < p_max[2] * frustum_min:
            max_lerp = clip_max(frustum_min)
    elif p_max[0] > p_max[2] * frustum_max:
        max_lerp = clip_max(frustum_max)
        if p_min[0] < p_min[2] * frustum_min:
            min_lerp = clip_min(frustum_min)
    else:
        if p_min[0] < p_min[2] * frustum_min:
            if p_max[0] < p_max[2] * frustum_min:
                return True, F(0.0), F(1.0)
            min_lerp = clip_min(frustum_min)
        elif p_max[0] < p_max[2] * frustum_min:
            max_lerp = clip_max(frustum_min)
    return False, min_lerp, max_lerp


def clip_homogeneous_camera_space_line(a, b, u_a=None, u_b=None):
    """CameraData.ClipHomogeneousCameraSpaceLine (CameraData.cs:124-157).

    Returns (visible, a, b[, u_a, u_b]); near-plane value is component .y == z+w.
    """
    a = a.copy()
    b = b.copy()
    if a[1] <= 0.0:
        if b[1] <= 0.0:
            return (False, a, b) if u_a is None else (False, a, b, u_a, u_b)
        v = b[1] / (b[1] - a[1])
        a = lerp(b, a, v)
        if u_a is not None:
            u_a = lerp(u_b, u_a, v)
    elif b[1] <= 0.0:
        v = a[1] / (a[1] - b[1])
        b = lerp(a, b, v)
        if u_a is not None:
            u_b = lerp(u_a, u_b, v)
    return (True, a, b) if u_a is None else (True, a, b, u_a, u_b)


def project_clipped_to_screen(a, b):
    """CameraData.ProjectClippedToScreen (:160-163)."""
    return f2(a[0] / a[2], b[0] / b[2])


# ---------------------------------------------------------------- the ray loop


class _RayTerminated(Exception):
    pass


def _reduce_pixel_horizon(orig_min, orig_max, rb_min, rb_max, nfp_min, nfp_max,
                          seen, frustum_bounds):
    """ReducePixelHorizon (DrawSegmentRayJob.cs:660-697).

    Returns (rb_min, rb_max, nfp_min, nfp_max); mutates seen-derived frustum_bounds
    list [min, max] in place.
    """
    if rb_min <= nfp_min:
        rb_min = nfp_min
        if rb_max >= nfp_min:
            nfp_min = rb_max + 1
            while nfp_min <= orig_max and seen[nfp_min] > 0:
                nfp_min += 1
            frustum_bounds[0] = F(nfp_min) - F(0.501)
    if rb_max >= nfp_max:
        rb_max = nfp_max
        if rb_min <= nfp_max:
            nfp_max = rb_min - 1
            while nfp_max >= orig_min and seen[nfp_max] > 0:
                nfp_max -= 1
            frustum_bounds[1] = F(nfp_max) + F(0.501)
    return rb_min, rb_max, nfp_min, nfp_max


def _write_skybox(orig_min, orig_max, ray_column, seen):
    for y in range(orig_min, orig_max + 1):
        if seen[y] == 0:
            ray_column[y] = SKYBOX


def setup_projected_plane_params(cam_data: CameraData, ray: SegmentDDA, world_max_y,
                                 y_axis: int):
    """SetupProjectedPlaneParams (DrawSegmentRayJob.cs:622-651)."""
    m = cam_data.world_to_screen
    start = ray.start
    bottom = np.array([start[0], 0.0, start[1], 1.0], F)
    top = np.array([start[0], world_max_y, start[1], 1.0], F)
    dirv = np.array([ray.dir[0], 0.0, ray.dir[1], 0.0], F)
    # explicit sequential order shared with raymarch/device_init (BLAS `@`
    # accumulation order is a platform detail; see camera.mat4_vec)
    pt = mat4_vec(m, top)
    pb = mat4_vec(m, bottom)
    pd = mat4_vec(m, dirv)
    sel = [0, 2, 3] if y_axis == 0 else [1, 2, 3]
    return pb[sel], pt[sel], pd[sel]


def execute_ray(
    ray: SegmentDDA,
    lod: int,
    lods: list[WorldLOD],
    cam_data: CameraData,
    ctx: sg.SegmentContext,
    ray_column: np.ndarray,
    iteration_direction: int,
):
    """ExecuteRay (DrawSegmentRayJob.cs:195-620) for one ray."""
    world = lods[lod]
    voxel_scale = np.int32(1 << lod)
    far_clip = F(cam_data.far_clip)
    lod_distances = cam_data.lod_distances
    lod_max = F(lod_distances[lod])

    seen = np.zeros(ctx.seen_pixel_cache_length, np.uint8)
    orig_min = ctx.next_free_pixel_min
    orig_max = ctx.next_free_pixel_max
    nfp_min = orig_min
    nfp_max = orig_max

    world_max_y = F(world.dims[1])
    cam_pos_y = F(cam_data.position_y)
    cam_pos_y_normalized = cam_pos_y / world_max_y

    frustum_bounds = [F(nfp_min) - F(0.501), F(nfp_max) + F(0.501)]
    frustum_active = False  # replaces the float.Epsilon sentinel (:220-221)
    frustum_dir_max_world = F(0.0)
    frustum_dir_min_world = F(0.0)

    plane_bottom, plane_top, plane_dir = setup_projected_plane_params(
        cam_data, ray, world_max_y, ctx.axis_mapped_to_y)

    dims_xz = np.array([lods[0].dims[0], lods[0].dims[2]], np.int32)

    def skybox_and_exit():
        _write_skybox(orig_min, orig_max, ray_column, seen)
        raise _RayTerminated()

    try:
        while True:
            # LOD switch (:237-243)
            if ray.intersection_distances[0] >= lod_max:
                ray.next_lod(int(voxel_scale))
                lod += 1
                voxel_scale = voxel_scale * np.int32(2)
                world = lods[lod]
                lod_max = F(lod_distances[lod])

            # column fetch (:245-256) — GetVoxelColumn with bounds mask (World.cs:130-142)
            pos = ray.position
            in_bounds = (0 <= pos[0] < dims_xz[0]) and (0 <= pos[1] < dims_xz[1])
            if not in_bounds:
                skybox_and_exit()
            runs, colors = rle.get_column(world, int(pos[0]), int(pos[1]))
            ci = world.column_index(int(pos[0]), int(pos[1]))
            if len(runs) == 0:
                if ray.step_cell(far_clip):
                    break
                continue
            col_world_min = F(world.col_min[ci])
            col_world_max = F(world.col_max[ci])

            world_bounds_min = F(0.0)
            world_bounds_max = world_max_y

            # frustum-vs-column cull when narrowing is active (:261-281)
            if frustum_active:
                dist_top = (ray.intersection_distances[1]
                            if frustum_dir_max_world > 0.0
                            else ray.intersection_distances[0])
                dist_bot = (ray.intersection_distances[1]
                            if frustum_dir_min_world < 0.0
                            else ray.intersection_distances[0])
                new_max = cam_pos_y + frustum_dir_max_world * dist_top
                new_min = cam_pos_y + frustum_dir_min_world * dist_bot
                if new_min > world_bounds_max or new_max < world_bounds_min:
                    skybox_and_exit()
                if col_world_min > new_max or col_world_max < new_min:
                    if ray.step_cell(far_clip):
                        break
                    continue
                world_bounds_min = new_min
                world_bounds_max = new_max

            # project the column's world-line at last/next intersection (:289-293)
            cs_min_last = plane_bottom + plane_dir * ray.intersection_distances[0]
            cs_min_next = plane_bottom + plane_dir * ray.intersection_distances[1]
            cs_max_last = plane_top + plane_dir * ray.intersection_distances[0]
            cs_max_next = plane_top + plane_dir * ray.intersection_distances[1]

            # re-clip the writable frustum when dirty (:295-422)
            if ray.intersection_distances[0] > 2.0 and not frustum_active:
                clipped_last, cl_min, cl_max = get_world_bounds_clipping_cam_space(
                    cs_min_last, cs_max_last, frustum_bounds[0], frustum_bounds[1])
                clipped_next, cn_min, cn_max = get_world_bounds_clipping_cam_space(
                    cs_min_next, cs_max_next, frustum_bounds[0], frustum_bounds[1])

                if clipped_last:
                    if clipped_next:
                        skybox_and_exit()
                    world_bounds_min = lerp(F(0.0), world_max_y, cn_min)
                    world_bounds_max = lerp(F(0.0), world_max_y, cn_max)
                    frustum_dir_max_world = ((world_bounds_max - cam_pos_y)
                                             / ray.intersection_distances[1])
                    frustum_dir_min_world = ((world_bounds_min - cam_pos_y)
                                             / ray.intersection_distances[1])
                    min_clip = lerp(cs_min_next, cs_max_next, cn_min)
                    max_clip = lerp(cs_min_next, cs_max_next, cn_max)
                    cs_clip_min = min_clip[0] / min_clip[2]
                    cs_clip_max = max_clip[0] / max_clip[2]
                    if cs_clip_max < cs_clip_min:
                        cs_clip_min, cs_clip_max = cs_clip_max, cs_clip_min
                elif clipped_next:
                    world_bounds_min = lerp(F(0.0), world_max_y, cl_min)
                    world_bounds_max = lerp(F(0.0), world_max_y, cl_max)
                    min_clip = lerp(cs_min_last, cs_max_last, cl_min)
                    max_clip = lerp(cs_min_last, cs_max_last, cl_max)
                    frustum_dir_max_world = ((world_bounds_max - cam_pos_y)
                                             / ray.intersection_distances[0])
                    frustum_dir_min_world = ((world_bounds_min - cam_pos_y)
                                             / ray.intersection_distances[0])
                    cs_clip_min = min_clip[0] / min_clip[2]
                    cs_clip_max = max_clip[0] / max_clip[2]
                    if cs_clip_max < cs_clip_min:
                        cs_clip_min, cs_clip_max = cs_clip_max, cs_clip_min
                else:
                    if cl_min < cn_min:
                        world_bounds_min = lerp(F(0.0), world_max_y, cl_min)
                        frustum_dir_min_world = ((world_bounds_min - cam_pos_y)
                                                 / ray.intersection_distances[0])
                    else:
                        world_bounds_min = lerp(F(0.0), world_max_y, cn_min)
                        frustum_dir_min_world = ((world_bounds_min - cam_pos_y)
                                                 / ray.intersection_distances[1])
                    if cl_max > cn_max:
                        world_bounds_max = lerp(F(0.0), world_max_y, cl_max)
                        frustum_dir_max_world = ((world_bounds_max - cam_pos_y)
                                                 / ray.intersection_distances[0])
                    else:
                        world_bounds_max = lerp(F(0.0), world_max_y, cn_max)
                        frustum_dir_max_world = ((world_bounds_max - cam_pos_y)
                                                 / ray.intersection_distances[1])
                    min_clip_a = lerp(cs_min_last, cs_max_last, cl_min)
                    max_clip_a = lerp(cs_min_last, cs_max_last, cl_max)
                    min_clip_b = lerp(cs_min_next, cs_max_next, cn_min)
                    max_clip_b = lerp(cs_min_next, cs_max_next, cn_max)
                    min_next = min_clip_b[0] / min_clip_b[2]
                    min_last = min_clip_a[0] / min_clip_a[2]
                    max_next = max_clip_b[0] / max_clip_b[2]
                    max_last = max_clip_a[0] / max_clip_a[2]
                    if max_next < min_next:
                        max_next, min_next = min_next, max_next
                    if max_last < min_last:
                        max_last, min_last = min_last, max_last
                    cs_clip_min = min(min_last, min_next)
                    cs_clip_max = max(max_last, max_next)
                frustum_active = True

                world_bounds_min = np.floor(world_bounds_min)
                world_bounds_max = np.ceil(world_bounds_max)

                writable_min = int(np.floor(cs_clip_min))
                writable_max = int(np.ceil(cs_clip_max))
                if writable_max < nfp_min or writable_min > nfp_max:
                    skybox_and_exit()
                if writable_min > nfp_min:
                    nfp_min = writable_min
                    while nfp_min <= orig_max and seen[nfp_min] > 0:
                        nfp_min += 1
                if writable_max < nfp_max:
                    nfp_max = writable_max
                    while nfp_max >= orig_min and seen[nfp_max] > 0:
                        nfp_max -= 1
                if nfp_min > nfp_max:
                    skybox_and_exit()

            # RLE run iteration (:424-475)
            n_runs = len(runs)
            if iteration_direction > 0:
                eb_min = world_max_y
                eb_max = world_max_y
                indices = range(n_runs)
            else:
                eb_min = F(0.0)
                eb_max = F(0.0)
                indices = range(n_runs - 1, -1, -1)

            for k in indices:
                run = runs[k]
                length = int(rle.run_length(run))
                if iteration_direction > 0:
                    eb_max = eb_min
                    eb_min = eb_min - F(length * int(voxel_scale))
                else:
                    eb_min = eb_max
                    eb_max = eb_min + F(length * int(voxel_scale))

                if rle.run_is_air(run):
                    continue
                if eb_min > world_bounds_max:
                    if iteration_direction < 0:
                        break
                    continue
                if eb_max < world_bounds_min:
                    if iteration_direction > 0:
                        break
                    continue

                colors_index = int(rle.run_colors_index(run))

                portion_bottom = unlerp(F(0.0), world_max_y, eb_min)
                portion_top = unlerp(F(0.0), world_max_y, eb_max)
                cs_front_bottom = lerp(cs_min_last, cs_max_last, portion_bottom)
                cs_front_top = lerp(cs_min_last, cs_max_last, portion_top)

                # side span (:484-542)
                u_a = F(length)
                u_b = F(0.0)
                vis, fa, fb, u_a, u_b = clip_homogeneous_camera_space_line(
                    cs_front_bottom, cs_front_top, u_a, u_b)
                if vis:
                    uv_a = f2(1.0, u_a) / fa[2]
                    uv_b = f2(1.0, u_b) / fb[2]
                    rb_float = project_clipped_to_screen(fa, fb)
                    if rb_float[0] > rb_float[1]:
                        rb_float = rb_float[::-1].copy()
                        uv_a, uv_b = uv_b, uv_a
                    rb_min = int(np.round(rb_float[0]))
                    rb_max = int(np.round(rb_float[1]))
                    if rb_max >= nfp_min and rb_min <= nfp_max:
                        rb_min, rb_max, nfp_min, nfp_max = _reduce_pixel_horizon(
                            orig_min, orig_max, rb_min, rb_max, nfp_min, nfp_max,
                            seen, frustum_bounds)
                        for y in range(rb_min, rb_max + 1):
                            if seen[y] == 0:
                                frustum_active = False
                                seen[y] = 1
                                l = unlerp(rb_float[0], rb_float[1], F(y))
                                wu = lerp(uv_a, uv_b, l)
                                with np.errstate(invalid="ignore"):
                                    u = wu[1] / wu[0]
                                if np.isnan(u):
                                    iu = 0  # C# (int)NaN == 0 after clamp
                                else:
                                    iu = int(np.floor(u))
                                color_idx = min(max(iu, 0), length - 1) + colors_index
                                ray_column[y] = colors[color_idx]
                        if nfp_min > nfp_max:
                            skybox_and_exit()

                # top/bottom cap (:544-610)
                if portion_top < cam_pos_y_normalized:
                    if eb_max > world_bounds_max:
                        continue
                    secondary_color = colors[colors_index + 0]
                    cs_sec_a = lerp(cs_min_next, cs_max_next, portion_top)
                    cs_sec_b = cs_front_top
                elif portion_bottom > cam_pos_y_normalized:
                    if eb_min < world_bounds_min:
                        continue
                    secondary_color = colors[colors_index + length - 1]
                    cs_sec_a = lerp(cs_min_next, cs_max_next, portion_bottom)
                    cs_sec_b = cs_front_bottom
                else:
                    continue

                vis, sa, sb = clip_homogeneous_camera_space_line(cs_sec_a, cs_sec_b)
                if vis:
                    rb_float = np.round(project_clipped_to_screen(sa, sb))
                    rb_min = int(rb_float[0])
                    rb_max = int(rb_float[1])
                    if rb_min > rb_max:
                        rb_min, rb_max = rb_max, rb_min
                    if rb_max >= nfp_min and rb_min <= nfp_max:
                        rb_min, rb_max, nfp_min, nfp_max = _reduce_pixel_horizon(
                            orig_min, orig_max, rb_min, rb_max, nfp_min, nfp_max,
                            seen, frustum_bounds)
                        for y in range(rb_min, rb_max + 1):
                            if seen[y] == 0:
                                frustum_active = False
                                seen[y] = 1
                                ray_column[y] = secondary_color
                        if nfp_min > nfp_max:
                            skybox_and_exit()

            if ray.step_cell(far_clip):
                break

        # reached far clip (:618-619)
        _write_skybox(orig_min, orig_max, ray_column, seen)
    except _RayTerminated:
        pass


def trace_to_first_column(ray: SegmentDDA, cam_data: CameraData, dims_xz):
    """TraceToFirstColumnJob.Execute (:95-143), REPEAT_WORLD=False branch.

    Returns (alive, lod).  When not alive the caller writes the full skybox.
    """
    lod = 0
    lod_max = F(cam_data.lod_distances[0])
    pos = ray.position
    if not (0 <= pos[0] < dims_xz[0] and 0 <= pos[1] < dims_xz[1]):
        if not ray.step_to_world_intersection(np.asarray(dims_xz, F)):
            return False, lod
        lod_distances = np.append(cam_data.lod_distances, [INF, INF]).astype(F)
        while ray.intersection_distances[0] >= lod_max:
            ray.next_lod(1 << lod)
            lod += 1
            lod_max = F(lod_distances[lod])
        if ray.is_beyond_far_clip(F(cam_data.far_clip)):
            return False, lod
    return True, lod


def render_raybuffers_oracle(
    lods: list[WorldLOD], cam: Camera, cam_data: CameraData,
    segs: list[sg.SegmentData], ctxs: list[sg.SegmentContext],
):
    """Phase 1 for a whole frame: returns (topdown, leftright) uint32 raybuffers.

    Layout matches the reference (RenderManager.cs:34-38): topdown rows are rays of
    segments 0+1 with pixel axis = screen height; leftright rows are rays of segments
    2+3 with pixel axis = screen width.  Unwritten texels keep DEBUG_MAGENTA
    (RenderManager.ClearRayBuffer:58-92).
    """
    w, h = cam.screen
    topdown = np.full((segs[0].ray_count + segs[1].ray_count, h), DEBUG_MAGENTA,
                      np.uint32)
    leftright = np.full((segs[2].ray_count + segs[3].ray_count, w), DEBUG_MAGENTA,
                        np.uint32)
    dims_xz = (lods[0].dims[0], lods[0].dims[2])
    iteration_direction = -1 if cam_data.inverse_element_iteration_direction else 1

    for si, (seg, ctx) in enumerate(zip(segs, ctxs)):
        if seg.ray_count <= 0:
            continue
        buf = topdown if si < 2 else leftright
        dirs = sg.ray_directions(seg)
        for i in range(seg.ray_count):
            ray = SegmentDDA(cam_data.position_xz, dirs[i])
            row = buf[i + ctx.ray_index_offset]
            alive, lod = trace_to_first_column(ray, cam_data, dims_xz)
            if not alive:
                row[ctx.next_free_pixel_min: ctx.next_free_pixel_max + 1] = SKYBOX
                continue
            execute_ray(ray, lod, lods, cam_data, ctx, row, iteration_direction)
    return topdown, leftright


def reproject_oracle(
    cam: Camera, segs: list[sg.SegmentData], ctxs: list[sg.SegmentContext],
    vp_screen, topdown: np.ndarray, leftright: np.ndarray,
) -> np.ndarray:
    """Phase 2, scalar: raybuffer -> screen, (H, W) uint32 with [0,0] = bottom-left.

    Defines this framework's reprojection spec (the reference does it in a fragment
    shader over 4 screen-space triangles, RayBufferBlit.shader:47-63 +
    RenderManager.BlitSegments:199-256): a pixel center belongs to the first segment
    triangle (vp, max_screen, min_screen) containing it; the ray index is
    offset + floor(RayCount * bMax/(bMax+bMin)) from the barycentric weights of the
    max/min corners; the texel along the ray is screen y (segments 0/1) or x (2/3).
    """
    w, h = cam.screen
    vp = np.asarray(vp_screen, F)
    out = np.full((h, w), SKYBOX, np.uint32)
    tri = []
    for si, seg in enumerate(segs):
        if seg.ray_count <= 0:
            tri.append(None)
            continue
        tri.append((vp, np.asarray(seg.max_screen, F),
                    np.asarray(seg.min_screen, F)))

    def bary(p, a, b, c):
        v0 = b - a
        v1 = c - a
        v2 = p - a
        den = v0[0] * v1[1] - v1[0] * v0[1]
        if den == 0:
            return None
        bb = (v2[0] * v1[1] - v1[0] * v2[1]) / den
        cc = (v0[0] * v2[1] - v2[0] * v0[1]) / den
        return 1.0 - bb - cc, bb, cc

    for py in range(h):
        for px in range(w):
            p = np.array([px + 0.5, py + 0.5], F)
            best = None
            best_score = -np.inf
            for si in range(4):
                if tri[si] is None:
                    continue
                res = bary(p, *tri[si])
                if res is None:
                    continue
                score = min(res)
                if score >= 0.0:
                    best = (si, res)
                    break
                if score > best_score:
                    best_score = score
                    best = (si, res)
            if best is None:
                continue
            si, (bvp, bmax, bmin) = best
            seg = segs[si]
            denom = bmax + bmin
            x = bmax / denom if denom != 0 else 0.0
            ray_idx = int(np.floor(x * seg.ray_count))
            ray_idx = min(max(ray_idx, 0), seg.ray_count - 1) + ctxs[si].ray_index_offset
            texel = py if si < 2 else px
            buf = topdown if si < 2 else leftright
            out[py, px] = buf[ray_idx, texel]
    return out
