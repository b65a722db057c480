"""Vanishing-point screen segmentation.

The screen is split into up to 4 triangular segments fanning out from the vanishing
point (top/bottom/right/left of XZ world space); each segment gets a fan of ray columns
between two camera-local plane directions.  Transliterated from
RenderManager.cs:128-142 (segment selection), :402-501 (GetGenericSegmentParameters,
including the screen-corner clamping), and :284-318 (per-segment raybuffer pixel ranges).

Segment order matches the reference: 0=top (+z-ish), 1=bottom, 2=right, 3=left.
Segments 0/1 write the "top-down" raybuffer (pixel axis = screen y); 2/3 the
"left-right" raybuffer (pixel axis = screen x).

A copy of ``cpuvox_tpu/render/segments.py`` (plain numpy): the port keeps
its own copy and imports nothing of the JAX package.
``tests/test_torch_copies.py`` holds the two equal.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .camera import Camera, transform_pixel_to_local_xz

F = np.float32


@dataclasses.dataclass
class SegmentData:
    """RenderManager.SegmentData (:503-510)."""

    min_screen: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(2, F))
    max_screen: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(2, F))
    cam_local_plane_ray_min: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(2, F))
    cam_local_plane_ray_max: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(2, F))
    ray_count: int = 0


@dataclasses.dataclass
class SegmentContext:
    """DrawSegmentRayJob.SegmentContext (:718-727), minus the raw buffer pointer."""

    segment: SegmentData
    axis_mapped_to_y: int  # 1 for segments 0/1 (pixel axis = screen y), 0 for 2/3
    ray_index_offset: int  # offset within the segment pair's raybuffer
    next_free_pixel_min: int
    next_free_pixel_max: int
    seen_pixel_cache_length: int


def _signed_angle_deg(a: np.ndarray, b: np.ndarray) -> float:
    """Unity Vector2.SignedAngle: degrees, positive counter-clockwise."""
    cross = F(a[0]) * F(b[1]) - F(a[1]) * F(b[0])
    dot = F(a[0]) * F(b[0]) + F(a[1]) * F(b[1])
    return float(np.degrees(np.arctan2(cross, dot)))


def _round_to_int(v: float) -> int:
    """Mathf.RoundToInt — round half to even (banker's), like np.round."""
    return int(np.round(v))


def generic_segment_parameters(
    cam: Camera, vp_screen: np.ndarray, dist_to_other_end: float,
    neutral: np.ndarray, primary_axis: int,
) -> SegmentData:
    """RenderManager.GetGenericSegmentParameters (:402-501)."""
    screen = np.array(cam.screen, F)
    vp = np.asarray(vp_screen, F)
    seg = SegmentData()
    secondary = 1 - primary_axis
    dist = F(dist_to_other_end)

    simple_min = np.empty(2, F)
    simple_max = np.empty(2, F)
    simple_min[secondary] = vp[secondary] - dist
    simple_max[secondary] = vp[secondary] + dist
    a = vp[primary_axis] + dist * np.sign(neutral[primary_axis], dtype=F)
    simple_min[primary_axis] = a
    simple_max[primary_axis] = a

    if simple_max[secondary] <= 0.0 or simple_min[secondary] >= screen[secondary]:
        return seg  # the 45-degree rays never touch the screen

    if np.all((vp >= 0) & (vp <= screen)):
        seg.min_screen = simple_min
        seg.max_screen = simple_max
    else:
        # clamp the triangle toward the screen corners (:435-478)
        dir_simple_middle = simple_min + (simple_max - simple_min) * F(0.5) - vp
        angle_left, angle_right = 90.0, -90.0
        dir_left = np.zeros(2, F)
        dir_right = np.zeros(2, F)
        corners = [np.array(c, F) for c in
                   [(0, 0), (0, screen[1]), (screen[0], 0), (screen[0], screen[1])]]
        for corner in corners:
            d = corner - vp
            scaled_end = d * (dist / np.abs(d[primary_axis]))
            angle = _signed_angle_deg(neutral, d)
            if angle < angle_left:
                angle_left = angle
                dir_left = scaled_end
            if angle > angle_right:
                angle_right = angle
                dir_right = scaled_end
        corner_left = dir_left + vp
        corner_right = dir_right + vp
        if angle_left < -45.0:
            corner_left = (simple_min
                           if _signed_angle_deg(dir_simple_middle, simple_max) > 0
                           else simple_max)
        if angle_right > 45.0:
            corner_right = (simple_min
                            if _signed_angle_deg(dir_simple_middle, simple_max) < 0
                            else simple_max)
        if corner_left[secondary] > corner_right[secondary]:
            seg.min_screen, seg.max_screen = corner_right, corner_left
        else:
            seg.min_screen, seg.max_screen = corner_left, corner_right

    seg.cam_local_plane_ray_min = transform_pixel_to_local_xz(cam, seg.min_screen)
    seg.cam_local_plane_ray_max = transform_pixel_to_local_xz(cam, seg.max_screen)
    seg.ray_count = max(
        0, _round_to_int(seg.max_screen[secondary] - seg.min_screen[secondary]))
    return seg


def build_segments(cam: Camera, vp_screen: np.ndarray) -> list[SegmentData]:
    """RenderManager.cs:128-142 — up to 4 active segments around the VP."""
    w, h = cam.screen
    vp = np.asarray(vp_screen, F)
    segs = [SegmentData() for _ in range(4)]
    if vp[1] < h:
        segs[0] = generic_segment_parameters(cam, vp, h - vp[1], np.array([0, 1], F), 1)
    if vp[1] > 0:
        segs[1] = generic_segment_parameters(cam, vp, vp[1], np.array([0, -1], F), 1)
    if vp[0] < w:
        segs[2] = generic_segment_parameters(cam, vp, w - vp[0], np.array([1, 0], F), 0)
    if vp[0] > 0:
        segs[3] = generic_segment_parameters(cam, vp, vp[0], np.array([-1, 0], F), 0)
    return segs


def build_segment_contexts(
    cam: Camera, segments: list[SegmentData], vp_screen: np.ndarray
) -> list[SegmentContext]:
    """RenderManager.DrawSegments context setup (:284-318)."""
    w, h = cam.screen
    vp = np.asarray(vp_screen, F)
    out = []
    for i, seg in enumerate(segments):
        axis_y = 0 if i > 1 else 1
        offset = 0
        if i == 1:
            offset = segments[0].ray_count
        if i == 3:
            offset = segments[2].ray_count
        if i == 0:
            nfp = (int(np.clip(_round_to_int(vp[1]), 0, h - 1)), h - 1)
        elif i == 1:
            nfp = (0, int(np.clip(_round_to_int(vp[1]), 0, h - 1)))
        elif i == 2:
            nfp = (int(np.clip(_round_to_int(vp[0]), 0, w - 1)), w - 1)
        else:
            nfp = (0, int(np.clip(_round_to_int(vp[0]), 0, w - 1)))
        out.append(SegmentContext(
            segment=seg,
            axis_mapped_to_y=axis_y,
            ray_index_offset=offset,
            next_free_pixel_min=nfp[0],
            next_free_pixel_max=nfp[1],
            seen_pixel_cache_length=int(np.ceil(F(cam.screen[axis_y]))),
        ))
    return out


def ray_directions(segment: SegmentData) -> np.ndarray:
    """Per-ray normalized camera-local XZ directions (DDASetupJob,
    DrawSegmentRayJob.cs:58-69): lerp(CamLocalPlaneRayMin, CamLocalPlaneRayMax,
    i / RayCount), normalized.  Shape (ray_count, 2)."""
    n = segment.ray_count
    if n == 0:
        return np.zeros((0, 2), F)
    t = (np.arange(n, dtype=F) / F(n))[:, None]
    lo = segment.cam_local_plane_ray_min[None, :]
    hi = segment.cam_local_plane_ray_max[None, :]
    d = lo + (hi - lo) * t  # C# math.lerp form, kept for float reproducibility
    return d / np.sqrt(np.sum(d * d, axis=1, dtype=F))[:, None]
