"""Camera math (host-side, numpy float32).

Re-derives everything the reference gets from UnityEngine.Camera so the snapshot handed
to the kernels matches `CameraData` (reference: Assets/Code/Utils/CameraData.cs:9-36):

- ``world_to_screen``: Scale(screen)·Translate(.5,.5,1)·Scale(.5,.5,1)·proj·worldToCamera
  (CameraData.cs:24-29).  A world point projects to homogeneous (x, y, z, w) where
  x/w, y/w are *pixel* coordinates and z+w <= 0 means "behind the near plane"
  (see ClipHomogeneousCameraSpaceLine, CameraData.cs:124-157 testing `.y <= 0` on the
  (pixel, z+w, w) triple selected in DrawSegmentRayJob.SetupProjectedPlaneParams:638-650).
- the vanishing point (RenderManager.cs:374-394)
- screen->camera-local ray directions (RenderManager.cs:487-500 TransformPixel)
- brute-force LOD distances (UnityManager.cs:417-458 SetupLods)

Unity conventions reproduced here: left-handed world (x right, y up, z forward),
camera looks down -z in camera space (hence the Scale(1,1,-1)), GL-style projection
with clip z in [-w, w], rotation order R = Ry(yaw)·Rx(pitch)·Rz(roll).

All arithmetic is float32 to stay faithful to the Burst float path.

A copy of ``cpuvox_tpu/render/camera.py`` (plain numpy): the port keeps its
own copy and imports nothing of the JAX package.
``tests/test_torch_copies.py`` holds the two equal.
"""
from __future__ import annotations

import dataclasses

import numpy as np

F = np.float32


@dataclasses.dataclass(frozen=True)
class Camera:
    """A camera pose + intrinsics (what the reference reads off the Unity Camera)."""

    position: tuple[float, float, float]
    pitch_deg: float = 0.0  # euler x; positive looks down (Unity convention)
    yaw_deg: float = 0.0    # euler y
    roll_deg: float = 0.0   # euler z
    fov_y_deg: float = 85.0
    near: float = 0.05
    far: float = 1000.0
    screen: tuple[int, int] = (1280, 720)  # pixel (width, height)

    @property
    def aspect(self) -> float:
        return self.screen[0] / self.screen[1]


def limit_rotation_horizon(cam: Camera) -> Camera:
    """Avoid infinities when looking exactly at the horizon.

    The reference clamps transform.forward.y to +-0.001 (UnityManager.cs:193-201, which
    incidentally resets roll via the forward setter).  We clamp pitch so that
    |sin(pitch)| >= 0.001, preserving yaw/roll.
    """
    s = np.sin(np.deg2rad(F(cam.pitch_deg)))
    if abs(s) < 0.001:
        sign = 1.0 if s >= 0 else -1.0
        pitch = float(np.rad2deg(np.arcsin(F(0.00101)))) * sign
        return dataclasses.replace(cam, pitch_deg=pitch)
    return cam


def rotation_matrix(pitch_deg, yaw_deg, roll_deg) -> np.ndarray:
    """Unity rotation: R = Ry(yaw)·Rx(pitch)·Rz(roll), 3x3 float32, column-vector."""
    p = np.deg2rad(F(pitch_deg))
    y = np.deg2rad(F(yaw_deg))
    r = np.deg2rad(F(roll_deg))
    cp, sp = np.cos(p, dtype=F), np.sin(p, dtype=F)
    cy, sy = np.cos(y, dtype=F), np.sin(y, dtype=F)
    cr, sr = np.cos(r, dtype=F), np.sin(r, dtype=F)
    # pitch: e_z -> (0, -sin p, cos p)  (positive pitch looks down)
    rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]], dtype=F)
    # yaw: e_z -> (sin y, 0, cos y)  (positive yaw turns right)
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], dtype=F)
    # roll: e_x -> (cos r, sin r, 0)
    rz = np.array([[cr, -sr, 0], [sr, cr, 0], [0, 0, 1]], dtype=F)
    return (ry @ rx @ rz).astype(F)


def camera_rotation(cam: Camera) -> np.ndarray:
    return rotation_matrix(cam.pitch_deg, cam.yaw_deg, cam.roll_deg)


def camera_forward(cam: Camera) -> np.ndarray:
    return camera_rotation(cam) @ np.array([0, 0, 1], dtype=F)


def camera_up(cam: Camera) -> np.ndarray:
    return camera_rotation(cam) @ np.array([0, 1, 0], dtype=F)


def mat4_vec(m: np.ndarray, v) -> np.ndarray:
    """(4,4) @ (4,) with a DEFINED float order: sequential left-to-right
    column accumulation, every product and add separately rounded.

    numpy's `m @ v` delegates to a BLAS gemv kernel whose accumulation order
    and FMA use are platform details (measured: 1-ulp deviations from this
    form on the build host), so it cannot anchor a bit-equality chain.  This
    form matches Unity.Mathematics mul(float4x4, float4) = c0*v.x + c1*v.y +
    c2*v.z + c3*v.w under strict IEEE (DrawSegmentRayJob.cs:622-651 usage),
    and device_init._mat4_vec is its pinned jnp twin."""
    acc = m[:, 0] * F(v[0])
    acc = acc + m[:, 1] * F(v[1])
    acc = acc + m[:, 2] * F(v[2])
    return acc + m[:, 3] * F(v[3])


def _mat4(m3: np.ndarray) -> np.ndarray:
    m = np.eye(4, dtype=F)
    m[:3, :3] = m3
    return m


def _translate(v) -> np.ndarray:
    m = np.eye(4, dtype=F)
    m[:3, 3] = np.asarray(v, dtype=F)
    return m


def _scale(v) -> np.ndarray:
    return np.diag(np.array([v[0], v[1], v[2], 1], dtype=F))


def world_to_camera_matrix(cam: Camera) -> np.ndarray:
    """Unity camera.worldToCameraMatrix = Scale(1,1,-1)·R^T·Translate(-pos)."""
    rot = camera_rotation(cam)
    return (_scale((1, 1, -1)) @ _mat4(rot.T) @ _translate(-np.asarray(cam.position, F))).astype(F)


def projection_matrix(cam: Camera) -> np.ndarray:
    """GL-style perspective projection (Unity's script-visible projectionMatrix)."""
    c = F(1.0) / np.tan(np.deg2rad(F(cam.fov_y_deg)) * F(0.5), dtype=F)
    n, f = F(cam.near), F(cam.far)
    m = np.zeros((4, 4), dtype=F)
    m[0, 0] = c / F(cam.aspect)
    m[1, 1] = c
    m[2, 2] = -(f + n) / (f - n)
    m[2, 3] = -(F(2.0) * f * n) / (f - n)
    m[3, 2] = F(-1.0)
    return m


def world_to_screen_matrix(cam: Camera) -> np.ndarray:
    """CameraData.cs:24-29 — bakes NDC->pixel into the projection."""
    w, h = cam.screen
    m = projection_matrix(cam) @ world_to_camera_matrix(cam)
    m = _scale((0.5, 0.5, 1)) @ m
    m = _translate((0.5, 0.5, 1)) @ m
    m = _scale((w, h, 1)) @ m
    return m.astype(F)


def vanishing_point_world(cam: Camera) -> np.ndarray:
    """RenderManager.cs:374-378: pos + up·(-near / sin(pitch))."""
    s = np.sin(np.deg2rad(F(cam.pitch_deg)), dtype=F)
    return np.asarray(cam.position, F) + np.array([0, 1, 0], F) * (F(-cam.near) / s)


def vanishing_point_screen(cam: Camera, vp_world: np.ndarray) -> np.ndarray:
    """RenderManager.cs:380-394 — camera-local-space projection to dodge precision loss."""
    rot = camera_rotation(cam)  # == Matrix4x4.LookAt(0, forward, up) rotation part
    local_to_screen = projection_matrix(cam) @ _scale((1, 1, -1)) @ _mat4(rot.T)
    local = np.asarray(vp_world, F) - np.asarray(cam.position, F)
    clip = local_to_screen @ np.array([local[0], local[1], local[2], 1], dtype=F)
    ndc = clip[:2] / clip[3]
    w, h = cam.screen
    return ((ndc * F(0.5) + F(0.5)) * np.array([w, h], dtype=F)).astype(F)


def _screen_to_local_matrix(cam: Camera) -> np.ndarray:
    """RenderManager.cs:494-496: R · inverse(Scale(1,1,-1)) · inverse(proj)."""
    inv_proj = np.linalg.inv(projection_matrix(cam).astype(np.float64)).astype(F)
    return (_mat4(camera_rotation(cam)) @ _scale((1, 1, -1)) @ inv_proj).astype(F)


def transform_pixel_to_local_xz(cam: Camera, pixel: np.ndarray) -> np.ndarray:
    """RenderManager.cs:487-500 TransformPixel: screen pixel -> camera-local XZ ray dir.

    Accepts a (..., 2) pixel array; returns (..., 2) xz (un-normalized).
    """
    pixel = np.asarray(pixel, dtype=F)
    w, h = cam.screen
    ndc = (pixel / np.array([w, h], dtype=F) - F(0.5)) * F(2.0)
    ones = np.ones(ndc.shape[:-1] + (1,), dtype=F)
    v4 = np.concatenate([ndc, ones, ones], axis=-1)
    val = v4 @ _screen_to_local_matrix(cam).T
    return val[..., [0, 2]] / val[..., 3:4]


def screen_point_to_ray(cam: Camera, pixel) -> np.ndarray:
    """World-space normalized ray direction through a screen pixel (UnityManager.cs:431-432)."""
    pixel = np.asarray(pixel, dtype=F)
    w, h = cam.screen
    ndc = (pixel / np.array([w, h], dtype=F) - F(0.5)) * F(2.0)
    v4 = np.array([ndc[0], ndc[1], 1, 1], dtype=F)
    val = _screen_to_local_matrix(cam) @ v4  # camera-local here == world dir rotated
    d = val[:3] / val[3]
    return (d / np.linalg.norm(d.astype(np.float64))).astype(F)


def setup_lods(
    cam: Camera, world_max_dimension: int, lod_levels: int = 6, lod_error: float = 1.0
) -> tuple[np.ndarray, float]:
    """UnityManager.cs:417-458 — brute-force LOD distances from pixel-ray divergence.

    Returns (lod_distances[lod_levels] float32, far_clip).  Also mirrors the reference
    in setting far_clip = 2 * world_max_dimension (REPEAT_WORLD=False branch, :421-423).
    """
    clip_max = F(world_max_dimension * 2)
    cam = dataclasses.replace(cam, far=float(clip_max))

    w, h = cam.screen
    mid = np.array([w // 2, h // 2], dtype=F)
    a = screen_point_to_ray(cam, mid)
    b = screen_point_to_ray(cam, mid + F(1.0))  # pixelW == pixelH == 1 at native res

    # dist(p) = p*clip_max*|a-b| is linear in p; replicate the reference's float32
    # 0.0001-step scan semantics analytically over the same grid of p values.
    ps = np.cumsum(np.full(10001, 0.0001, dtype=F), dtype=F) - F(0.0001)
    ps = ps[ps < F(1.0)]
    diff = np.linalg.norm((a - b).astype(np.float64))
    pab = ps * clip_max * F(diff)

    pixel_width = F(1.41) / F(lod_error)
    lods = np.full(lod_levels, F(2.0))
    for j in range(lod_levels):
        thresh = pixel_width * F(2 << j)
        hit = np.nonzero(pab > thresh)[0]
        if hit.size and j < lod_levels - 1:  # last LOD is never exited (:450)
            lods[j] = ps[hit[0]]
    distances = np.ceil(lods * clip_max).astype(F)
    return distances, float(clip_max)


@dataclasses.dataclass(frozen=True)
class CameraData:
    """Burst-compatible camera snapshot (CameraData.cs:9-36) as plain arrays."""

    world_to_screen: np.ndarray  # (4,4) float32
    position: np.ndarray  # (3,) float32
    inverse_element_iteration_direction: bool  # forward.y >= 0 (CameraData.cs:31)
    far_clip: float
    lod_distances: np.ndarray  # (lod_levels,) float32

    @property
    def position_xz(self) -> np.ndarray:
        return self.position[[0, 2]]

    @property
    def position_y(self) -> float:
        return float(self.position[1])


def make_camera_data(cam: Camera, lod_distances: np.ndarray, far_clip: float) -> CameraData:
    fwd = camera_forward(cam)
    return CameraData(
        world_to_screen=world_to_screen_matrix(dataclasses.replace(cam, far=float(far_clip))),
        position=np.asarray(cam.position, F),
        inverse_element_iteration_direction=bool(fwd[1] >= 0.0),
        far_clip=float(far_clip),
        lod_distances=np.asarray(lod_distances, F),
    )
