"""Deterministic benchmark flythrough path.

Keyframes are taken from the reference's BenchmarkPath.anim (euler rotation + world-
normalized position, clip length 1.15; played at 1/40 speed and scaled by world dims —
UnityManager.cs:86-95, BenchmarkPath.anim).  Interpolation here is centripetal-free
Catmull-Rom (Unity samples with auto Hermite tangents; the exact tangent weights are
editor-internal, so this path is *our* benchmark definition — deterministic and cited,
not bit-matched).

A copy of ``cpuvox_tpu/bench/path.py`` (plain numpy): the port keeps its own
copy and imports nothing of the JAX package.  ``tests/test_torch_copies.py``
holds the two equal.
"""
from __future__ import annotations

import numpy as np

from cpuvox_tpu_torch.render.camera import Camera

F = np.float32

BENCH_CLIP_LENGTH = 1.15  # BenchmarkPath.anim:179
BENCH_TIME_SCALE = 40.0  # UnityManager.cs:86 (benchmarkTime / 40)

_ROT_KEYS = np.array([
    # t,    pitch,  yaw,    roll
    [0.000, 0.0, 45.0, 0.0],
    [0.250, 0.0, -45.0, 0.0],
    [0.500, -16.2, -135.0, 0.0],
    [0.750, 59.12, -135.0, 0.0],
    [0.875, 59.12, -135.0, 180.0],
    [1.000, 59.12, -135.0, 360.0],
    [1.150, 85.0, -225.5, 360.0],
], dtype=F)

_POS_KEYS = np.array([
    # t,    x,     y,    z      (normalized by world dims)
    [0.000, -0.1, 0.5, -0.1],
    [0.250, 1.1, 0.5, -0.1],
    [0.500, 0.9, 0.3, 0.9],
    [0.750, 0.9, 0.95, 0.9],
    [1.000, 0.9, 0.95, 0.9],
    [1.150, 0.427, 0.95, 0.52],
], dtype=F)


def _catmull_rom(keys: np.ndarray, t: float) -> np.ndarray:
    ts = keys[:, 0]
    vs = keys[:, 1:]
    t = float(np.clip(t, ts[0], ts[-1]))
    i = int(np.searchsorted(ts, t, side="right")) - 1
    i = min(max(i, 0), len(ts) - 2)
    t0, t1 = ts[i], ts[i + 1]
    u = (t - t0) / (t1 - t0) if t1 > t0 else 0.0
    p1 = vs[i]
    p2 = vs[i + 1]
    p0 = vs[max(i - 1, 0)]
    p3 = vs[min(i + 2, len(ts) - 1)]
    m1 = (p2 - p0) * 0.5
    m2 = (p3 - p1) * 0.5
    u2 = u * u
    u3 = u2 * u
    return ((2 * u3 - 3 * u2 + 1) * p1 + (u3 - 2 * u2 + u) * m1
            + (-2 * u3 + 3 * u2) * p2 + (u3 - u2) * m2)


def benchmark_camera(clip_t: float, world_dims, screen=(1920, 1080)) -> Camera:
    """Camera pose at clip time t in [0, BENCH_CLIP_LENGTH]."""
    rot = _catmull_rom(_ROT_KEYS, clip_t)
    pos = _catmull_rom(_POS_KEYS, clip_t) * np.asarray(world_dims, F)
    return Camera(position=tuple(float(p) for p in pos),
                  pitch_deg=float(rot[0]), yaw_deg=float(rot[1]),
                  roll_deg=float(rot[2]), screen=screen)
