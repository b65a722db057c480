"""Packed ARGB32 color helpers.

The reference stores colors as a 4-byte ARGB struct matching the Unity texture layout
(Assets/Code/Utils/Color24.cs:5-29).  On TPU we pack the same bytes into a uint32
(a<<24 | r<<16 | g<<8 | b) so a voxel color is one lane element; unpacking to
(H, W, 3) uint8 happens only on the host for display.

The benchmark's frozen copy of ``cpuvox_tpu_torch/utils/colors.py`` (plain
numpy), kept under the benchmark so that a change to the program cannot
move the yardstick; ``voxbench/tests/test_voxbench_copies.py`` holds it
equal to the program's at a small size.
"""
from __future__ import annotations

import numpy as np


def pack_argb(r, g, b, a=255):
    """Pack channel arrays/scalars (uint8 range ints) into uint32 ARGB."""
    r = np.asarray(r, dtype=np.uint32)
    g = np.asarray(g, dtype=np.uint32)
    b = np.asarray(b, dtype=np.uint32)
    a = np.asarray(a, dtype=np.uint32)
    return ((a << 24) | (r << 16) | (g << 8) | b).astype(np.uint32)


def unpack_argb(packed):
    """uint32 ARGB -> (r, g, b, a) uint8 arrays."""
    packed = np.asarray(packed, dtype=np.uint32)
    a = ((packed >> 24) & 0xFF).astype(np.uint8)
    r = ((packed >> 16) & 0xFF).astype(np.uint8)
    g = ((packed >> 8) & 0xFF).astype(np.uint8)
    b = (packed & 0xFF).astype(np.uint8)
    return r, g, b, a


def to_rgb_image(packed):
    """uint32 ARGB image array -> uint8 RGB image with a trailing channel dim."""
    r, g, b, _ = unpack_argb(packed)
    return np.stack([r, g, b], axis=-1)


SKYBOX = pack_argb(25, 25, 25)  # DrawSegmentRayJob.cs:702
DEBUG_MAGENTA = pack_argb(255, 20, 147)  # RenderManager.cs:64 (ClearRayBuffer)


def write_ppm(path, rgb):
    """Write an (H, W, 3) uint8 RGB array as binary PPM (no deps needed)."""
    rgb = np.asarray(rgb, dtype=np.uint8)
    h, w, _ = rgb.shape
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(rgb.tobytes())
