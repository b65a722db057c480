"""Phase 2: raybuffer -> screen reprojection (``cpuvox_tpu/render/reproject.py``).

Per screen pixel: (segment id, ray index) from elementwise barycentric math,
then one sample of the color-index raybuffer (``ops/reproject_kernel``).  A
pixel center belongs to the first segment triangle (vp, max_screen,
min_screen) containing it, else the triangle with the largest minimum
barycentric; ray index = offset + floor(RayCount * bMax / (bMax + bMin));
texel = screen y for segments 0/1 and screen x for 2/3.
"""
from __future__ import annotations

import numpy as np
import torch

from cpuvox_tpu_torch.shared import segments as sg

from .raymarch import to_i32

F = np.float32


def reproject_tables(segs: list[sg.SegmentData], ctxs: list[sg.SegmentContext],
                     vp_screen, n_topdown_rays: int):
    """Host-side per-frame constants for the reprojection (a numpy copy of
    ``cpuvox_tpu/render/reproject.py:25``, which lives in a jax module)."""
    vp = np.asarray(vp_screen, F)
    tri_a = np.zeros((4, 2), F)  # vp
    tri_b = np.zeros((4, 2), F)  # max corner
    tri_c = np.zeros((4, 2), F)  # min corner
    ray_count = np.zeros(4, np.int32)
    ray_base = np.zeros(4, np.int32)  # global row in the concatenated raybuffer
    active = np.zeros(4, bool)
    for si, (seg, ctx) in enumerate(zip(segs, ctxs)):
        if seg.ray_count <= 0:
            continue
        active[si] = True
        tri_a[si] = vp
        tri_b[si] = seg.max_screen
        tri_c[si] = seg.min_screen
        ray_count[si] = seg.ray_count
        ray_base[si] = (0 if si < 2 else n_topdown_rays) + ctx.ray_index_offset
    return dict(tri_a=tri_a, tri_b=tri_b, tri_c=tri_c, ray_count=ray_count,
                ray_base=ray_base, active=active)


def segment_ray_index(tables, width: int, height: int, device="cpu"):
    """Per-pixel (segment id, global ray index), both (H, W) int32
    (``reproject.py:48``).  The per-segment scalars are f32, and the float
    operations run in the reference's order."""
    tri_a = torch.from_numpy(tables["tri_a"]).to(device)
    tri_b = torch.from_numpy(tables["tri_b"]).to(device)
    tri_c = torch.from_numpy(tables["tri_c"]).to(device)
    ray_count = tables["ray_count"]
    ray_base = tables["ray_base"]
    active = tables["active"]
    px = (torch.arange(width, dtype=torch.float32, device=device) + 0.5)[None, :]
    py = (torch.arange(height, dtype=torch.float32, device=device) + 0.5)[:, None]

    neg_inf = torch.tensor(-np.inf, dtype=torch.float32, device=device)
    best_score = torch.full((height, width), -np.inf, dtype=torch.float32,
                            device=device)
    best_id = torch.zeros((height, width), dtype=torch.int32, device=device)
    inside_any = torch.zeros((height, width), dtype=torch.bool, device=device)
    inside_id = torch.zeros((height, width), dtype=torch.int32, device=device)
    bms, bns = [], []
    for si in range(4):
        v0x = tri_b[si, 0] - tri_a[si, 0]
        v0y = tri_b[si, 1] - tri_a[si, 1]
        v1x = tri_c[si, 0] - tri_a[si, 0]
        v1y = tri_c[si, 1] - tri_a[si, 1]
        v2x = px - tri_a[si, 0]
        v2y = py - tri_a[si, 1]
        den = v0x * v1y - v1x * v0y
        den = torch.where(den == 0, torch.full_like(den, 1e-30), den)
        b_max = (v2x * v1y - v1x * v2y) / den  # weight of the max corner
        b_min = (v0x * v2y - v2x * v0y) / den  # weight of the min corner
        b_vp = 1.0 - b_max - b_min
        score = torch.minimum(torch.minimum(b_vp, b_max), b_min)
        if not active[si]:
            score = neg_inf.expand_as(score)
        bms.append(b_max)
        bns.append(b_min)

        inside = score >= 0.0
        take_inside = inside & ~inside_any
        inside_id = torch.where(take_inside, si, inside_id)
        inside_any = inside_any | inside
        better = score > best_score  # strict: the first of equal maxima wins
        best_id = torch.where(better, si, best_id)
        best_score = torch.maximum(best_score, score)

    seg_id = torch.where(inside_any, inside_id, best_id)
    ray_idx = torch.zeros((height, width), dtype=torch.int32, device=device)
    for si in range(4):
        denom = bms[si] + bns[si]
        x = torch.where(denom != 0, bms[si] / denom, 0.0)
        rc = int(ray_count[si])
        # jnp.clip order: max with 0, then min with rc - 1 (-1 when rc is 0)
        ridx = to_i32(torch.floor(x * float(rc))).clamp(min=0).clamp(max=rc - 1)
        ray_idx = torch.where(seg_id == si, ridx + int(ray_base[si]), ray_idx)
    return seg_id, ray_idx


def reproject(raybuf_idx, tables, width: int, height: int, skybox: int = 0,
              kernels: bool = True):
    """(R, P) int32 color-index raybuffer -> (H, W) int32 color-index screen,
    row 0 = bottom (``reproject.py:109``, sampled as ``reproject_pallas``
    does).  ``kernels`` picks the CUDA sample kernel on a CUDA tensor; False
    runs its plain torch version."""
    from cpuvox_tpu_torch.ops import reproject_kernel as rk

    seg_id, ray_idx = segment_ray_index(tables, width, height,
                                        raybuf_idx.device)
    sample = rk.reproject_sample if kernels else rk.reproject_sample_ref
    out = sample(raybuf_idx, seg_id, ray_idx)
    if not tables["active"].any():
        return torch.full_like(out, skybox)
    return out
