"""Batched triangle voxelization.

Reference: Assets/Code/VoxelizerHelper.cs:28-132 (Burst kernel, one triangle per call,
task-parallel over cores in WordBuilder.cs:41-96).  TPU-native substitution per
SURVEY.md §7: a data-parallel pass — triangles expand to candidate AABB cells in bulk,
then plane-distance / barycentric / material-alpha tests run as flat masked array ops.

Exact semantics preserved per triangle:
- dilate vertices by half a voxel along (vertex - centroid) (VoxelizerHelper.cs:52-57)
- candidate cells = clamped integer AABB, inclusive (:59-64)
- keep cell if |dot(center - a, n)| <= 0.5 (:77-81) and the plane-projected point has
  all barycentric coords in [0, 1] (:83-101)
- color = barycentric vertex-color blend (:103-108); if the triangle has a material,
  multiply by the point-sampled diffuse texel and drop the voxel when albedo.a < 1
  (WordBuilder.cs:76-84, the translucency non-goal)

Deviation: no 256K-voxel-per-buffer truncation (WordBuilder.cs:37, goto END :124-126) —
the batched pass has no fixed scratch buffer to overflow.

Candidate generation deviates from the reference's full 3-D AABB scan
(VoxelizerHelper.cs:74-76, O(volume) cells per triangle — quadratic blowup at
1024^3+): we rasterize the dilated triangle's 2-D AABB in its dominant-normal
plane and test only a 4-cell depth window around the plane per (u, v) cell.
Every cell with |plane distance| <= 0.5 lies inside that window (|n_d| >= 1/sqrt3
for the dominant axis, so the qualifying depth interval spans < 2 cells), and the
exact reference tests still run on every candidate — the OUTPUT set is identical,
the candidate set is O(area) instead of O(volume).

``_prepare_triangles`` and ``voxelize_mesh`` are copies of
``cpuvox_tpu/assets/voxelizer.py`` (plain numpy; ``voxelize_mesh`` is the
reference).  ``voxelize_mesh_device`` is the device path in torch, rewritten
from the JAX package's: the same candidates and tests, output-identical to
``voxelize_mesh`` (``tests/test_torch_assets.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from .mesh import SimpleMesh

F = np.float32


def _normalize(v):
    n = np.sqrt(np.sum(v * v, axis=-1, keepdims=True, dtype=F))
    return v / n


DW = 4  # depth-window cells per (u, v) candidate


def _prepare_triangles(mesh: SimpleMesh, dims):
    """Shared host prep for both voxelizer paths: dilation, AABBs, dominant
    axis, candidate counts (all the per-TRIANGLE tables)."""
    max_dim = np.array(dims, np.int64) - 1
    tris = mesh.positions.reshape(-1, 3, 3).astype(F)
    tcolors = mesh.colors.reshape(-1, 3, 4).astype(F) / F(255.0)
    tuvs = mesh.uvs.reshape(-1, 3, 2).astype(F)
    tmat = mesh.material_index.reshape(-1, 3)[:, 0]
    n_tris = tris.shape[0]

    a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
    cross = np.cross(b - a, c - a).astype(F)
    cross_sq = np.sum(cross * cross, axis=-1, dtype=F)
    valid_tri = cross_sq != 0.0
    with np.errstate(invalid="ignore", divide="ignore"):
        normal = cross * (1.0 / np.sqrt(cross_sq))[:, None].astype(F)
        middle = (a + b + c) / F(3.0)
        ad = a + _normalize(a - middle) * F(0.5)
        bd = b + _normalize(b - middle) * F(0.5)
        cd = c + _normalize(c - middle) * F(0.5)

    minf = np.minimum(ad, np.minimum(bd, cd))
    maxf = np.maximum(ad, np.maximum(bd, cd))
    with np.errstate(invalid="ignore"):
        mini = np.clip(np.floor(minf), 0, max_dim).astype(np.int64)
        maxi = np.clip(np.ceil(maxf), 0, max_dim).astype(np.int64)
    span = np.where(valid_tri[:, None], maxi - mini + 1, 0)

    ar = np.arange(n_tris)
    with np.errstate(invalid="ignore"):
        d_ax = np.argmax(np.abs(np.where(np.isnan(normal), 0, normal)), axis=1)
    u_ax = (d_ax + 1) % 3
    v_ax = (d_ax + 2) % 3
    su = span[ar, u_ax]
    sv = span[ar, v_ax]
    counts = su * sv * DW
    counts[~valid_tri] = 0
    plane_off = np.sum(normal * ad, axis=-1, dtype=F)  # n . (dilated a)
    return dict(tcolors=tcolors, tuvs=tuvs, tmat=tmat, valid_tri=valid_tri,
                normal=normal, ad=ad, bd=bd, cd=cd, mini=mini, maxi=maxi,
                d_ax=d_ax, sv=sv, counts=counts, plane_off=plane_off)


def voxelize_mesh(
    mesh: SimpleMesh, dims: tuple[int, int, int], chunk_candidates: int = 4_000_000
):
    """Voxelize a (rescaled) mesh into a voxel soup.

    Returns (xz_index int64, y int64, (r, g, b) uint8 arrays) ready for
    world.build_lod_from_voxels.  xz_index = x * dims[2] + z (VoxelizerHelper.cs:114,
    with maxDimensions.z + 1 == dims.z).
    """
    pr = _prepare_triangles(mesh, dims)
    tcolors, tuvs, tmat = pr["tcolors"], pr["tuvs"], pr["tmat"]
    valid_tri, normal = pr["valid_tri"], pr["normal"]
    ad, bd, cd = pr["ad"], pr["bd"], pr["cd"]
    mini, maxi, d_ax = pr["mini"], pr["maxi"], pr["d_ax"]
    sv, counts, plane_off = pr["sv"], pr["counts"], pr["plane_off"]

    out_xz, out_y, out_r, out_g, out_b = [], [], [], [], []

    # process per dominant axis (static u/v/d columns — no two-array fancy
    # indexing) and chunk so a chunk's candidate count stays bounded
    for dax in range(3):
        uax = (dax + 1) % 3
        vax = (dax + 2) % 3
        gsel = np.nonzero(valid_tri & (d_ax == dax) & (counts > 0))[0]
        if gsel.size == 0:
            continue
        mini_u = mini[:, uax]
        mini_v = mini[:, vax]
        mini_d = mini[:, dax]
        maxi_d = maxi[:, dax]
        norm_u = normal[:, uax]
        norm_v = normal[:, vax]
        norm_d = normal[:, dax]

        csum = np.cumsum(counts[gsel])
        gstart = 0
        while gstart < gsel.size:
            target = (csum[gstart - 1] if gstart else 0) + chunk_candidates
            gend = int(np.searchsorted(csum, target)) + 1
            gend = min(max(gend, gstart + 1), gsel.size)
            sel = gsel[gstart:gend]
            gstart = gend

            t_counts = counts[sel]
            tri_of = np.repeat(sel, t_counts)
            offs = np.cumsum(t_counts) - t_counts
            within = (np.arange(t_counts.sum(), dtype=np.int64)
                      - np.repeat(offs, t_counts)).astype(np.int32)
            jd = within & (DW - 1)
            iu, iv = np.divmod(within >> 2, sv[tri_of].astype(np.int32))
            cu = mini_u[tri_of] + iu
            cv = mini_v[tri_of] + iv
            nu = norm_u[tri_of]
            nv = norm_v[tri_of]
            nd = norm_d[tri_of]
            # depth window: integers d with |n.(center - a)| <= 0.5 satisfy
            # d + 0.5 in [ (q - 0.5)/nd , (q + 0.5)/nd ] where q is the plane
            # offset minus the in-plane normal terms; DW=4 from dlo covers the
            # interval (length <= sqrt3 since |nd| >= 1/sqrt3) with fp margin
            q = plane_off[tri_of] - nu * (cu.astype(F) + F(0.5)) \
                - nv * (cv.astype(F) + F(0.5))
            with np.errstate(divide="ignore", invalid="ignore"):
                dc = q / nd
                half = F(0.5) / np.abs(nd)
                dlo = np.floor(dc - F(0.5) - half)
            dlo = np.where(np.isfinite(dlo), dlo, 0).astype(np.int64)
            cdp = dlo + jd
            # cheap prefilter (q-based plane distance with fp slack), then
            # compress before the exact reference tests.  dist_q is computed in
            # a different f32 op order than the exact full-3D dot below, so the
            # slack must scale with coordinate magnitude: each of the ~3 terms
            # per expression rounds at ~|coord| * 2^-24, so at max coordinate M
            # the two orderings can disagree by up to ~8 * eps * M (~2e-3 at
            # M=2048).  The exact test still runs on every candidate, so a wide
            # slack costs a few extra candidates and can never add voxels.
            slack = F(1e-3) + F(8.0) * np.float32(np.finfo(np.float32).eps) \
                * F(max(dims))
            dist_q = nd * (cdp.astype(F) + F(0.5)) - q
            pre = ((cdp >= mini_d[tri_of]) & (cdp <= maxi_d[tri_of])
                   & (np.abs(dist_q) <= F(0.5) + slack))
            cidx = np.nonzero(pre)[0]
            if cidx.size == 0:
                continue
            tri_of = tri_of[cidx]
            coords = np.empty((cidx.size, 3), np.int64)
            coords[:, uax] = cu[cidx]
            coords[:, vax] = cv[cidx]
            coords[:, dax] = cdp[cidx]
            cx, cy, cz = coords[:, 0], coords[:, 1], coords[:, 2]

            center = coords.astype(F) + F(0.5)
            an, bn, cn = ad[tri_of], bd[tri_of], cd[tri_of]
            nrm = normal[tri_of]
            # exact reference plane test (same fp op order as VoxelizerHelper
            # .cs:77-81: full 3-D dot on the candidate center)
            dist = np.sum((center - an) * nrm, axis=-1, dtype=F)
            keep = np.abs(dist) <= F(0.5)

            p = center - nrm * dist[:, None]
            p0 = bn - an
            p1 = cn - an
            p2 = p - an
            d00 = np.sum(p0 * p0, axis=-1, dtype=F)
            d01 = np.sum(p0 * p1, axis=-1, dtype=F)
            d11 = np.sum(p1 * p1, axis=-1, dtype=F)
            d20 = np.sum(p2 * p0, axis=-1, dtype=F)
            d21 = np.sum(p2 * p1, axis=-1, dtype=F)
            with np.errstate(divide="ignore", invalid="ignore"):
                denom = F(1.0) / (d00 * d11 - d01 * d01)
            bv = (d11 * d20 - d01 * d21) * denom
            bw = (d00 * d21 - d01 * d20) * denom
            bu = F(1.0) - bv - bw
            bary = np.stack([bu, bv, bw], axis=-1)
            with np.errstate(invalid="ignore"):
                keep &= ~np.any((bary < 0) | (bary > 1), axis=-1)
            keep &= ~np.isnan(bary).any(axis=-1)

            if not np.any(keep):
                continue
            tri_k = tri_of[keep]
            bary_k = bary[keep].astype(F)
            colors3 = tcolors[tri_k]  # (k, 3 verts, 4)
            # explicit sequential blend (NOT einsum) so the device path can
            # reproduce the float op order bit-for-bit
            col = (bary_k[:, 0:1] * colors3[:, 0, :3]
                   + bary_k[:, 1:2] * colors3[:, 1, :3]
                   + bary_k[:, 2:3] * colors3[:, 2, :3]).astype(F)

            mats = tmat[tri_k]
            alpha_keep = np.ones(tri_k.shape[0], bool)
            if mesh.materials and np.any(mats >= 0):
                uvs3 = tuvs[tri_k]
                uv = (bary_k[:, 0:1] * uvs3[:, 0]
                      + bary_k[:, 1:2] * uvs3[:, 1]
                      + bary_k[:, 2:3] * uvs3[:, 2]).astype(F)
                for mi, mat in enumerate(mesh.materials):
                    m = mats == mi
                    if not np.any(m) or mat.diffuse is None:
                        continue
                    albedo = mat.sample_diffuse(uv[m])
                    alpha_keep[m] = albedo[:, 3] >= 1.0
                    col[m] = col[m] * albedo[:, :3]

            col = col[alpha_keep]
            tri_k = tri_k[alpha_keep]
            idx = np.nonzero(keep)[0][alpha_keep]

            byte_col = np.clip(np.round(col * F(255.0)), 0, 255).astype(np.uint8)
            out_xz.append(cx[idx] * dims[2] + cz[idx])
            out_y.append(cy[idx])
            out_r.append(byte_col[:, 0])
            out_g.append(byte_col[:, 1])
            out_b.append(byte_col[:, 2])

    if not out_xz:
        z = np.zeros(0, np.int64)
        u = np.zeros(0, np.uint8)
        return z, z.copy(), (u, u.copy(), u.copy())
    return (
        np.concatenate(out_xz),
        np.concatenate(out_y),
        (np.concatenate(out_r), np.concatenate(out_g), np.concatenate(out_b)),
    )


# ------------------------------------------------------------ the device path
#
# The per-candidate math of ``voxelize_mesh`` in torch, on the card or the CPU.
# Eager torch rounds every operation on its own (no contraction of a*b + c
# into an FMA), its f32 ``/`` between tensors is correctly rounded on both
# devices, and ``torch.round`` rounds half to even like ``np.round``, so each
# expression below is written in numpy's order and gives numpy's bits.

# meshes voxelized on a torch device (their triangle tables built), and
# textured meshes that voxelize_mesh_device handed to the numpy path
device_calls = 0
host_calls = 0


def textured(mesh: SimpleMesh) -> bool:
    """Whether a triangle of the mesh has a material: the device path hands
    such a mesh to ``voxelize_mesh`` (texture sampling stays on the host)."""
    return bool(mesh.materials) and bool(np.any(mesh.material_index >= 0))


def triangle_tables(mesh: SimpleMesh, dims, device) -> dict:
    """The per-triangle tables of the device path, on ``device``, for the
    triangles that make candidates, ordered by dominant axis and, within an
    axis, by triangle: the order of numpy's per-axis loop.  ``off`` and
    ``csum`` are each triangle's first candidate and the inclusive
    cumulative candidate count; ``total`` the candidates in all.  Counted in
    ``device_calls``."""
    global device_calls
    device_calls += 1
    pr = _prepare_triangles(mesh, dims)
    counts = pr["counts"]
    sel = np.nonzero(pr["valid_tri"] & (counts > 0))[0]
    sel = sel[np.argsort(pr["d_ax"][sel], kind="stable")]
    ax = pr["d_ax"][sel]
    uax, vax = (ax + 1) % 3, (ax + 2) % 3
    normal, mini, maxi = pr["normal"], pr["mini"], pr["maxi"]
    csum = np.cumsum(counts[sel])
    tab = dict(
        # f32: the normal's (u, v, d) components and the plane offset, the
        # dilated vertices, the normal and the vertex colors (vertex, rgb)
        nu=normal[sel, uax], nv=normal[sel, vax], nd=normal[sel, ax],
        po=pr["plane_off"][sel], a=pr["ad"][sel], b=pr["bd"][sel],
        c=pr["cd"][sel], n=normal[sel], col=pr["tcolors"][sel, :, :3],
        # int64: the candidate box in (u, v, d), the v span, the axis
        mini_u=mini[sel, uax], mini_v=mini[sel, vax], mini_d=mini[sel, ax],
        maxi_d=maxi[sel, ax], sv=pr["sv"][sel], dax=ax,
        off=csum - counts[sel], csum=csum)
    out = {k: torch.from_numpy(np.ascontiguousarray(
        v, np.float32 if v.dtype.kind == "f" else np.int64)).to(device)
        for k, v in tab.items()}
    out["total"] = int(csum[-1]) if csum.size else 0
    return out


def _triangle_of(csum: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The triangle of each candidate index: the first triangle whose
    inclusive candidate count exceeds it (a triangle of count 0 owns none)."""
    return torch.searchsorted(csum, idx, right=True)


def _sum3(x, y, z):
    """A 3-term f32 sum in numpy's order: (x + y) + z."""
    return (x + y) + z


def _window(tab: dict, base: int, n: int, z_dim: int, thr: float):
    """Candidates [base, base + n) of the tables' order: the kept voxels'
    (xz, y, r | g << 8 | b << 16), int64, in candidate order.  ``thr`` is the
    prefilter's bound on the plane distance, 0.5 plus its slack."""
    f32 = torch.float32
    idx = torch.arange(base, base + n, dtype=torch.int64,
                       device=tab["csum"].device)
    t = _triangle_of(tab["csum"], idx)
    within = idx - tab["off"][t]
    jd = within & (DW - 1)
    rest = within >> 2
    sv = tab["sv"][t]
    iu = torch.div(rest, sv, rounding_mode="floor")
    iv = rest - iu * sv
    cu = tab["mini_u"][t] + iu
    cv = tab["mini_v"][t] + iv
    nu, nv, nd = tab["nu"][t], tab["nv"][t], tab["nd"][t]
    # the 4-cell depth window around the plane, and the prefilter on it
    q = (tab["po"][t] - nu * (cu.to(f32) + 0.5)) - nv * (cv.to(f32) + 0.5)
    dc = q / nd
    half = torch.full_like(nd, 0.5) / nd.abs()
    dlo = torch.floor((dc - 0.5) - half)
    dlo = torch.where(torch.isfinite(dlo), dlo, 0.0).to(torch.int64)
    cdp = dlo + jd
    dist_q = nd * (cdp.to(f32) + 0.5) - q
    pre = ((cdp >= tab["mini_d"][t]) & (cdp <= tab["maxi_d"][t])
           & (dist_q.abs() <= thr))
    k = torch.nonzero(pre).squeeze(1)
    t, cu, cv, cdp = t[k], cu[k], cv[k], cdp[k]

    # world coordinates from the dominant axis: dax 0 -> (u, v) = (y, z),
    # 1 -> (z, x), 2 -> (x, y)
    dax = tab["dax"][t]
    cs = (torch.where(dax == 0, cdp, torch.where(dax == 1, cv, cu)),
          torch.where(dax == 0, cu, torch.where(dax == 1, cdp, cv)),
          torch.where(dax == 0, cv, torch.where(dax == 1, cu, cdp)))
    cf = [c.to(f32) + 0.5 for c in cs]
    an, bn, cn, nrm = (tab[k_][t].unbind(1) for k_ in ("a", "b", "c", "n"))
    # the exact plane test (VoxelizerHelper.cs:77-81) on the full 3-D center
    dist = _sum3(*[(cf[j] - an[j]) * nrm[j] for j in range(3)])
    keep = dist.abs() <= 0.5
    p = [cf[j] - nrm[j] * dist for j in range(3)]
    p0 = [bn[j] - an[j] for j in range(3)]
    p1 = [cn[j] - an[j] for j in range(3)]
    p2 = [p[j] - an[j] for j in range(3)]

    def dot3(x, y):
        return _sum3(x[0] * y[0], x[1] * y[1], x[2] * y[2])

    d00, d01, d11 = dot3(p0, p0), dot3(p0, p1), dot3(p1, p1)
    d20, d21 = dot3(p2, p0), dot3(p2, p1)
    # a correctly rounded f32 divide, as numpy's: it decides keep or drop at
    # the triangle's edges
    denom = torch.ones_like(d00) / (d00 * d11 - d01 * d01)
    bv = (d11 * d20 - d01 * d21) * denom
    bw = (d00 * d21 - d01 * d20) * denom
    bu = (1.0 - bv) - bw
    for w in (bu, bv, bw):
        keep &= ~((w < 0) | (w > 1)) & ~torch.isnan(w)
    k = torch.nonzero(keep).squeeze(1)
    t, bu, bv, bw = t[k], bu[k, None], bv[k, None], bw[k, None]
    col = tab["col"][t]  # (k, vertex, rgb)
    col = (bu * col[:, 0] + bv * col[:, 1]) + bw * col[:, 2]
    byte = torch.round(col * 255.0).clamp(0, 255).to(torch.int64)
    rgbp = byte[:, 0] | (byte[:, 1] << 8) | (byte[:, 2] << 16)
    return cs[0][k] * z_dim + cs[2][k], cs[1][k], rgbp


def voxelize_tables(tab: dict, dims, chunk_candidates: int):
    """The soup of the tables' triangles, ``chunk_candidates`` candidates a
    window: (xz, y, rgbp) int64 on the tables' device."""
    thr = float(F(0.5) + (F(1e-3) + F(8.0) * np.finfo(np.float32).eps
                          * F(max(dims))))
    parts = [_window(tab, base, min(chunk_candidates, tab["total"] - base),
                     int(dims[2]), thr)
             for base in range(0, tab["total"], chunk_candidates)]
    if not parts:
        z = torch.zeros(0, dtype=torch.int64, device=tab["csum"].device)
        return z, z.clone(), z.clone()
    return tuple(torch.cat(p) for p in zip(*parts))


def voxelize_mesh_device(mesh: SimpleMesh, dims: tuple[int, int, int],
                         chunk_candidates: int = 8_000_000, device="cuda",
                         return_device: bool = False,
                         on_stage=lambda name, note: None):
    """The voxelizer in torch on ``device``: output-identical to
    ``voxelize_mesh``, the same voxels in the same order.

    The host keeps the per-triangle tables (``_prepare_triangles``); every
    candidate's math runs on the device, ``chunk_candidates`` candidates a
    window.  A mesh with a material (``textured``) goes to ``voxelize_mesh``
    on the host, as in the reference (texture sampling stays there): the
    module counts the meshes of each kind in ``device_calls`` and
    ``host_calls``.

    Returns ``voxelize_mesh``'s numpy tuple, or with ``return_device``
    (xz, y, rgbp, valid) tensors on ``device``: int64 coordinates, the
    channels packed r | g << 8 | b << 16, and an all-true mask (the soup has
    its exact size), the arguments of
    ``world.rle_device.build_lod_chain_device``.  ``on_stage(name, note)``
    is called as each stage ends: ``"tables"`` (device path only), then
    ``"voxelize"``.
    """
    global host_calls
    if textured(mesh):
        host_calls += 1
        xz, y, (r, g, b) = voxelize_mesh(mesh, dims)
        if not return_device:
            return xz, y, (r, g, b)
        rgbp = (r.astype(np.int64) | (g.astype(np.int64) << 8)
                | (b.astype(np.int64) << 16))
        xz, y, rgbp = (torch.from_numpy(a).to(device) for a in (xz, y, rgbp))
    else:
        tab = triangle_tables(mesh, dims, torch.device(device))
        on_stage("tables", f"{tab['total']} candidates on {device}")
        xz, y, rgbp = voxelize_tables(tab, dims, chunk_candidates)
        del tab
    on_stage("voxelize", f"{xz.shape[0]} voxel samples")
    if return_device:
        return xz, y, rgbp, torch.ones(xz.shape[0], dtype=torch.bool,
                                       device=xz.device)
    rgb = rgbp.cpu().numpy()
    return (xz.cpu().numpy(), y.cpu().numpy(),
            tuple(((rgb >> s) & 0xFF).astype(np.uint8) for s in (0, 8, 16)))
