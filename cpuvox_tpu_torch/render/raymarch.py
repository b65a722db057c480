"""Phase-1 ray march in plain PyTorch: the port's twin of the XLA reference.

Counterpart of ``cpuvox_tpu/render/raymarch.py`` (dense branch).  Every
function keeps the reference's float operation order, so on the same inputs
it gives the same bits; the CUDA kernels in ``cpuvox_tpu_torch.ops`` are held
against these functions.  Semantics are the oracle's (DrawSegmentRayJob.cs
ExecuteRay, re-expressed data-parallel over all rays):

- the per-ray ``while(true)`` march becomes a loop over chunks: each chunk
  rolls the content-independent DDA ``chunk`` cells per ray, fetches the
  visited columns' records, then rasterizes the cells in order (on the card
  the fetch is inside the rasterize kernel: ``march_ops``).  An iteration
  is a function of the loop's state (``MarchState``; ``march_step``,
  ``gated_step``) that reads nothing on the host; the loop's condition,
  ``count(alive) > threshold & (i < max_chunks)``, is ``loop_control``.
  A CUDA Renderer with the kernels runs the loop as one CUDA graph launch
  (``render/march_graph.py``), compacted or not; the host drives it
  (``march_on_host``, one read of the live count an iteration) on the CPU,
  with the plain versions and on the ray-sharded path;
- ``return``/``break`` early-outs become per-ray ``alive`` masks;
- the raybuffer holds int32 color indices into ``WorldArrays.colors``
  (skybox = 0, unwritten = -1), resolved to ARGB once per frame; in ARGB
  mode (``WorldArrays.max_col_colors`` > 0) the column's colors ride in its
  record and the raybuffer holds final colors with bit 31 cleared until the
  deferred skybox fill restores it.

Where torch and XLA differ on the same expression, the port follows XLA:

- f32 -> i32 casts saturate (``to_i32``), as XLA's convert does;
- ``torch.round`` rounds half to even, like ``jnp.round``;
- min/max go through ``_min``/``_max``, which pass a NaN operand through as
  XLA does (torch's ``amin``/``amax`` return a canonical NaN instead, a
  different bit pattern);
- nothing uses ``torch.lerp``/``addcmul``: each ``a + (b - a) * t`` is written
  out so every product and sum is rounded on its own.

Two marches share the roll and the rasterizer: the dense one (``march``)
fetches and rasterizes every visited cell; the occupancy-gated one
(``march_gated``, ``raymarch.py:1228-1580``) first reads one occupancy-tile
row per tile a ray crosses and rasterizes only the cells that may draw.

Both compact the live rays in this card's form of the reference's staged
compaction (``raymarch.py:1010-1024``, ``:1085-1092``, ``:1593-1605``):
the raybuffer and all per-ray state stay in place at full width R, and the
roll, the gate and the rasterizer work on a live-ray index (int32 (Rk,)),
so no state is sorted and nothing is banked; only the index is rebuilt.
In a march graph the widths halve on a fixed schedule (``stage_widths``):
a stage loops while more rays live than the next width holds, then
``stage_index`` packs the live rays into the next width's index (JAX's
stable sort, word for word).  The host loop (``live_rays``) rebuilds an
ascending index of exactly the live rays whenever the count has fallen to
half of Rk or less.  Either way a ray that is dead in the index changes
nothing, and the raybuffer is the uncompacted march's.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cpuvox_tpu_torch.render import device as world_device
from cpuvox_tpu_torch.utils import profiling

BIG = 1 << 24
I32_MIN = -(1 << 31)
I32_MAX = (1 << 31) - 1
NVF = 13  # visit fields per DDA step (order in ops/roll_kernel.py)
GATE_EPS = np.float32(1e-5)  # the occupancy gate's relative window margin
MAGENTA_I32 = int(np.uint32(0xFFFF1493).view(np.int32))  # unwritten texels


class RayStatic(NamedTuple):
    """Per-ray constants (host-built)."""

    dirs: torch.Tensor  # (R, 2) f32 normalized XZ dir
    plane_bottom: torch.Tensor  # (R, 3) f32 projected column base
    plane_top: torch.Tensor  # (R, 3) f32
    plane_dir: torch.Tensor  # (R, 3) f32
    orig_min: torch.Tensor  # (R,) i32 segment pixel range
    orig_max: torch.Tensor  # (R,) i32


class DDAState(NamedTuple):
    pos: torch.Tensor  # (R, 2) i32
    tmax: torch.Tensor  # (R, 2) f32
    tdelta: torch.Tensor  # (R, 2) f32
    stp: torch.Tensor  # (R, 2) i32
    ids: torch.Tensor  # (R, 2) f32 intersection distances (last, next)
    lod: torch.Tensor  # (R,) i32


class RasterState(NamedTuple):
    raybuf: torch.Tensor  # (R, P) i32 color indices, -1 unwritten
    nfp_min: torch.Tensor  # (R,) i32
    nfp_max: torch.Tensor  # (R,) i32
    fb_min: torch.Tensor  # (R,) f32 frustum bounds
    fb_max: torch.Tensor  # (R,) f32
    f_active: torch.Tensor  # (R,) bool: frustum narrowing active
    fdir_min: torch.Tensor  # (R,) f32
    fdir_max: torch.Tensor  # (R,) f32
    alive: torch.Tensor  # (R,) bool


class WorldArrays(NamedTuple):
    """The device world: column records (inline, or split for columns of
    more than ``INLINE_MAX_RUNS`` runs) and the occupancy tiles."""

    col_base: torch.Tensor  # (8,) i32 first column of each LOD
    grid_z: torch.Tensor  # (8,) i32 columns per x-row of each LOD
    # inline layout, else None: (n_cols, RW) i32
    # [n_runs, color_off, cmin, cmax, runs..., (colors...)]
    rec_fwd: torch.Tensor | None
    rec_rev: torch.Tensor | None  # the same with each column's runs reversed
    colors: torch.Tensor  # (n_colors,) i32 view of uint32 ARGB, [0] = skybox
    max_runs: int
    occ_tiles: torch.Tensor  # (n_tiles, 8) i32 [4 bitmap words, cmin, cmax, pad]
    tile_base: torch.Tensor  # (8,) i32 first tile row of each LOD
    tile_gz: torch.Tensor  # (8,) i32 tiles per x-row of each LOD
    max_col_colors: int = 0  # > 0: ARGB mode, that many color words a record
    # split layout, else None: (n_cols, 8) i32 [n_runs, run_off, color_off,
    # cmin, cmax, pad] and the flat run arrays (tail-padded by max_runs)
    col_rec: torch.Tensor | None = None
    runs: torch.Tensor | None = None
    runs_rev: torch.Tensor | None = None
    # a world-sharded active world's tile window (``parallel/world_shard.py``)
    # as a (4,) int32 tensor [tx0, tz0, log2 of the tile side, W] (JAX's
    # ``win``), else None: LOD0 columns and occupancy rows remap through it
    # (``_cell_index``).  A tensor, so a window move of the same W is a copy
    # into a march graph's world buffers, not a new capture
    win: torch.Tensor | None = None


class CellFields(NamedTuple):
    """One chunk's visited cells, (C, R) each: the rasterizer's input."""

    ids: torch.Tensor  # (C, R, 2) f32
    lod: torch.Tensor  # (C, R) i32
    valid: torch.Tensor  # (C, R) bool
    n_runs: torch.Tensor  # (C, R) i32
    color_off: torch.Tensor  # (C, R) i32
    cmin: torch.Tensor  # (C, R) i32
    cmax: torch.Tensor  # (C, R) i32
    runs: torch.Tensor  # (C, R, max_runs) i32 [color index << 16 | length]
    # ARGB mode: (C, R, MCC) i32, the column's colors with bit 31 cleared
    colors: torch.Tensor | None = None


class PackedCells(NamedTuple):
    """A gated group's cells as the gate packs them, before any record is
    read: the rasterizer's input on the gated march."""

    rows: torch.Tensor  # (GK, R, 4) i32 [column index, ids0, ids1 (f32
    # bits), lod]
    proc: torch.Tensor  # (GK, R) bool: the ray's gated cell, else a no-op


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> i32 as XLA converts: truncate toward zero and saturate.

    torch on the CPU maps every out-of-range value and NaN to INT32_MIN; XLA
    maps +huge/+inf to INT32_MAX, -huge/-inf to INT32_MIN and NaN to 0.
    (2**31 is exact in f32; every f32 below it converts exactly.)
    """
    hi = x >= 2147483648.0
    lo = x < -2147483648.0
    bad = hi | lo | torch.isnan(x)
    out = torch.where(bad, torch.zeros_like(x), x).to(torch.int32)
    out = torch.where(hi, I32_MAX, out)
    return torch.where(lo, I32_MIN, out)


def _min(a, b):
    """NaN-propagating minimum that returns the NaN operand itself (its bits),
    as XLA's minimum and the kernels' ``cpuvox::min_nan`` do."""
    return torch.where(torch.isnan(a), a,
                       torch.where(torch.isnan(b), b, torch.where(b < a, b, a)))


def _max(a, b):
    """NaN-propagating maximum; see ``_min``."""
    return torch.where(torch.isnan(a), a,
                       torch.where(torch.isnan(b), b, torch.where(a < b, b, a)))


def world_arrays(dw, device) -> WorldArrays:
    """The numpy ``DeviceWorld`` as the port's tensors (counterpart of
    ``cpuvox_tpu/render/raymarch.py:238``).  Colors stay int32 inside torch
    (uint32 arithmetic in torch is thin); they are viewed back as uint32 at
    the numpy boundary."""

    def put(x):
        if x is None:
            return None
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return WorldArrays(
        col_base=put(dw.col_base), grid_z=put(dw.grid_z),
        rec_fwd=put(dw.rec_fwd), rec_rev=put(dw.rec_rev),
        colors=put(dw.colors.view(np.int32)), max_runs=int(dw.max_runs),
        occ_tiles=put(dw.occ_tiles), tile_base=put(dw.tile_base),
        tile_gz=put(dw.tile_gz), max_col_colors=int(dw.max_col_colors),
        col_rec=put(dw.col_rec), runs=put(dw.runs), runs_rev=put(dw.runs_rev))


def _window_slot(win, xc, zc):
    """(slot, tile mask) of LOD0 cells in the window ``(tx0, tz0, tl, W)``
    (four ints, or a (4,) int32 tensor): the window-relative tile,
    row-major, and ``W * W`` (the all-empty sentinel tile) for a cell off
    the window."""
    tx0, tz0, tl, w = win
    txr = (xc >> tl) - tx0
    tzr = (zc >> tl) - tz0
    inw = (txr >= 0) & (txr < w) & (tzr >= 0) & (tzr < w)
    return torch.where(inw, txr * w + tzr, w * w), (1 << tl) - 1


def _cell_index(wa: WorldArrays, lodc, v_lod, xc, zc):
    """Column index of visited cells (``raymarch.py:100-122``):
    col_base[lod] + xc * grid_z[lod] + zc at the clamped ``lodc``.  In a
    world-sharded active world (``wa.win``) a cell whose raw ``v_lod`` is 0
    maps to its window slot's block, row-major within the tile, every cell
    computed whether valid or not."""
    ci = wa.col_base[lodc] + xc * wa.grid_z[lodc] + zc
    if wa.win is None:
        return ci
    slot, tmask = _window_slot(wa.win, xc, zc)
    tl = wa.win[2]
    ci0 = (slot << (2 * tl)) + ((xc & tmask) << tl) + (zc & tmask)
    return torch.where(v_lod == 0, ci0, ci)


def _occ_tile_index(wa: WorldArrays, lodc, v_lod, xc, zc):
    """Occupancy-tile row of visited cells, 16x8 column tiles
    (``raymarch.py:125-146``).  In a world-sharded active world a raw LOD0
    cell maps to its window slot's block of T^2/128 rows (the sentinel
    slot's rows are all zero: an empty tile)."""
    ti = wa.tile_base[lodc] + (xc >> 4) * wa.tile_gz[lodc] + (zc >> 3)
    if wa.win is None:
        return ti
    slot, tmask = _window_slot(wa.win, xc, zc)
    tl = wa.win[2]
    ti0 = (slot * (1 << (2 * tl - 7)) + ((xc & tmask) >> 4) * (1 << (tl - 3))
           + ((zc & tmask) >> 3))
    return torch.where(v_lod == 0, ti0, ti)


def _fetch_columns(wa: WorldArrays, ci, v_valid, iteration_direction: int):
    """Fetch the visited columns' meta + runs (``raymarch.py:158``):
    (n_runs, color_off, cmin, cmax, runs, colors), colors None outside ARGB
    mode.

    Inline records whose run region is 16-bit packed are unpacked to the
    int32 run format: the color index is an exclusive cumsum of solid lengths
    (forward); the reversed table keeps each run's forward index,
    total_solid - cum_before_rev - length.  The split layout (columns of more
    than ``INLINE_MAX_RUNS`` runs) fetches an 8-int meta row, then
    ``max_runs`` contiguous run words from ``run_off``, from the reversed
    array going up.
    """
    max_runs = wa.max_runs
    if wa.rec_fwd is None:
        rec = wa.col_rec.index_select(0, ci.reshape(-1).long())
        rec = rec.reshape(ci.shape + (rec.shape[-1],))
        n_runs = torch.where(v_valid, rec[..., 0], 0)
        runs_src = wa.runs if iteration_direction > 0 else wa.runs_rev
        k = torch.arange(max_runs, dtype=torch.int64, device=rec.device)
        runs = runs_src[rec[..., 1:2].long() + k]  # tail pad: never past the end
        return n_runs, rec[..., 2], rec[..., 3], rec[..., 4], runs, None
    mcc = wa.max_col_colors
    rec_src = wa.rec_fwd if iteration_direction > 0 else wa.rec_rev
    rec = rec_src.index_select(0, ci.reshape(-1).long())
    rec = rec.reshape(ci.shape + (rec.shape[-1],))
    n_runs = torch.where(v_valid, rec[..., 0], 0)
    color_off = rec[..., 1]
    cmin = rec[..., 2]
    cmax = rec[..., 3]
    meta = world_device.REC_META
    rwords = world_device.packed_run_words(max_runs, mcc)
    colors = rec[..., meta + rwords:meta + rwords + mcc] if mcc else None
    if rwords == max_runs:
        return (n_runs, color_off, cmin, cmax, rec[..., meta:meta + rwords],
                colors)
    words = rec[..., meta:meta + rwords]
    lo = words & 0xFFFF
    hi = (words >> 16) & 0xFFFF  # logical shift: the high half is unsigned
    halves = torch.stack([lo, hi], dim=-1).reshape(
        words.shape[:-1] + (2 * rwords,))[..., :max_runs]
    length = halves & 0x7FFF
    air = (halves & 0x8000) != 0
    solid_len = torch.where(air, 0, length)
    cum = torch.cumsum(solid_len, dim=-1, dtype=torch.int32)
    cum_excl = cum - solid_len
    if iteration_direction > 0:
        cidx = cum_excl
    else:
        cidx = cum[..., -1:] - cum_excl - length
    runs = torch.where(air, (-1 << 16) | length, (cidx << 16) | length)
    k = torch.arange(max_runs, dtype=torch.int32, device=rec.device)
    runs = torch.where(k < rec[..., 0:1], runs, 0)
    return n_runs, color_off, cmin, cmax, runs, colors


# ------------------------------------------------------------------ DDA roll


def _dda_step(dda: DDAState, far_clip):
    """SegmentDDAData.Step (:135-150), batched (``raymarch.py:419``).

    ``tmax + where(bump, tdelta, 0.0)`` maps -0.0 to +0.0 exactly as the
    reference does; ``where(bump, tmax + tdelta, tmax)`` would not."""
    x_first = dda.tmax[:, 0] < dda.tmax[:, 1]
    crossed = torch.where(x_first, dda.tmax[:, 0], dda.tmax[:, 1])
    bump = torch.stack([x_first, ~x_first], dim=1)
    tmax = dda.tmax + torch.where(bump, dda.tdelta, 0.0)
    pos = dda.pos + torch.where(bump, dda.stp, 0)
    ids = torch.stack([crossed, _min(tmax[:, 0], tmax[:, 1])], dim=1)
    hit_far = crossed >= far_clip
    return dda._replace(pos=pos, tmax=tmax, ids=ids), hit_far


def _dda_next_lod(dda: DDAState, dirs):
    """SegmentDDAData.NextLOD (:31-73), batched (``raymarch.py:431``).
    Axis-parallel rays give inf - inf = NaN here; _min/_max propagate it."""
    vsize = 1 << dda.lod
    rem = dda.pos & (2 * vsize - 1)[:, None]
    tmax_prev = dda.tmax - dda.tdelta
    low = rem < vsize[:, None]
    inc = (dirs >= 0) == low
    tmax = torch.where(inc, dda.tmax + dda.tdelta, dda.tmax)
    tmax_prev = torch.where(~inc, tmax_prev - dda.tdelta, tmax_prev)
    ids = torch.stack([_max(tmax_prev[:, 0], tmax_prev[:, 1]),
                       _min(tmax[:, 0], tmax[:, 1])], dim=1)
    return dda._replace(pos=dda.pos - rem, tmax=tmax, tdelta=dda.tdelta * 2.0,
                        stp=dda.stp * 2, ids=ids, lod=dda.lod + 1)


def _select(mask, new: DDAState, old: DDAState) -> DDAState:
    return DDAState(*(torch.where(mask.reshape((-1,) + (1,) * (a.dim() - 1)),
                                  b, a) for a, b in zip(old, new)))


def _take(x, index):
    """The rows of ``x`` a live-ray index names (all of them for None)."""
    return x if index is None else x.index_select(0, index)


def _put(full, index, part):
    """``full`` with the index's rows replaced by ``part`` (a new tensor)."""
    return part if index is None else full.index_copy(0, index, part)


def _or_rows(full, index, part):
    """``full`` (R,) with ``part`` or-ed into the index's rows."""
    return _put(full, None if index is None else index.long(),
                _take(full, index) | part)


def _roll_chunk(dda: DDAState, alive, dirs, lod_distances, far_clip, dims,
                chunk: int, index=None):
    """Advance every ray ``chunk`` cells and record each visit
    (``raymarch.py:445``): lod switch -> visit cell -> step, plus the
    out-of-world retire.  Returns (dda, alive, visits) with visits a
    (chunk, 13, R) int32 stack, f32 fields as their bits, in the order of
    ``ops/roll_kernel.py``: pos x/z, ids 0/1, lod, valid, then the
    pre-switch snapshot pos x/z, tmax x/z, ids 0/1, lod (the gated march's
    rewind anchor; the dense march reads only the first six).

    With a live-ray ``index`` (int32 (Rk,)) only those rays roll: the visits
    are (chunk, 13, Rk) and every other ray's state comes back untouched."""
    if index is not None:
        i = index.long()
        sub, sub_alive, vis = _roll_chunk(
            DDAState(*(_take(f, i) for f in dda)), _take(alive, i),
            _take(dirs, i), lod_distances, far_clip, dims, chunk)
        return (DDAState(*(_put(f, i, x) for f, x in zip(dda, sub))),
                _put(alive, i, sub_alive), vis)
    X, Z = dims[0], dims[2]
    R = dda.pos.shape[0]
    nld = lod_distances.shape[0]
    vis = torch.empty((chunk, NVF, R), dtype=torch.int32, device=dda.pos.device)
    for c in range(chunk):
        pre = (dda.pos, dda.tmax, dda.ids, dda.lod)
        ldist = lod_distances[dda.lod.clamp(0, nld - 1)]
        switch = alive & (dda.ids[:, 0] >= ldist)
        dda = _select(switch, _dda_next_lod(dda, dirs), dda)
        in_bounds = ((dda.pos[:, 0] >= 0) & (dda.pos[:, 0] < X)
                     & (dda.pos[:, 1] >= 0) & (dda.pos[:, 1] < Z))
        alive = alive & in_bounds
        v = vis[c]
        v[0], v[1] = dda.pos[:, 0], dda.pos[:, 1]
        v[2], v[3] = dda.ids[:, 0].view(torch.int32), dda.ids[:, 1].view(torch.int32)
        v[4], v[5] = dda.lod, alive.to(torch.int32)
        v[6], v[7] = pre[0][:, 0], pre[0][:, 1]
        v[8], v[9] = pre[1][:, 0].view(torch.int32), pre[1][:, 1].view(torch.int32)
        v[10], v[11] = pre[2][:, 0].view(torch.int32), pre[2][:, 1].view(torch.int32)
        v[12] = pre[3]
        stepped, hit_far = _dda_step(dda, far_clip)
        dda = _select(alive, stepped, dda)
        alive = alive & ~hit_far
    return dda, alive, vis


# ------------------------------------------------------------------ rasterize


def _next_unwritten_geq(seen, c):
    """First y >= c with seen[y] False, else BIG; (R, P) x (R,) -> (R,)."""
    pix = torch.arange(seen.shape[1], dtype=torch.int32, device=seen.device)
    cand = torch.where((~seen) & (pix[None, :] >= c[:, None]), pix[None, :], BIG)
    return cand.amin(1)


def _prev_unwritten_leq(seen, c):
    """Last y <= c with seen[y] False, else -BIG."""
    pix = torch.arange(seen.shape[1], dtype=torch.int32, device=seen.device)
    cand = torch.where((~seen) & (pix[None, :] <= c[:, None]), pix[None, :], -BIG)
    return cand.amax(1)


def _clip_world_bounds(p_min, p_max, fmin, fmax):
    """Batched CameraData.GetWorldBoundsClippingCamSpace (CameraData.cs:51-121).
    p_min/p_max: (R, 3); fmin/fmax: (R,).  Returns (clipped, min_lerp, max_lerp)."""

    def clip_pair(frustum):
        finv = 1.0 / frustum
        c0 = p_max[:, 0] * finv - p_max[:, 2]
        c1 = p_min[:, 0] * finv - p_min[:, 2]
        return 1.0 - (c0 / (c0 - c1)), c1 / (c1 - c0)

    min_at_fmax, max_at_fmax = clip_pair(fmax)
    min_at_fmin, max_at_fmin = clip_pair(fmin)

    amin = p_min[:, 0] > p_min[:, 2] * fmax  # min endpoint above the max frustum
    amax = p_max[:, 0] > p_max[:, 2] * fmax
    bmin = p_min[:, 0] < p_min[:, 2] * fmin  # below the min frustum
    bmax = p_max[:, 0] < p_max[:, 2] * fmin
    clipped = (amin & amax) | (~amin & ~amax & bmin & bmax)

    zero = torch.zeros_like(min_at_fmax)
    one = torch.ones_like(min_at_fmax)
    min_lerp = torch.where(
        amin, min_at_fmax,
        torch.where(amax, torch.where(bmin, min_at_fmin, zero),
                    torch.where(bmin & ~bmax, min_at_fmin, zero)))
    max_lerp = torch.where(
        amin, torch.where(bmax, max_at_fmin, one),
        torch.where(amax, max_at_fmax,
                    torch.where(~bmin & bmax, max_at_fmin, one)))
    return clipped, min_lerp, max_lerp


def _near_clip_line(a, b, u_a=None, u_b=None):
    """Batched CameraData.ClipHomogeneousCameraSpaceLine (:124-157).  The lerps
    are written out (``b + (a - b) * v``), never ``torch.lerp``."""
    a_behind = a[:, 1] <= 0.0
    b_behind = b[:, 1] <= 0.0
    visible = ~(a_behind & b_behind)
    v_a = (b[:, 1] / (b[:, 1] - a[:, 1]))[:, None]
    v_b = (a[:, 1] / (a[:, 1] - b[:, 1]))[:, None]
    clip_a = a_behind & ~b_behind
    clip_b = b_behind & ~a_behind
    a2 = torch.where(clip_a[:, None], b + (a - b) * v_a, a)
    b2 = torch.where(clip_b[:, None], a + (b - a) * v_b, b)
    if u_a is None:
        return visible, a2, b2
    u_a2 = torch.where(clip_a, u_b + (u_a - u_b) * v_a[:, 0], u_a)
    u_b2 = torch.where(clip_b, u_a + (u_b - u_a) * v_b[:, 0], u_b)
    return visible, a2, b2, u_a2, u_b2


def _reduce_pixel_horizon(rs: RasterState, rb_min, rb_max, mask):
    """Batched ReducePixelHorizon (DrawSegmentRayJob.cs:660-697) with the exact
    frontier scans.  Returns (rs', rb_min', rb_max')."""
    seen = rs.raybuf >= 0
    c1 = mask & (rb_min <= rs.nfp_min)
    rb_min2 = torch.where(c1, rs.nfp_min, rb_min)
    inner1 = c1 & (rb_max >= rs.nfp_min)
    new_min = _next_unwritten_geq(seen, rb_max + 1)
    nfp_min = torch.where(inner1, new_min, rs.nfp_min)
    fb_min = torch.where(inner1, new_min.float() - 0.501, rs.fb_min)

    c2 = mask & (rb_max >= rs.nfp_max)
    rb_max2 = torch.where(c2, rs.nfp_max, rb_max)
    inner2 = c2 & (rb_min2 <= rs.nfp_max)
    new_max = _prev_unwritten_leq(seen, rb_min2 - 1)
    nfp_max = torch.where(inner2, new_max, rs.nfp_max)
    fb_max = torch.where(inner2, new_max.float() + 0.501, rs.fb_max)
    return rs._replace(nfp_min=nfp_min, nfp_max=nfp_max, fb_min=fb_min,
                       fb_max=fb_max), rb_min2, rb_max2


def _write_span(rs: RasterState, rb_min, rb_max, values, mask):
    """Masked span write into unwritten pixels of [rb_min, rb_max] of rows in
    ``mask``.  Rows that wrote drop frustum narrowing (:522,598).  Returns
    (rs', killed), killed = rows whose free range closed (:535-539)."""
    pix = torch.arange(rs.raybuf.shape[1], dtype=torch.int32,
                       device=rs.raybuf.device)[None, :]
    in_span = (pix >= rb_min[:, None]) & (pix <= rb_max[:, None]) & mask[:, None]
    do_write = in_span & (rs.raybuf < 0)
    raybuf = torch.where(do_write, values, rs.raybuf)
    wrote = do_write.any(1)
    killed = mask & (rs.nfp_min > rs.nfp_max)
    return rs._replace(raybuf=raybuf, f_active=rs.f_active & ~wrote), killed


def _rasterize_step(rs: RasterState, cell, static: RayStatic, consts,
                    iteration_direction: int, max_runs: int) -> RasterState:
    """Process one visited cell for every ray (the body of ExecuteRay:245-611;
    ``raymarch.py:661``).  ``cell`` = (ids (R, 2), lod, valid, n_runs,
    color_off, cmin, cmax, runs (R, max_runs)).

    A cell whose ``valid`` is False leaves the ray's state exactly as it was,
    as in the Pallas kernel (``phase1_kernel.py:203``): the gated march hands
    the rasterizer groups whose tail cells are not the ray's.  (The XLA twin
    clears ``alive`` there instead; a ray reaches an invalid visit on the
    dense march only once the roll has retired it, so the raybuffer is the
    same either way.)

    In ARGB mode ``cell`` ends with the column's colors (R, MCC) and the
    value written is the color itself (bit 31 cleared), looked up by its
    index local to the column (``phase1_kernel.py:462-473``, ``:556-566``);
    an index outside the record's MCC words gives 0, as the reference's
    select chain does."""
    ids, lod, valid, n_runs, color_off, cmin, cmax, runs_k, colors = cell
    world_max_y = consts["world_max_y"]
    cam_y = consts["cam_y"]  # () or (R,): a camera height a ray
    cam_y_norm = consts["cam_y_norm"]

    alive = rs.alive & valid

    # ---- frustum-vs-column cull (:258-281); empty columns skip it
    nonempty = n_runs > 0
    dist_top = torch.where(rs.fdir_max > 0.0, ids[:, 1], ids[:, 0])
    dist_bot = torch.where(rs.fdir_min < 0.0, ids[:, 1], ids[:, 0])
    new_max = cam_y + rs.fdir_max * dist_top
    new_min = cam_y + rs.fdir_min * dist_bot
    f_act = rs.f_active
    cull_world = alive & nonempty & f_act & ((new_min > world_max_y)
                                             | (new_max < 0.0))
    alive = alive & ~cull_world
    if consts.get("solid_max_y") is not None:
        # solid-bound kill (output-exact; see the reference's comment)
        kill_solid = alive & f_act & (
            ((rs.fdir_min >= 0.0) & (new_min > consts["solid_max_y"]))
            | ((rs.fdir_max <= 0.0) & (new_max < consts["solid_min_y"])))
        alive = alive & ~kill_solid
    skip_col = f_act & ((cmin.float() > new_max) | (cmax.float() < new_min))
    wb_min = torch.where(f_act, new_min, 0.0)
    wb_max = torch.where(f_act, new_max, world_max_y)
    process = alive & ~skip_col & (n_runs > 0)

    # ---- project the world column at both intersections (:289-293)
    cs_min_last = static.plane_bottom + static.plane_dir * ids[:, 0:1]
    cs_min_next = static.plane_bottom + static.plane_dir * ids[:, 1:2]
    cs_max_last = static.plane_top + static.plane_dir * ids[:, 0:1]
    cs_max_next = static.plane_top + static.plane_dir * ids[:, 1:2]

    # ---- writable-frustum re-clip when dirty (:295-422)
    do_clip = process & (ids[:, 0] > 2.0) & ~f_act
    cl_clipped, cl_min, cl_max = _clip_world_bounds(
        cs_min_last, cs_max_last, rs.fb_min, rs.fb_max)
    cn_clipped, cn_min, cn_max = _clip_world_bounds(
        cs_min_next, cs_max_next, rs.fb_min, rs.fb_max)

    kill_clip = do_clip & cl_clipped & cn_clipped
    alive = alive & ~kill_clip
    process = process & ~kill_clip
    do_clip = do_clip & ~kill_clip

    case_l = cl_clipped
    case_n = ~cl_clipped & cn_clipped
    sel_min_lerp = torch.where(case_l, cn_min, torch.where(
        case_n, cl_min, _min(cl_min, cn_min)))
    sel_max_lerp = torch.where(case_l, cn_max, torch.where(
        case_n, cl_max, _max(cl_max, cn_max)))
    wbc_min = world_max_y * sel_min_lerp  # lerp(0, maxY, t)
    wbc_max = world_max_y * sel_max_lerp
    dist_for_min = torch.where(case_l, ids[:, 1], torch.where(
        case_n, ids[:, 0], torch.where(cl_min < cn_min, ids[:, 0], ids[:, 1])))
    dist_for_max = torch.where(case_l, ids[:, 1], torch.where(
        case_n, ids[:, 0], torch.where(cl_max > cn_max, ids[:, 0], ids[:, 1])))
    fdir_min_new = (wbc_min - cam_y) / dist_for_min
    fdir_max_new = (wbc_max - cam_y) / dist_for_max

    def screen_x(base_min, base_max, t):
        p = base_min + (base_max - base_min) * t[:, None]
        return p[:, 0] / p[:, 2]

    l_min_x = screen_x(cs_min_last, cs_max_last, cl_min)
    l_max_x = screen_x(cs_min_last, cs_max_last, cl_max)
    n_min_x = screen_x(cs_min_next, cs_max_next, cn_min)
    n_max_x = screen_x(cs_min_next, cs_max_next, cn_max)
    l_lo = _min(l_min_x, l_max_x)
    l_hi = _max(l_min_x, l_max_x)
    n_lo = _min(n_min_x, n_max_x)
    n_hi = _max(n_min_x, n_max_x)
    cs_clip_min = torch.where(case_l, n_lo, torch.where(
        case_n, l_lo, _min(l_lo, n_lo)))
    cs_clip_max = torch.where(case_l, n_hi, torch.where(
        case_n, l_hi, _max(l_hi, n_hi)))

    wb_min = torch.where(do_clip, torch.floor(wbc_min), wb_min)
    wb_max = torch.where(do_clip, torch.ceil(wbc_max), wb_max)
    fdir_min_st = torch.where(do_clip, fdir_min_new, rs.fdir_min)
    fdir_max_st = torch.where(do_clip, fdir_max_new, rs.fdir_max)
    f_active_new = rs.f_active | do_clip

    writable_min = to_i32(torch.floor(cs_clip_min))
    writable_max = to_i32(torch.ceil(cs_clip_max))
    kill_miss = do_clip & ((writable_max < rs.nfp_min)
                           | (writable_min > rs.nfp_max))
    alive = alive & ~kill_miss
    process = process & ~kill_miss
    do_clip = do_clip & ~kill_miss

    seen = rs.raybuf >= 0
    adv_min = do_clip & (writable_min > rs.nfp_min)
    nfp_min2 = torch.where(adv_min, _next_unwritten_geq(seen, writable_min),
                           rs.nfp_min)
    adv_max = do_clip & (writable_max < rs.nfp_max)
    nfp_max2 = torch.where(adv_max, _prev_unwritten_leq(seen, writable_max),
                           rs.nfp_max)
    kill_closed = do_clip & (nfp_min2 > nfp_max2)
    alive = alive & ~kill_closed
    process = process & ~kill_closed

    rs = rs._replace(nfp_min=nfp_min2, nfp_max=nfp_max2,
                     fdir_min=fdir_min_st, fdir_max=fdir_max_st,
                     f_active=f_active_new,
                     alive=torch.where(valid, alive, rs.alive))

    # ---- RLE run iteration (:424-611); runs arrive ordered for the direction
    if iteration_direction > 0:
        eb_min = torch.full_like(wb_min, float(world_max_y))
        eb_max = eb_min
    else:
        eb_min = torch.zeros_like(wb_min)
        eb_max = torch.zeros_like(wb_min)
    run_done = torch.zeros_like(process)
    P = rs.raybuf.shape[1]
    pixf = torch.arange(P, dtype=torch.float32, device=rs.raybuf.device)[None, :]

    for k in range(max_runs):
        run = runs_k[:, k]
        length = run & 0xFFFF
        cidx = run >> 16  # arithmetic: air runs are negative
        is_air = run < 0
        k_valid = process & rs.alive & (k < n_runs) & ~run_done

        len_scaled = (length * (1 << lod)).float()
        if iteration_direction > 0:
            eb_max_n = eb_min
            eb_min_n = eb_min - len_scaled
        else:
            eb_min_n = eb_max
            eb_max_n = eb_min_n + len_scaled
        eb_min = torch.where(k_valid, eb_min_n, eb_min)
        eb_max = torch.where(k_valid, eb_max_n, eb_max)

        above = eb_min > wb_max
        below = eb_max < wb_min
        brk = k_valid & ~is_air & (below if iteration_direction > 0 else above)
        run_done = run_done | brk
        draw = k_valid & ~is_air & ~above & ~below

        # lerp the projected full-world lines per run (:477-481)
        portion_bottom = eb_min / world_max_y  # a real divide, as JAX writes it
        portion_top = eb_max / world_max_y
        cs_front_bottom = cs_min_last + (cs_max_last - cs_min_last) \
            * portion_bottom[:, None]
        cs_front_top = cs_min_last + (cs_max_last - cs_min_last) \
            * portion_top[:, None]

        # --- side span (:484-542)
        u_a0 = length.float()
        vis, fa, fb_, u_a, u_b = _near_clip_line(
            cs_front_bottom, cs_front_top, u_a0, torch.zeros_like(u_a0))
        side = draw & vis
        uv_a = torch.stack([torch.ones_like(u_a), u_a], dim=1) / fa[:, 2:3]
        uv_b = torch.stack([torch.ones_like(u_b), u_b], dim=1) / fb_[:, 2:3]
        rbf_a = fa[:, 0] / fa[:, 2]
        rbf_b = fb_[:, 0] / fb_[:, 2]
        flip = rbf_a > rbf_b
        rbf_lo = torch.where(flip, rbf_b, rbf_a)
        rbf_hi = torch.where(flip, rbf_a, rbf_b)
        uv_lo = torch.where(flip[:, None], uv_b, uv_a)
        uv_hi = torch.where(flip[:, None], uv_a, uv_b)
        rb_min = to_i32(torch.round(rbf_lo))
        rb_max = to_i32(torch.round(rbf_hi))
        overlap = side & (rb_max >= rs.nfp_min) & (rb_min <= rs.nfp_max)
        rs, rb_min2, rb_max2 = _reduce_pixel_horizon(rs, rb_min, rb_max, overlap)
        # per-pixel perspective-correct color index (:519-533)
        l = (pixf - rbf_lo[:, None]) / (rbf_hi - rbf_lo)[:, None]
        wu0 = uv_lo[:, 0:1] + (uv_hi[:, 0:1] - uv_lo[:, 0:1]) * l
        wu1 = uv_lo[:, 1:2] + (uv_hi[:, 1:2] - uv_lo[:, 1:2]) * l
        u = wu1 / wu0
        iu = torch.where(torch.isnan(u), 0, to_i32(torch.floor(u)))
        color_local = torch.minimum(torch.clamp(iu, min=0),
                                    (length - 1)[:, None]) + cidx[:, None]
        if colors is None:
            values = color_off[:, None] + color_local
        else:
            values = _inline_color(colors, color_local)
        rs, killed = _write_span(rs, rb_min2, rb_max2, values, overlap)
        rs = rs._replace(alive=rs.alive & ~killed)

        # --- top/bottom cap (:544-610)
        live = draw & rs.alive
        top_cap = portion_top < cam_y_norm
        bot_cap = ~top_cap & (portion_bottom > cam_y_norm)
        skip_top = top_cap & (eb_max > wb_max)
        skip_bot = bot_cap & (eb_min < wb_min)
        cap = live & ((top_cap & ~skip_top) | (bot_cap & ~skip_bot))
        sec_color_idx = torch.where(top_cap, cidx, cidx + length - 1)
        portion_cap = torch.where(top_cap, portion_top, portion_bottom)
        cs_sec_a = cs_min_next + (cs_max_next - cs_min_next) * portion_cap[:, None]
        cs_sec_b = torch.where(top_cap[:, None], cs_front_top, cs_front_bottom)
        vis2, sa, sb = _near_clip_line(cs_sec_a, cs_sec_b)
        cap = cap & vis2
        r2a = torch.round(sa[:, 0] / sa[:, 2])
        r2b = torch.round(sb[:, 0] / sb[:, 2])
        rb2_min = to_i32(_min(r2a, r2b))
        rb2_max = to_i32(_max(r2a, r2b))
        overlap2 = cap & (rb2_max >= rs.nfp_min) & (rb2_min <= rs.nfp_max)
        rs, rb2_min2, rb2_max2 = _reduce_pixel_horizon(rs, rb2_min, rb2_max,
                                                       overlap2)
        if colors is None:
            cap_values = (color_off + sec_color_idx)[:, None]
        else:
            cap_values = _inline_color(colors, sec_color_idx[:, None])
        rs, killed2 = _write_span(rs, rb2_min2, rb2_max2, cap_values, overlap2)
        rs = rs._replace(alive=rs.alive & ~killed2)
    return rs


def _inline_color(colors, local):
    """colors[r, local[r, j]] for (R, MCC) inline colors and (R, J) column-
    local color indices; 0 where the index is outside the MCC words."""
    mcc = colors.shape[1]
    vals = torch.gather(colors, 1, local.clamp(0, mcc - 1).long())
    return torch.where((local >= 0) & (local < mcc), vals, 0)


def rasterize_cells(rs: RasterState, cells: CellFields, static: RayStatic,
                    consts, iteration_direction: int,
                    index=None) -> RasterState:
    """``_rasterize_step`` over a chunk's C cells in visit order.  With a
    live-ray ``index`` (int32 (Rk,)) the cells are (C, Rk) and belong to
    those rays; every other ray's row and state come back untouched."""
    if index is not None:
        i = index.long()
        sub = rasterize_cells(
            RasterState(*(_take(f, i) for f in rs)), cells,
            RayStatic(*(_take(f, i) for f in static)), take_consts(consts, i),
            iteration_direction)
        return RasterState(*(_put(f, i, x) for f, x in zip(rs, sub)))
    max_runs = cells.runs.shape[-1]
    for c in range(cells.lod.shape[0]):
        cell = tuple(None if f is None else f[c] for f in cells)
        rs = _rasterize_step(rs, cell, static, consts, iteration_direction,
                             max_runs)
    return rs


def raster_consts(world_max_y, cam_y, solid_min_y=None, solid_max_y=None,
                  device=None):
    """Constants of the rasterizer and the gate: f32 0-d tensors on
    ``device`` for the plain version, and the same f32 values as host floats
    ("scalars") for the kernel's arguments.

    ``cam_y`` is a scalar (one camera) or an (R,) array, a camera height a
    ray (a batch of cameras marched together, ``raymarch.py:914-920``);
    then "cam_y" and "cam_y_norm" are (R,) tensors and their scalars 0.
    ``cam_y_norm = cam_y / world_max_y`` is an f32 divide either way, as the
    reference computes it.

    The tensors live on the rays' device on purpose: torch divides a CUDA
    tensor by a CPU scalar as a multiply by its reciprocal, which is not the
    reference's divide."""
    wmy, smin, smax = (None if x is None else np.float32(x)
                       for x in (world_max_y, solid_min_y, solid_max_y))
    cy = np.asarray(cam_y, np.float32)
    cy_norm = cy / wmy  # f32 divide, as the reference computes it

    def t(x):
        return None if x is None else torch.tensor(x, dtype=torch.float32,
                                                   device=device)

    per_ray = cy.ndim > 0
    return {
        "world_max_y": t(wmy), "cam_y": t(cy), "cam_y_norm": t(cy_norm),
        "solid_min_y": t(smin), "solid_max_y": t(smax),
        "gate_eps": t(GATE_EPS),
        "scalars": tuple(None if x is None else float(x)
                         for x in (wmy, 0.0 if per_ray else cy,
                                   0.0 if per_ray else cy_norm, smin, smax)),
    }


def take_consts(consts, index):
    """``consts`` for the rays of a live-ray ``index``: a per-ray camera
    height goes through the index like every other per-ray field."""
    if index is None or consts["cam_y"].dim() == 0:
        return consts
    return {**consts, "cam_y": _take(consts["cam_y"], index),
            "cam_y_norm": _take(consts["cam_y_norm"], index)}


def init_raster_state(static: RayStatic, pixel_len: int) -> RasterState:
    R = static.dirs.shape[0]
    dev = static.dirs.device
    return RasterState(
        raybuf=torch.full((R, pixel_len), -1, dtype=torch.int32, device=dev),
        nfp_min=static.orig_min.clone(),
        nfp_max=static.orig_max.clone(),
        fb_min=static.orig_min.float() - 0.501,
        fb_max=static.orig_max.float() + 0.501,
        f_active=torch.zeros(R, dtype=torch.bool, device=dev),
        fdir_min=torch.zeros(R, dtype=torch.float32, device=dev),
        fdir_max=torch.zeros(R, dtype=torch.float32, device=dev),
        alive=torch.ones(R, dtype=torch.bool, device=dev))


def reset_raster_state(rs: RasterState, static: RayStatic) -> None:
    """``init_raster_state``'s values written into ``rs``'s own tensors."""
    for d, x in zip(rs, init_raster_state(static, rs.raybuf.shape[1])):
        d.copy_(x)


# ------------------------------------------------------------------ march


def chunk_cells(wa: WorldArrays, visits, iteration_direction: int) -> CellFields:
    """The rasterizer's input for one chunk: the visit list's dense fields
    plus the fetched column records (invalid visits fetch column 0 and are
    masked by ``valid``)."""
    v_lod = visits[:, 4]
    v_valid = visits[:, 5] != 0
    lodc = v_lod.clamp(0, 7)
    ci = _cell_index(wa, lodc, v_lod, visits[:, 0] >> v_lod,
                     visits[:, 1] >> v_lod)
    ci = torch.where(v_valid, ci, 0)
    n_runs, color_off, cmin, cmax, runs, colors = _fetch_columns(
        wa, ci, v_valid, iteration_direction)
    ids = visits[:, 2:4].permute(0, 2, 1).contiguous().view(torch.float32)
    # contiguous (C, R) fields: the rasterizer kernel reads them that way
    return CellFields(ids=ids, lod=v_lod.contiguous(), valid=v_valid,
                      n_runs=n_runs, color_off=color_off.contiguous(),
                      cmin=cmin.contiguous(), cmax=cmax.contiguous(),
                      runs=runs.contiguous(),
                      colors=None if colors is None else colors.contiguous())


def packed_cells(wa: WorldArrays, cells: PackedCells,
                 iteration_direction: int) -> CellFields:
    """A gated group's cells with their column records fetched
    (``raymarch.py:1333``); a cell outside ``proc`` fetches the packed
    slot's column and is masked by ``valid``."""
    rows = cells.rows
    n_runs, color_off, cmin, cmax, runs, colors = _fetch_columns(
        wa, rows[..., 0], cells.proc, iteration_direction)
    return CellFields(
        ids=rows[..., 1:3].contiguous().view(torch.float32),
        lod=rows[..., 3].contiguous(), valid=cells.proc, n_runs=n_runs,
        color_off=color_off.contiguous(), cmin=cmin.contiguous(),
        cmax=cmax.contiguous(), runs=runs.contiguous(),
        colors=None if colors is None else colors.contiguous())


def fetch_cells(wa: WorldArrays, cells, iteration_direction: int) -> CellFields:
    """The rasterizer's cells with their column records, from either input
    of the march's rasterize op: the roll's visits (C, 13, R) on the dense
    march, a ``PackedCells`` group on the gated march."""
    if isinstance(cells, PackedCells):
        return packed_cells(wa, cells, iteration_direction)
    return chunk_cells(wa, cells, iteration_direction)


def march_ops(kernels: bool):
    """(roll, raster, gate, rewind): the ops wrappers (the CUDA kernels on a
    CUDA tensor), or with ``kernels`` False their plain torch versions.
    ``raster`` takes (rs, wa, cells, static, consts, direction, index) with
    ``cells`` the roll's visits or a ``PackedCells`` group, and reads the
    column records itself.  ``gate`` and ``rewind`` are the gated march's
    glue (``ops/gate_kernel.py``: ``gated_group`` and ``rewind_apply`` with
    the kernels' in-place contract)."""
    from cpuvox_tpu_torch.ops import gate_kernel, phase1_kernel, roll_kernel

    if kernels:
        return (roll_kernel.roll_chunk, phase1_kernel.rasterize_visits,
                gate_kernel.gate, gate_kernel.rewind)
    return (roll_kernel.roll_chunk_ref, phase1_kernel.rasterize_visits_ref,
            gate_kernel.gate_ref, gate_kernel.rewind_ref)


def current_stream(device: torch.device):
    """The current CUDA stream of ``device``, None off CUDA."""
    return torch.cuda.current_stream(device) if device.type == "cuda" else None


def device_sum(acc: dict, key, v: torch.Tensor, shape=()) -> torch.Tensor:
    """The int64 accumulator of ``shape`` in ``acc`` that ``v`` adds to:
    one a ``key``, device and stream (``current_stream``), made where it is
    first needed.  Marches that run at once on several streams of a card
    (the shards of ``parallel/mesh.py``) each add to their own, so no two
    in-place adds race; ``read_sum`` reads one."""
    s = current_stream(v.device)
    slot = (key, v.device, None if s is None else s.cuda_stream)
    hit = acc.get(slot)
    if hit is None:
        hit = acc[slot] = (torch.zeros(shape, dtype=torch.int64,
                                       device=v.device), s)
    return hit[0]


def read_sum(acc: torch.Tensor, stream) -> list | int:
    """An accumulator of ``device_sum`` read to the host once the stream
    that adds to it has finished."""
    if stream is not None:
        stream.synchronize()
    return acc.tolist()


class MarchStats:
    """Counts of the march since the last reset (``update``): host ints,
    and device tensors that a march added without reading them (a frame's
    rewinds, a march graph's iterations), summed on the device in stream
    order (an accumulator a stream, ``device_sum``) and read only when a
    count is asked for.  ``dict(stats)`` gives every count."""

    def __init__(self, **counts: int):
        self._host = dict(counts)
        self._device: dict[tuple, tuple] = {}

    def add(self, **counts) -> None:
        """Add to the counts: an int on the host, a device tensor on its
        device (no read)."""
        for k, v in counts.items():
            if k not in self._host:
                raise KeyError(k)
            if isinstance(v, torch.Tensor):
                device_sum(self._device, k, v).add_(v)
            else:
                self._host[k] += v

    def update(self, **counts: int) -> None:
        """Set counts (0 to reset them)."""
        for k, v in counts.items():
            if k not in self._host:
                raise KeyError(k)
            self._host[k] = v
            for (dk, _dev, _s), (acc, stream) in self._device.items():
                if dk == k:
                    with torch.cuda.stream(stream):
                        acc.zero_()

    def __getitem__(self, key: str) -> int:
        return self._host[key] + sum(
            int(read_sum(acc, s)) for (k, _d, _s), (acc, s)
            in self._device.items() if k == key)

    def keys(self):
        return self._host.keys()

    def reset(self) -> None:
        """Every count to 0."""
        self.update(**dict.fromkeys(self._host, 0))


# live-ray compaction in the host loop since the last reset: index rebuilds,
# march chunks (or gated iterations) and the ray slots they worked on (mean
# Rk = slots / chunks)
compact_stats = MarchStats(rebuilds=0, chunks=0, ray_slots=0)


def live_index(mask, n: int):
    """The ascending int32 (n,) indices of the ``n`` True entries of ``mask``
    (R,), built without asking the device for the count (``torch.nonzero``
    would): each live ray scatters its index to its rank, every dead ray to
    the discarded slot n."""
    R = mask.shape[0]
    rank = torch.cumsum(mask, 0) - 1
    dest = torch.where(mask, rank, n)
    rays = torch.arange(R, dtype=torch.int32, device=mask.device)
    return torch.empty(n + 1, dtype=torch.int32,
                       device=mask.device).scatter_(0, dest, rays)[:n]


# the card's stage quantum: every stage width of a march graph is a multiple
# of it.  256 rays are 8 blocks of the roll (32 rays a block) and 32 of the
# rasterizer (8 rays a block), so no stage launches a ragged block; and a
# stage's body costs its own captured temporaries in the graph's pool, so
# the narrowest stage stops at 256 rays rather than a few dozen, where the
# launches and the per-stage check and pack would cost more than the
# narrower kernels save
STAGE_QUANTUM = 256


def stage_widths(R: int, quantum: int = STAGE_QUANTUM) -> tuple:
    """The staged march's widths (``raymarch.py:1085-1091``): R, then each
    width halved and rounded up to a multiple of ``quantum``, while that is
    at least ``quantum`` and narrower than the last.  With quantum 1024 it
    is the reference's ``sizes``."""
    sizes = [int(R)]
    while True:
        nxt = ((sizes[-1] // 2 + quantum - 1) // quantum) * quantum
        if nxt < quantum or nxt >= sizes[-1]:
            return tuple(sizes)
        sizes.append(nxt)


def stage_index(alive, width: int):
    """The next stage's live-ray index (``raymarch.py:1601``): the rays
    stable-sorted live first, cut to ``width``, as int32 (width,).  The
    live rays come first in ascending order, then dead rays in ascending
    order, so every slot is a distinct ray.  The plain version of
    ``render/march_graph.py``'s pack."""
    return torch.argsort(~alive, stable=True)[:width].to(torch.int32)


def live_rays(march_alive, index, compact: bool):
    """The march's one read from the device a chunk: (live count, index).
    The live-ray index is rebuilt when the count has fallen to half of the
    rays it holds, or less (the reference's halving, ``raymarch.py:1087``,
    without its 1024-ray quantum); None stands for all R rays."""
    n = int(march_alive.sum().item())
    width = march_alive.shape[0] if index is None else index.shape[0]
    if compact and 0 < n and 2 * n <= width:
        index = live_index(march_alive, n)
        width = n
        compact_stats.add(rebuilds=1)
    if n:
        compact_stats.add(chunks=1, ray_slots=width)
    return n, index


class MarchArgs(NamedTuple):
    """What every iteration of a frame's march reads and none writes."""

    wa: WorldArrays
    static: RayStatic
    lod_distances: torch.Tensor  # (nld,) f32
    far_clip: float  # f32-exact
    dims: tuple
    consts: dict  # raster_consts
    iteration_direction: int
    chunk: int
    max_chunks: int
    group_cells: int = 0  # > 0: the gated march's group, else the dense march
    kernels: bool = True


class MarchState(NamedTuple):
    """The march loop's state, what an iteration reads and writes (the
    carry of ``raymarch.py:928-957``'s ``while_loop``).  ``alive`` is the
    roll's liveness folded with the rasterizer's (``alive & rs.alive``), so
    the loop goes on while any entry is True and ``i`` is under the
    budget."""

    dda: DDAState
    alive: torch.Tensor  # (R,) bool
    rs: RasterState
    i: torch.Tensor  # () int32: iterations run
    rewound: torch.Tensor  # () int64: rays rewound (the gated march)
    # (3,) int64: the gate kernel's launches, its steps past the tile budget
    # and the rewind kernel's launches (``ops/gate_kernel.py``; the plain
    # versions count nothing)
    gate_counts: torch.Tensor


def march_state(dda: DDAState, alive0, rs: RasterState) -> MarchState:
    """The state before the first iteration."""
    dev = alive0.device
    return MarchState(dda, alive0 & rs.alive, rs,
                      torch.zeros((), dtype=torch.int32, device=dev),
                      torch.zeros((), dtype=torch.int64, device=dev),
                      torch.zeros(3, dtype=torch.int64, device=dev))


def state_tensors(s: MarchState) -> list:
    """The state's tensors in a fixed order."""
    return [*s.dda, s.alive, *s.rs, s.i, s.rewound, s.gate_counts]


def write_state(dst: MarchState, src: MarchState) -> None:
    """``src`` written into ``dst``'s own tensors (the in-place form of an
    iteration, which a CUDA graph replays on fixed buffers).  A field that
    already is ``dst``'s tensor (a kernel updated it in place) is skipped.
    Every field of ``src`` is computed before the first copy is made, so no
    copy overwrites what a later one reads."""
    for d, x in zip(state_tensors(dst), state_tensors(src)):
        if d is not x:
            d.copy_(x)


def _advance(alive, rs_alive, i):
    """An iteration's end: the liveness folded, the counter advanced."""
    return alive & rs_alive, i + 1


def loop_control(alive, rs_alive, i, max_chunks: int, threshold: int = 0):
    """The loop's control after a body (``raymarch.py:928-930``, and
    ``:1126-1129`` for a stage of the staged march): the liveness folded,
    the counter advanced, and the next iteration's condition
    ``count(alive) > threshold & (i < max_chunks)`` as a 0-d bool tensor;
    threshold 0 is ``any(alive)``, a stage's is the next stage's width.  The
    plain version of ``csrc/march_loop.cu``'s kernel."""
    alive, i = _advance(alive, rs_alive, i)
    return alive, i, (alive.sum() > threshold) & (i < max_chunks)


def march_body(a: MarchArgs, s: MarchState, index=None) -> MarchState:
    """One dense iteration without its control: roll the live rays (all of
    them, or those of a live-ray ``index``), then fetch and rasterize their
    visited cells (one op, which reads the column records itself)."""
    roll, raster, _gate, _rewind = march_ops(a.kernels)
    dda, alive, visits = roll(s.dda, s.alive, a.static.dirs, a.lod_distances,
                              a.far_clip, a.dims, a.chunk, index=index)
    rs = raster(s.rs, a.wa, visits, a.static, a.consts, a.iteration_direction,
                index=index)
    return s._replace(dda=dda, alive=alive, rs=rs)


def gated_body(a: MarchArgs, s: MarchState, index=None) -> MarchState:
    """One gated iteration without its control: roll ``chunk`` steps, gate
    and pack the first ``group_cells`` gated cells of each ray
    (``gated_group``, the pre-kill in place), rasterize them, then rewind
    the rays that had more (``rewind_apply``) and count them, in place
    (``march_ops``' gate and rewind)."""
    roll, raster, gate, rewind = march_ops(a.kernels)
    dda, alive, visits = roll(s.dda, s.alive, a.static.dirs, a.lod_distances,
                              a.far_clip, a.dims, a.chunk, index=index)
    g = gate(a.wa, visits, s.rs, a.consts, a.group_cells, s.gate_counts,
             index=index)
    rs = raster(s.rs, a.wa, g.cells, a.static, a.consts,
                a.iteration_direction, index=index)
    rewind(dda, alive, s.rewound, s.gate_counts, rs, g, index=index)
    return s._replace(dda=dda, alive=alive, rs=rs)


def _advanced(s: MarchState) -> MarchState:
    alive, i = _advance(s.alive, s.rs.alive, s.i)
    return s._replace(alive=alive, i=i)


def march_step(a: MarchArgs, s: MarchState, index=None) -> MarchState:
    """One iteration of the dense march (``raymarch.py:931-957``): the body,
    then the liveness folded and the counter advanced (``loop_control``
    without the condition, which the caller checks); no host read."""
    return _advanced(march_body(a, s, index))


def gated_step(a: MarchArgs, s: MarchState, index=None) -> MarchState:
    """One iteration of the gated march (``raymarch.py:1542-1583``): the
    body, then the liveness folded and the counter advanced; no host
    read."""
    return _advanced(gated_body(a, s, index))


def march_on_host(a: MarchArgs, s: MarchState, compact: bool):
    """The loop driven from the host, for the CPU, the plain versions and
    the ray-sharded path: one read of the live count an iteration
    (``live_rays``), which also rebuilds the live-ray index.  Returns (the
    final state, iterations run)."""
    step = gated_step if a.group_cells else march_step
    index = None
    i = 0
    while i < a.max_chunks:
        n, index = live_rays(s.alive, index, compact)
        if not n:
            break
        s = step(a, s, index)
        i += 1
    return s, i


def march(wa: WorldArrays, static: RayStatic, dda: DDAState, alive0,
          rs: RasterState, lod_distances, far_clip, dims, consts,
          iteration_direction: int, chunk: int, max_chunks: int,
          kernels: bool = True, compact: bool = True) -> RasterState:
    """Full dense phase-1 march (``raymarch.py:895``): ``march_step`` until
    every ray is dead or ``max_chunks`` ran, driven from the host."""
    a = MarchArgs(wa, static, lod_distances, far_clip, dims, consts,
                  iteration_direction, chunk, max_chunks, 0, kernels)
    return march_on_host(a, march_state(dda, alive0, rs), compact)[0].rs


# gated iterations run, rays rewound, the gate kernel's launches and steps
# past its tile budget, and the rewind kernel's launches, by the gated march
# since the last reset, on the host loop and in march graphs
gated_stats = MarchStats(iterations=0, rewinds=0, gate_launches=0,
                         overflow_steps=0, rewind_launches=0)
profiling.register_counts("gated", gated_stats)


def add_gated_stats(s: MarchState, iterations) -> None:
    """A gated march's ``iterations`` (an int, or the state's device
    counter) and the state's counts into ``gated_stats``, without a read."""
    gated_stats.add(iterations=iterations, rewinds=s.rewound,
                    gate_launches=s.gate_counts[0],
                    overflow_steps=s.gate_counts[1],
                    rewind_launches=s.gate_counts[2])


def _pack_rank(mask, K: int):
    """(rank, dest) for a (C, R) mask: each True entry's rank among the ray's
    True entries along the steps, and the row it packs to: its rank while
    that is below K, else the discarded row K.  The cumsum keeps per-ray step
    order, so a scatter to ``dest`` is the reference's sort by step index."""
    rank = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32) - 1
    return rank, torch.where(mask & (rank < K), rank, K).long()


def _scatter_rows(dest, K: int, x):
    """Entries of ``x`` (C, R[, F]) scattered along the steps to ``dest``
    (C, R): (K, R[, F]); slots no entry packs to hold 0."""
    idx = dest if x.dim() == 2 else dest[..., None].expand_as(x)
    buf = torch.zeros((K + 1,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return buf.scatter_(0, idx, x)[:K]


class GatedGroup(NamedTuple):
    """One gated iteration's group and what its rewind reads."""

    cells: PackedCells  # (GK, R) each ray's first GK gated cells
    gate: torch.Tensor  # (C, R) bool: steps that reach the rasterizer
    rank: torch.Tensor  # (C, R) i32: a gated step's rank among the ray's
    count: torch.Tensor  # (R,) i32: gated steps per ray
    cap: torch.Tensor  # (R,) i32: gated steps in the group, min(count, GK)


def gated_group(wa: WorldArrays, visits, rs: RasterState, consts,
                group_cells: int, index=None):
    """Stages A and B of a gated iteration (``raymarch.py:1228-1333``): gate
    a rolled chunk's cells on the occupancy tiles and the frozen frustum
    window, retire rays whose window cleared the solid bounds, and pack the
    first ``group_cells`` gated cells of each ray (no record is read here).
    Returns (rs with the pre-kill applied, GatedGroup).  With a live-ray ``index`` the visits
    and the group are those rays', (., Rk)."""
    C, R = visits.shape[0], visits.shape[2]
    if index is not None:
        index = index.long()
    GK = group_cells
    dev = visits.device
    v_lod = visits[:, 4]
    v_valid = visits[:, 5] != 0
    ids0 = visits[:, 2].view(torch.float32)
    ids1 = visits[:, 3].view(torch.float32)
    lodc = v_lod.clamp(0, 7)
    xc = visits[:, 0] >> v_lod
    zc = visits[:, 1] >> v_lod

    # ---- stage A: one tile row per distinct tile a ray crosses this chunk,
    # packed to a budget of TS slots; steps past the budget count as "fetch"
    TS = C // 8 + 4
    ti = _occ_tile_index(wa, lodc, v_lod, xc, zc)
    new = torch.ones_like(v_valid)
    new[1:] = ti[1:] != ti[:-1]
    slot, dest_a = _pack_rank(new, TS)
    packed_ti = _scatter_rows(dest_a, TS, ti)
    n_tiles = wa.occ_tiles.shape[0]
    rows = wa.occ_tiles.index_select(
        0, packed_ti.clamp(0, n_tiles - 1).reshape(-1).long())
    rows = rows.reshape(TS, R, -1).permute(0, 2, 1).reshape(-1, R)
    # per step: its slot's bitmap word, tile cmin and tile cmax (the reference
    # selects them with a TS x 4-way where chain; the values are integers, so
    # one gather gives the same)
    base = slot.clamp(max=TS - 1) * world_device.OCC_ROW
    w_idx = (xc & 15) >> 2
    picked = torch.gather(rows, 0, torch.cat(
        [base + w_idx, base + 4, base + 5]).long()).reshape(3, C, R)
    wv, tcmin, tcmax = picked[0], picked[1], picked[2]
    bit_pos = ((xc & 3) << 3) | (zc & 7)
    bit = (wv >> bit_pos) & 1  # only bit 0 is read, so `>>` may be arithmetic
    overflow = slot >= TS
    bitish = (bit != 0) | overflow

    # ---- the conservative frustum-window gate with taint: while a ray's
    # narrowing is active and no earlier step of the chunk might have changed
    # it, the rasterizer's window is the frozen-fdir one, so a tile whose
    # [cmin, cmax] misses it (with a margin) is a provable skip_col
    cam_y, wmy = take_consts(consts, index)["cam_y"], consts["world_max_y"]
    fdmin = _take(rs.fdir_min, index)[None, :]
    fdmax = _take(rs.fdir_max, index)[None, :]
    fact0 = _take(rs.f_active, index)[None, :]
    dt = torch.where(fdmax > 0, ids1, ids0)
    db = torch.where(fdmin < 0, ids1, ids0)
    new_max = cam_y + fdmax * dt
    new_min = cam_y + fdmin * db
    margin = consts["gate_eps"] * (new_max.abs() + new_min.abs() + 1.0)
    cull_might = (new_min + margin > wmy) | (new_max - margin < 0.0)
    excl = (fact0 & ~cull_might & ~overflow
            & ((tcmin.float() > new_max + margin)
               | (tcmax.float() < new_min - margin)))
    trigger = (v_valid & bitish & ~excl).to(torch.int32)
    taint_before = (torch.cumsum(trigger, 0) - trigger) > 0
    gate = v_valid & bitish & (taint_before | ~excl)

    if consts["solid_max_y"] is not None:
        # solid-bound pre-kill: on an untainted step the frozen window is
        # exact, so a monotone window past the solid Y bounds retires the ray
        # before the fetch; cells from the killing step on are skip_cols
        kill_pre = (fact0 & v_valid & ~taint_before
                    & (((fdmin >= 0.0)
                        & (new_min - margin > consts["solid_max_y"]))
                       | ((fdmax <= 0.0)
                          & (new_max + margin < consts["solid_min_y"]))))
        kill_from = torch.cumsum(kill_pre.to(torch.int32), 0) > 0
        gate = gate & ~kill_from
        rs = rs._replace(alive=_put(
            rs.alive, index, _take(rs.alive, index) & ~kill_from[-1]))

    # ---- stage B: pack the gated steps to a per-ray prefix, in step order;
    # the group's tail cells of rays with fewer than GK gated cells are not
    # in ``proc``, which the rasterizer treats as no-ops.  The column records
    # are read by the rasterize op (``fetch_cells`` in its plain version)
    rank, dest_b = _pack_rank(gate, GK)
    ci = _cell_index(wa, lodc, v_lod, xc, zc)
    packed = _scatter_rows(dest_b, GK, torch.stack(
        [ci, visits[:, 2], visits[:, 3], v_lod], -1))  # (GK, R, 4)
    count = rank[-1] + 1
    cap = count.clamp(max=GK)
    proc = torch.arange(GK, dtype=torch.int32, device=dev)[:, None] < cap
    cells = PackedCells(packed, proc)
    return rs, GatedGroup(cells, gate, rank, count, cap)


# the pre-switch snapshot's words a ray (``rewind_snapshot``)
SNAP_WORDS = 7


def rewind_snapshot(visits, g: GatedGroup):
    """The rewind's anchor (``raymarch.py:1547-1560``): for each ray the
    pre-switch snapshot of its first unprocessed gated cell, the step where
    ``gate & rank == cap``, as (7, R) int32 [pos x, pos z, tmax x, tmax z,
    ids0, ids1 (f32 bits), lod]; a masked sum over the steps, 0 where there
    is no such step.  The sums are exact (one nonzero summand per busy ray,
    as the reference sums them), except that an f32 word is rounded by the
    sum's adds (-0.0 reads +0.0)."""
    rwm = g.gate & (g.rank == g.cap)

    def rsum(f):
        return torch.where(rwm, f, torch.zeros_like(f)).sum(0, dtype=f.dtype)

    pre = visits[:, 6:13]
    f32 = [rsum(pre[:, k].view(torch.float32)).view(torch.int32)
           for k in range(2, 6)]
    return torch.stack([rsum(pre[:, 0]), rsum(pre[:, 1]), *f32,
                        rsum(pre[:, 6])])


def rewind_apply(dda: DDAState, snap, count, cap, rs: RasterState,
                 index=None):
    """The busy-ray rewind (``raymarch.py:1562-1579``): a live ray with
    more gated cells than its group held (``count > cap``) gets its
    ``snap`` (``rewind_snapshot``), so the next iteration re-rolls from
    exactly there (same DDA state, same float trajectory).  Returns (dda,
    rewound), the rewound mask over the group's rays: (R,), or (Rk,) with a
    live-ray ``index``."""
    full = dda
    if index is not None:
        index = index.long()
        dda = DDAState(*(_take(f, index) for f in dda))
    needs = (count > cap) & _take(rs.alive, index)
    lod_rw = snap[6]
    f32 = snap[2:6].view(torch.float32)
    dda_rw = DDAState(
        pos=torch.stack([snap[0], snap[1]], 1),
        tmax=torch.stack([f32[0], f32[1]], 1),
        # tdelta and stp scale by exact powers of two per LOD
        tdelta=torch.ldexp(dda.tdelta, (lod_rw - dda.lod)[:, None]),
        stp=torch.sign(dda.stp) * (1 << lod_rw)[:, None],
        ids=torch.stack([f32[2], f32[3]], 1), lod=lod_rw)
    dda = _select(needs, dda_rw, dda)
    return DDAState(*(_put(f, index, x) for f, x in zip(full, dda))), needs


def march_gated(wa: WorldArrays, static: RayStatic, dda: DDAState, alive0,
                rs: RasterState, lod_distances, far_clip, dims, consts,
                iteration_direction: int, chunk: int, max_chunks: int,
                group_cells: int, kernels: bool = True,
                compact: bool = True) -> RasterState:
    """Full occupancy-gated phase-1 march (``phase1_pallas`` with
    ``occupancy=True``, one drain group, no block fetch, no lite records):
    per iteration roll ``chunk`` steps, rasterize the first ``group_cells``
    gated cells of each ray (``gated_group``) and rewind the rays that had
    more (``rewind_apply``), until every ray is dead or ``max_chunks``
    iterations ran.  Every iteration advances a ray by at least one rasterized cell or
    ``chunk`` steps, so a budget of 3 * max_dim + 64 never truncates one
    (``Renderer.march_params``).  Its raybuffer equals ``march``'s.

    The live-ray index is rebuilt at the top of an iteration, so after the
    previous one's rewind: a rewound ray was rolled in that iteration, so it
    is in the index that iteration used, and ``alive & rs.alive`` of a ray
    outside the index never comes back.  The rewinds are counted on the
    device (``gated_stats`` reads them when asked)."""
    a = MarchArgs(wa, static, lod_distances, far_clip, dims, consts,
                  iteration_direction, chunk, max_chunks, group_cells,
                  kernels)
    s, i = march_on_host(a, march_state(dda, alive0, rs), compact)
    add_gated_stats(s, i)
    return s.rs


def phase1(wa: WorldArrays, static: RayStatic, dda: DDAState, alive0,
           lod_distances, far_clip, world_max_y, cam_y,
           iteration_direction: int, chunk: int, max_chunks: int, dims,
           pixel_len: int, solid_min_y=None, solid_max_y=None,
           kernels: bool = True, gated_cells: int = 0, compact: bool = True):
    """Full phase 1 (``raymarch.py:961`` and ``:997``): the dense march, or
    with ``gated_cells`` > 0 the occupancy-gated march in groups of that many
    cells, then the deferred skybox fill over all rays in their original
    order.  ``cam_y`` is the camera's height, or (R,) a ray's camera's for a
    batch of cameras (``parallel/batch.py``).  Returns the (R, pixel_len) int32 raybuffer: color indices, or in
    ARGB mode (``wa.max_col_colors`` > 0) final colors as int32 bits."""
    dev = static.dirs.device
    rs = init_raster_state(static, pixel_len)
    consts = raster_consts(world_max_y, cam_y, solid_min_y, solid_max_y, dev)
    lod_distances = torch.as_tensor(np.asarray(lod_distances, np.float32),
                                    device=dev)
    far = float(np.float32(far_clip))  # f32-exact: compares like the f32 scalar
    args = (wa, static, dda, alive0, rs, lod_distances, far, dims, consts,
            iteration_direction, chunk, max_chunks)
    if gated_cells:
        rs = march_gated(*args, group_cells=gated_cells, kernels=kernels,
                         compact=compact)
    else:
        rs = march(*args, kernels=kernels, compact=compact)
    return fill_skybox(wa, static, rs.raybuf)


def fill_skybox(wa: WorldArrays, static: RayStatic, rb):
    """The deferred WriteSkybox (:699-716) on a marched raybuffer, into a
    new tensor: unwritten texels inside the ray's pixel range -> the skybox
    (0, or in ARGB mode its color; written texels get the alpha MSB back),
    outside it -> magenta in ARGB mode."""
    pix = torch.arange(rb.shape[1], dtype=torch.int32, device=rb.device)[None, :]
    in_range = (pix >= static.orig_min[:, None]) & (pix <= static.orig_max[:, None])
    if wa.max_col_colors:
        # ARGB mode (``raymarch.py:1611-1618``): written texels get the alpha
        # MSB back; unwritten in range -> the skybox color, out of range ->
        # magenta
        return torch.where(
            rb < 0, torch.where(in_range, wa.colors[0], MAGENTA_I32),
            rb | I32_MIN)
    return torch.where((rb < 0) & in_range, 0, rb)


def resolve_colors(raybuf_idx, colors):
    """Color-index buffer -> ARGB as int32 bits (``raymarch.py:1633``);
    unwritten (-1) -> debug magenta."""
    vals = colors[raybuf_idx.clamp(0, colors.shape[0] - 1).long()]
    return torch.where(raybuf_idx < 0, MAGENTA_I32, vals)
