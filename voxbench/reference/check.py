"""The comparison that decides ``correct``.

For each frame the window kept (drawn from the seed), the program's screen
and raybuffer, both in ARGB, are held against the plain reference:

- ``texels_off``: texels of the sampled rays' raybuffer rows that differ
  from the scalar oracle's rows (``frame.ray_row``), rays drawn from the
  seed one a stratum of the frame's rays in raybuffer order, so that every
  segment and every range of ray indices has its share;
- ``pixels_off``: screen pixels that differ from the raybuffer texel that
  the reference's reprojection assigns them (``frame.pixel_texels``), over
  the whole screen: phase 2 judged on the program's own raybuffer, whose
  sampled rows the first number judges;
- ``magenta_pixels``: pixels left at the unwritten magenta.

Each has the limit 0: the renderer is exact (oracle == plain == kernels,
bit for bit).  A run that checked no frame or no ray is not correct either.
"""
from __future__ import annotations

import numpy as np

from . import frame as rf
from .colors import DEBUG_MAGENTA, SKYBOX

LIMITS = {"texels_off": ("<=", 0), "pixels_off": ("<=", 0),
          "magenta_pixels": ("<=", 0), "frames_checked": (">=", 1),
          "rays_checked": (">=", 1)}


def pick_rays(g: rf.Geometry, n: int, rng: np.random.Generator):
    """``n`` rays of the frame, (segment, ray, row) triples: the frame's
    rays in raybuffer order cut into ``n`` strata of (nearly) equal size,
    one ray drawn from each; every ray where the frame has ``n`` or fewer."""
    rays = g.rays()
    if len(rays) <= n:
        return rays
    edges = np.linspace(0, len(rays), n + 1).astype(np.int64)
    idx = [int(rng.integers(a, b)) for a, b in zip(edges[:-1], edges[1:])]
    return [rays[k] for k in idx]


def expected_screen(g: rf.Geometry, raybuf_argb: np.ndarray,
                    mapping=None) -> np.ndarray:
    """The screen that the reference's reprojection makes of a raybuffer:
    (h, w) uint32, row 0 = bottom.  ``mapping``: ``rf.pixel_texels(g)``
    if it was worked out already."""
    row, texel = rf.pixel_texels(g) if mapping is None else mapping
    out = np.full(row.shape, SKYBOX, np.uint32)
    hit = row >= 0
    out[hit] = raybuf_argb[row[hit], texel[hit]]
    return out


def frame_numbers(lods, g: rf.Geometry, screen, raybuf_argb, rays,
                  dtype=np.float32, mapping=None, ref_rows=None) -> dict:
    """The numbers of one frame.  ``screen`` (h, w) and ``raybuf_argb``
    (R, P) are uint32 ARGB; ``rays`` are the sampled (segment, ray, row);
    ``ref_rows``, the reference's rows of those rays if they were worked
    out already (``rows.rows``)."""
    w, h = g.render_wh
    if screen.shape != (h, w):
        raise ValueError(f"screen {screen.shape}, expected {(h, w)} "
                         "(render_scale 1)")
    texels = 0
    if ref_rows is None:
        ref_rows = [rf.ray_row(lods, g, si, i, dtype) for si, i, _ in rays]
    for (si, i, row), ref in zip(rays, ref_rows):
        texels += int((raybuf_argb[row, :ref.shape[0]] != ref).sum())
    pixels = int((screen != expected_screen(g, raybuf_argb, mapping)).sum())
    magenta = int((screen == DEBUG_MAGENTA).sum())
    return {"texels_off": texels, "pixels_off": pixels,
            "magenta_pixels": magenta, "frames_checked": 1,
            "rays_checked": len(rays)}


def judge(numbers: list[dict]) -> tuple[bool, dict]:
    """Sums the frames' numbers and holds each against its limit: (correct,
    {name: {"value", "limit", "op"}})."""
    total = {k: sum(n[k] for n in numbers) for k in LIMITS}
    out, ok = {}, True
    for k, (op, limit) in LIMITS.items():
        v = total[k]
        ok &= v <= limit if op == "<=" else v >= limit
        out[k] = {"value": v, "op": op, "limit": limit}
    return ok, out
