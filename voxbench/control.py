"""The control of the comparison that decides ``correct``: the plain reference,
computed in float16, the precision below the float32 the renderer states,
put in the program's place.  It has to come out as not correct.

    python3 voxbench/control.py --workload <name> --seeds <n> [<n> ...]

For each seed it takes ``check_frames`` cameras of the cell's traffic at the
cell's own size and renders each as the program would, in float16: every
ray's raybuffer row by the float16 oracle (a ray the float16 march cannot
finish leaves its row unwritten) and the screen by the float16
reprojection of that raybuffer.  That raybuffer and screen then go through
the harness's own comparison (``check.frame_numbers``, ``check.judge``),
with the rays a run would draw.  It runs on the host alone (numpy), the
rays spread over worker processes; it prints one JSON line a seed.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from voxbench import spec  # noqa: E402
from voxbench.reference import check, rows  # noqa: E402
from voxbench.reference import frame as rf  # noqa: E402
from voxbench.reference.colors import DEBUG_MAGENTA  # noqa: E402
from voxbench.traffic import Flythrough  # noqa: E402
from voxbench.worldgen import cache as world_cache  # noqa: E402


def render(world_path: str, lods, g: rf.Geometry, dtype, n_workers=None):
    """The reference's frame in ``dtype`` as the program hands it over:
    (screen (h, w), raybuffer (R, max(w, h)), both uint32 ARGB; the rays
    that could not finish)."""
    w, h = g.render_wh
    rays = g.rays()
    raybuf = np.full((len(rays), max(w, h)), DEBUG_MAGENTA, np.uint32)
    got = rows.rows(world_path, lods, [(g, [(si, i) for si, i, _ in rays])],
                    dtype, n_workers)[0]
    crashed = 0
    for (_si, _i, row), r in zip(rays, got):
        if r is None:
            crashed += 1
            continue
        raybuf[row, :r.shape[0]] = r
    screen = check.expected_screen(g, raybuf, rf.pixel_texels(g, dtype))
    return screen, raybuf, crashed


def control(cell: spec.Cell, seed: int, lods, world_path: str,
            dtype=np.float16, n_workers=None) -> dict:
    """The control's reading for one seed: the harness's numbers and verdict
    on the reference rendered in ``dtype``."""
    tr, render_cfg = cell.traffic, cell.config["render"]
    fly = Flythrough(tr, lods[0].dims, seed)
    wh = rf.render_wh(tr["width"], tr["height"], render_cfg["render_scale"])
    lod_far = rf.lod_distances(fly.warmup()[0], render_cfg, wh,
                               max(lods[0].dims))
    rng = np.random.default_rng([int(seed), 2])
    frames = sorted(rng.choice(len(fly.passes), size=tr["check_frames"],
                               replace=False))
    geoms = [rf.geometry(fly.pose(int(j)), render_cfg, wh, lod_far)
             for j in frames]
    picks = [check.pick_rays(g, tr["check_rays"], rng) for g in geoms]
    ref_rows = rows.rows(world_path, lods, [
        (g, [(si, i) for si, i, _ in p]) for g, p in zip(geoms, picks)],
        n_workers=n_workers)
    numbers, crashed, n_rays = [], 0, 0
    for g, rays, ref in zip(geoms, picks, ref_rows):
        screen, raybuf, c = render(world_path, lods, g, dtype, n_workers)
        crashed += c
        n_rays += raybuf.shape[0]
        numbers.append(check.frame_numbers(lods, g, screen, raybuf, rays,
                                           ref_rows=ref))
    correct, out = check.judge(numbers)
    return {"seed": seed, "dtype": np.dtype(dtype).name,
            "correct": bool(correct), "rays_rendered": n_rays,
            "rays_unfinished": crashed, "check": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = spec.cell(spec.load(ROOT), args.workload)
    lods = world_cache.world(cell.config,
                             log=lambda *a: print(*a, file=sys.stderr))
    world_path = world_cache.path(cell.config)
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = control(cell, seed, lods, world_path)
        out.update(workload=args.workload, seconds=time.perf_counter() - t0)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
