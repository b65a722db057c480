"""The control of the comparison that decides ``correct``: the plain reference,
computed in float16, the precision below the float32 the renderer states,
put in the program's place.  It has to come out as not correct.

    python3 voxbench/control.py --workload <name> --seeds <n> [<n> ...]

For each seed it takes ``check_frames`` cameras of the cell's traffic (of a
camera-batch mix: ``check_cameras`` agents in each of ``check_steps``
steps) at the cell's own size and renders each as the program would, in
float16: every ray's raybuffer row by the float16 oracle (a ray the float16
march cannot finish leaves its row unwritten) and the screen by the float16
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
from voxbench.traffic import Agents, Flythrough  # noqa: E402
from voxbench.worldgen import cache as world_cache  # noqa: E402

# the steps a camera-batch mix's control draws its kept steps from: some
# ten seconds of steps at the throughput the batch reaches on the card
CONTROL_STEPS = 128


def render(world_path: str, lods, geoms: list, dtype, n_workers=None):
    """The reference's frames in ``dtype`` as the program hands them over,
    their rays in one pool: for each geometry (screen (h, w), raybuffer
    (R, max(w, h)), both uint32 ARGB; the rays that could not finish)."""
    every = [g.rays() for g in geoms]
    got = rows.rows(world_path, lods, [
        (g, [(si, i) for si, i, _ in rays]) for g, rays in zip(geoms, every)],
        dtype, n_workers)
    out = []
    for g, rays, rows_g in zip(geoms, every, got):
        w, h = g.render_wh
        raybuf = np.full((len(rays), max(w, h)), DEBUG_MAGENTA, np.uint32)
        crashed = 0
        for (_si, _i, row), r in zip(rays, rows_g):
            if r is None:
                crashed += 1
                continue
            raybuf[row, :r.shape[0]] = r
        screen = check.expected_screen(g, raybuf, rf.pixel_texels(g, dtype))
        out.append((screen, raybuf, crashed))
    return out


def control(cell: spec.Cell, seed: int, lods, world_path: str,
            dtype=np.float16, n_workers=None) -> dict:
    """The control's reading for one seed: the harness's numbers and verdict
    on the reference rendered in ``dtype``."""
    tr, render_cfg = cell.traffic, cell.config["render"]
    wh = rf.render_wh(tr["width"], tr["height"], render_cfg["render_scale"])
    rng = np.random.default_rng([int(seed), 2])
    if tr["entry"] == "render_camera_batch":
        first, poses = batch_poses(tr, lods, seed, rng)
    else:
        fly = Flythrough(tr, lods[0].dims, seed)
        first = fly.warmup()[0]
        frames = sorted(rng.choice(len(fly.passes), size=tr["check_frames"],
                                   replace=False))
        poses = [fly.pose(int(j)) for j in frames]
    lod_far = rf.lod_distances(first, render_cfg, wh, max(lods[0].dims))
    geoms = [rf.geometry(p, render_cfg, wh, lod_far) for p in poses]
    picks = [check.pick_rays(g, tr["check_rays"], rng) for g in geoms]
    ref_rows = rows.rows(world_path, lods, [
        (g, [(si, i) for si, i, _ in p]) for g, p in zip(geoms, picks)],
        n_workers=n_workers)
    numbers, crashed, n_rays = [], 0, 0
    for g, rays, ref, (screen, raybuf, c) in zip(
            geoms, picks, ref_rows,
            render(world_path, lods, geoms, dtype, n_workers)):
        crashed += c
        n_rays += raybuf.shape[0]
        numbers.append(check.frame_numbers(lods, g, screen, raybuf, rays,
                                           ref_rows=ref))
    correct, out = check.judge(numbers)
    return {"seed": seed, "dtype": np.dtype(dtype).name,
            "correct": bool(correct), "rays_rendered": n_rays,
            "rays_unfinished": crashed, "check": out}


def batch_poses(tr: dict, lods, seed: int, rng: np.random.Generator):
    """A camera-batch mix's kept cameras, as a run keeps them: ``check_steps``
    steps drawn from the seed among the first ``CONTROL_STEPS`` (a window's
    worth), in each ``check_cameras`` agents drawn from the seed.  Returns
    (the first pose, which fixes the LOD distances; the kept poses)."""
    agents = Agents(tr, lods[0], seed)
    rng_cam = np.random.default_rng([int(seed), 3])
    steps = sorted(rng.choice(CONTROL_STEPS, size=tr["check_steps"],
                              replace=False))
    poses = []
    for j in steps:
        step = agents.step(int(j))
        chosen = rng_cam.choice(agents.n, size=min(tr["check_cameras"],
                                                   agents.n), replace=False)
        poses += [step[int(i)] for i in sorted(chosen)]
    return agents.first_pose(), poses


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
