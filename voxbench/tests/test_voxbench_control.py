"""The control, the reference in float16 put in the program's place, comes
out as not correct through the harness's own comparison, at a size a test
run holds; the reference in its own float32 passes it."""
import json

import numpy as np
import pytest

from voxbench import control, spec
from voxbench.reference import check, rows
from voxbench.reference import frame as rf
from voxbench.worldgen import cache


def _cell(tiny_dir):
    b = spec.load(str(tiny_dir))
    cell = spec.cell(b, "tiny-ahead", root=str(tiny_dir),
                     traffic_dir=str(tiny_dir / "traffic"))
    cdir = str(tiny_dir / "cache")
    lods = cache.world(cell.config, cdir, log=lambda *a: None)
    return cell, lods, cache.path(cell.config, cdir)


@pytest.mark.parametrize("seed", [1, 2**31 + 5, 77777777777])
def test_the_control_fails(tiny_dir, seed):
    cell, lods, path = _cell(tiny_dir)
    out = control.control(cell, seed, lods, path)
    assert not out["correct"], json.dumps(out)
    assert out["check"]["rays_checked"]["value"] == 24
    assert out["check"]["texels_off"]["value"] > 0, json.dumps(out)
    # the reference in its own precision, in the same place, is correct
    same = control.control(cell, seed, lods, path, dtype=np.float32)
    assert same["correct"] and same["rays_unfinished"] == 0, json.dumps(same)


def test_worker_rows_equal_the_rows_in_process(tiny_dir):
    cell, lods, path = _cell(tiny_dir)
    render = cell.config["render"]
    wh = (cell.traffic["width"], cell.traffic["height"])
    from voxbench import path as bench_path

    pose = bench_path.benchmark_pose(0.6, lods[0].dims)
    g = rf.geometry(pose, render, wh, rf.lod_distances(pose, render, wh, 64))
    job = [(g, [(si, i) for si, i, _ in g.rays()[:40]])]
    here = rows.rows(path, lods, job, n_workers=1)[0]
    there = rows.rows(path, lods, job, n_workers=2, chunk=8)[0]
    assert len(here) == len(there) == 40
    assert all(np.array_equal(a, b) for a, b in zip(here, there))


def test_the_drawn_rays_cover_every_segment_and_range(tiny_dir):
    cell, lods, _path = _cell(tiny_dir)
    render = cell.config["render"]
    wh = (cell.traffic["width"], cell.traffic["height"])
    from voxbench import path as bench_path

    pose = bench_path.benchmark_pose(0.6, lods[0].dims)
    g = rf.geometry(pose, render, wh, rf.lod_distances(pose, render, wh, 64))
    every = g.rays()
    picked = check.pick_rays(g, 16, np.random.default_rng(3))
    assert len(picked) == 16 and len(set(picked)) == 16
    segs = {si for si, _, _ in every}
    assert {si for si, _, _ in picked} == segs
    # one ray in each sixteenth of the raybuffer's rows
    pos = sorted(every.index(p) for p in picked)
    edges = np.linspace(0, len(every), 17).astype(int)
    assert all(a <= p < b for p, a, b in zip(pos, edges[:-1], edges[1:]))
    assert check.pick_rays(g, len(every) + 5, np.random.default_rng(3)) == every
