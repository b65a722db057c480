"""The benchmark's frozen copies equal the program's at a small size: the
world generator with its LOD chain, the path, and the reference frame."""
import dataclasses

import numpy as np
import pytest

from voxbench import path as vpath
from voxbench.reference import camera as vcam
from voxbench.reference import frame as rf
from voxbench.reference import segments as vseg
from voxbench.worldgen import procedural as vproc


def _same_world(a, b):
    assert len(a) == len(b)
    for wa, wb in zip(a, b):
        for f in dataclasses.fields(wa):
            x, y = getattr(wa, f.name), getattr(wb, f.name)
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype and np.array_equal(x, y), f.name
            else:
                assert x == y, f.name


@pytest.mark.parametrize("build,kw", [
    ("heightmap_world", dict(dims=(64, 32, 64), seed=1234, shell_depth=9, lod_levels=6)),
    ("layered_world", dict(dims=(64, 64, 64), seed=99, shell_depth=8, n_layers=5,
                           lod_levels=6, footprint=0.55)),
])
def test_generator_equals_the_program(build, kw):
    from cpuvox_tpu_torch.models import procedural

    _same_world(getattr(vproc, build)(**kw), getattr(procedural, build)(**kw))


def test_generators_by_name_equal_the_frozen_functions():
    from voxbench.worldgen import cache

    kw = dict(dims=(64, 32, 64), seed=3, shell_depth=4, lod_levels=4)
    _same_world(cache.generator("heightmap_world").build(**kw),
                vproc.heightmap_world(kw["dims"], seed=3, shell_depth=4, lod_levels=4))


def test_world_cache_round_trip(tmp_path):
    from voxbench.worldgen import cache

    conf = {"name": "w", "generator": "heightmap_world",
            "params": {"dims": [32, 16, 32], "seed": 2, "shell_depth": 3, "lod_levels": 3}}
    a = cache.world(conf, str(tmp_path), log=lambda *x: None)
    b = cache.world(conf, str(tmp_path), log=lambda *x: None)
    _same_world(a, b)
    assert len(list(tmp_path.iterdir())) == 1


def test_path_equals_the_program():
    from cpuvox_tpu_torch.bench import path

    for t in np.linspace(0.0, path.BENCH_CLIP_LENGTH, 23):
        cam = path.benchmark_camera(float(t), (2048, 256, 2048), (1920, 1080))
        pose = vpath.benchmark_pose(float(t), (2048, 256, 2048))
        assert pose == dict(position=cam.position, pitch_deg=cam.pitch_deg,
                            yaw_deg=cam.yaw_deg, roll_deg=cam.roll_deg)


def test_reference_frame_equals_the_program_oracle():
    """The frozen camera, segments and oracle give the program's oracle
    frame: every raybuffer row and every screen pixel."""
    from cpuvox_tpu_torch.render import camera as pcam, oracle as porc
    from cpuvox_tpu_torch.render import segments as pseg
    from cpuvox_tpu_torch.world.rle import WorldLOD

    dims = (64, 32, 64)
    lods = vproc.heightmap_world(dims, seed=5, shell_depth=4, lod_levels=4)
    plods = [WorldLOD(**{f.name: getattr(w, f.name) for f in dataclasses.fields(w)})
             for w in lods]
    render = {"fov_y_deg": 85.0, "near_clip": 0.05, "lod_levels": 4, "lod_error": 1.0}
    wh = (48, 32)
    first = vpath.benchmark_pose(0.0, dims)
    lod_far = rf.lod_distances(first, render, wh, max(dims))
    for t in (0.2, 0.55, 0.8, 1.1):
        pose = vpath.benchmark_pose(t, dims)
        g = rf.geometry(pose, render, wh, lod_far)
        cam = pcam.limit_rotation_horizon(pcam.Camera(
            **pose, fov_y_deg=85.0, near=0.05, screen=wh))
        d, far = pcam.setup_lods(pcam.limit_rotation_horizon(pcam.Camera(
            **first, fov_y_deg=85.0, near=0.05, screen=wh)), 64, 4, 1.0)
        cd = pcam.make_camera_data(cam, d, far)
        vp = pcam.vanishing_point_screen(cam, pcam.vanishing_point_world(cam))
        segs = pseg.build_segments(cam, vp)
        ctxs = pseg.build_segment_contexts(cam, segs, vp)
        assert np.array_equal(g.cam_data.world_to_screen, cd.world_to_screen)
        assert [s.ray_count for s in g.segs] == [s.ray_count for s in segs]
        td, lr = porc.render_raybuffers_oracle(plods, cam, cd, segs, ctxs)
        rows = np.full((g.n_topdown + lr.shape[0], max(wh)), 0, np.uint32)
        rows[:g.n_topdown, :wh[1]] = td
        rows[g.n_topdown:, :wh[0]] = lr
        for si, i, row in g.rays():
            ref = rf.ray_row(lods, g, si, i)
            assert np.array_equal(ref, rows[row, :ref.shape[0]]), (t, si, i)
        screen = porc.reproject_oracle(cam, segs, ctxs, vp, td, lr)
        from voxbench.reference import check
        assert np.array_equal(check.expected_screen(g, rows), screen), t
        assert isinstance(g.cam, vcam.Camera) and vseg.SegmentData is not pseg.SegmentData
