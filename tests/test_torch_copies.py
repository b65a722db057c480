"""The port's copies of the JAX package's host-side numpy modules against
their originals: the same inputs give the same arrays, bit for bit.

The port imports nothing of ``cpuvox_tpu``; it carries its own copies of
``config``, ``models/procedural``, ``render/{camera,segments,device,oracle}``,
``utils/colors``, ``world/{rle,save}``, ``bench/path`` and
``render/device_init.build_frame_params``.  Each case below
runs one piece of a copy and of its original on the same inputs.
"""
import dataclasses

import numpy as np
import pytest

import scenes

SMALL_LAYERED = dict(dims=(64, 64, 64), seed=99, shell_depth=4, n_layers=6,
                     lod_levels=4, footprint=0.55)


def assert_same(a, b, what):
    """Equal values, bit for bit where they are float arrays."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, what
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name),
                        f"{what}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype,
                                                           b.dtype)
        if a.dtype.kind == "f":
            a, b = a.view(np.uint8), b.view(np.uint8)
        assert np.array_equal(a, b), what
    else:
        assert a == b or (a != a and b != b), (what, a, b)


def case_config():
    from cpuvox_tpu.config import RenderConfig as Jax
    from cpuvox_tpu_torch.config import RenderConfig as Port

    jax_fields = {f.name: f.default for f in dataclasses.fields(Jax)}
    for f in dataclasses.fields(Port):
        assert f.name in jax_fields, f.name
        if f.name == "host_init":
            # the one default that differs: on the H100 the numpy host init
            # is faster than the device init (cpuvox_tpu_torch/config.py)
            assert f.default is True and jax_fields[f.name] is False
            continue
        assert f.default == jax_fields[f.name], f.name
    assert Port().screen == Jax().screen
    assert Port().far_clip_multiplier == Jax().far_clip_multiplier


def _device_world(lods_fn):
    from cpuvox_tpu.render import device as jd
    from cpuvox_tpu_torch.render import device as td

    lods = lods_fn()
    a, b = td.build_device_world(lods), jd.build_device_world(lods)
    for f in dataclasses.fields(a):
        assert_same(getattr(a, f.name), getattr(b, f.name), f.name)
    assert a.rec_fwd is not None and a.occ_tiles is not None
    assert a.col_rec is None and a.max_col_colors == 0
    for k in ("REC_META", "INLINE_MAX_RUNS", "OCC_TILE_X", "OCC_TILE_Z",
              "OCC_ROW"):
        assert getattr(td, k) == getattr(jd, k), k
    for m in range(1, 62):
        assert td.packed_run_words(m) == jd.packed_run_words(m), m


def case_device_deep_tower():
    _device_world(scenes.deep_tower_world)


def case_device_layered():
    from cpuvox_tpu.models.procedural import layered_world

    _device_world(lambda: layered_world(**SMALL_LAYERED))


CAMERAS = [((8.0, 10.0, 8.0), 25.0, 70.0, 0.0, (64, 48)),
           ((-6.0, 9.0, -6.0), 30.0, 45.0, 0.0, (64, 48)),
           ((8.0, 13.0, 8.0), -60.0, 200.0, 0.0, (96, 64)),
           ((30.0, 36.0, 20.0), 35.0, 200.0, 190.0, (80, 60)),
           ((8.5, 5.0, 2.0), 0.0, 0.0, 0.0, (64, 48))]


def _frame_geometry(cmod, smod, pos, pitch, yaw, roll, screen):
    cam = cmod.limit_rotation_horizon(cmod.Camera(
        position=pos, pitch_deg=pitch, yaw_deg=yaw, roll_deg=roll,
        screen=screen))
    lod_d, far = cmod.setup_lods(cam, 64, 6, 1.0)
    cd = cmod.make_camera_data(cam, lod_d, far)
    vps = cmod.vanishing_point_screen(cam, cmod.vanishing_point_world(cam))
    segs = smod.build_segments(cam, vps)
    ctxs = smod.build_segment_contexts(cam, segs, vps)
    dirs = [smod.ray_directions(s) for s in segs if s.ray_count > 0]
    return [cam, lod_d, far, cd, vps, segs, ctxs, dirs,
            cmod.world_to_screen_matrix(cam),
            cmod.screen_point_to_ray(cam, (10.5, 7.5))]


def case_camera_and_segments():
    from cpuvox_tpu.render import camera as jc, segments as js
    from cpuvox_tpu_torch.render import camera as tc, segments as ts

    for args in CAMERAS:
        assert_same(_frame_geometry(tc, ts, *args),
                    _frame_geometry(jc, js, *args), str(args))


def case_device_split_layout():
    """More than 60 runs in a column: the split layout's meta records and
    flat run arrays."""
    from cpuvox_tpu.render import device as jd
    from cpuvox_tpu_torch.render import device as td

    from test_torch_frame import split_layout_world

    lods = [split_layout_world()] * 6
    a, b = td.build_device_world(lods), jd.build_device_world(lods)
    for f in dataclasses.fields(a):
        assert_same(getattr(a, f.name), getattr(b, f.name), f.name)
    assert a.rec_fwd is None and a.col_rec.shape[1] == td.REC == jd.REC
    assert a.runs.shape == a.runs_rev.shape and a.max_runs > 60


def case_frame_params():
    """``device_init.build_frame_params``: the per-frame table of the device
    ray init."""
    from cpuvox_tpu.render import camera as jc, device_init as jdi
    from cpuvox_tpu.render import segments as js
    from cpuvox_tpu_torch.render import camera as tc, device_init as tdi
    from cpuvox_tpu_torch.render import segments as ts

    assert tdi.FrameParams._fields == jdi.FrameParams._fields
    for args in CAMERAS:
        _, _, _, cd, _, segs, ctxs, *_ = _frame_geometry(tc, ts, *args)
        _, _, _, jcd, _, jsegs, jctxs, *_ = _frame_geometry(jc, js, *args)
        a = tdi.build_frame_params(cd, segs, ctxs)
        b = jdi.build_frame_params(jcd, jsegs, jctxs)
        for name, x, y in zip(a._fields, a, b):
            assert_same(np.atleast_1d(x), np.atleast_1d(np.asarray(y)),
                        f"{args} {name}")


def case_benchmark_path():
    import importlib.util
    import os

    import cpuvox_tpu
    from cpuvox_tpu_torch.bench import path as tp

    # cpuvox_tpu/bench/__init__.py imports the JAX harness: load path.py alone
    spec = importlib.util.spec_from_file_location(
        "_jax_bench_path",
        os.path.join(os.path.dirname(cpuvox_tpu.__file__), "bench", "path.py"))
    jp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jp)
    assert tp.BENCH_CLIP_LENGTH == jp.BENCH_CLIP_LENGTH
    for t in np.linspace(0.0, jp.BENCH_CLIP_LENGTH, 7):
        for dims, wh in (((2048, 256, 2048), (1920, 1080)),
                         ((2048, 512, 2048), (320, 180))):
            a = tp.benchmark_camera(float(t), dims, wh)
            b = jp.benchmark_camera(float(t), dims, wh)
            assert_same(a, b, f"t={t}")


def case_procedural_worlds():
    from cpuvox_tpu.models import procedural as jp
    from cpuvox_tpu_torch.models import procedural as tp

    for name, kw in (("heightmap_world", dict(dims=(64, 64, 64), seed=3,
                                              shell_depth=6, lod_levels=6)),
                     ("layered_world", dict(SMALL_LAYERED)),
                     ("layered_world", dict(dims=(64, 64, 64), seed=5,
                                            n_layers=5, lod_levels=3))):
        assert_same(getattr(tp, name)(**kw), getattr(jp, name)(**kw), name)


def case_rle_save_round_trip(tmp_path):
    from cpuvox_tpu.world import rle as jr, save as js
    from cpuvox_tpu_torch.world import rle as tr, save as ts

    rng = np.random.default_rng(7)
    dims = (32, 32, 32)
    xz = rng.integers(0, 32 * 32, 900)
    y = rng.integers(0, 32, 900)
    rgb = tuple(rng.integers(0, 256, 900).astype(np.uint8) for _ in range(3))
    a = tr.build_lod_chain(tr.build_lod_from_voxels(dims, 0, xz, y, rgb), 4)
    b = jr.build_lod_chain(jr.build_lod_from_voxels(dims, 0, xz, y, rgb), 4)
    assert_same(a, b, "lod chain")
    for w in a:
        tr.validate_world(w)
    assert_same(tr.get_column(a[0], 3, 5), jr.get_column(b[0], 3, 5), "column")
    ts.save_world(str(tmp_path / "port.world"), a)
    js.save_world(str(tmp_path / "jax.world"), b)
    assert ((tmp_path / "port.world").read_bytes()
            == (tmp_path / "jax.world").read_bytes())
    assert_same(ts.load_world(str(tmp_path / "jax.world")), b, "port load")
    assert_same(js.load_world(str(tmp_path / "port.world")), a, "jax load")


def case_expand_lod0():
    from cpuvox_tpu.world import dynamic as jd
    from cpuvox_tpu_torch.world import dynamic as td

    for w in (scenes.random_world(dims=(16, 16, 16), n=250, seed=3),
              scenes.deep_tower_world()[0], scenes.flat_floor_world()):
        assert_same(td._expand_lod0(w), jd._expand_lod0(w), "voxel soup")


def case_oracle_frame():
    from cpuvox_tpu.render import camera as jc, oracle as jo, segments as js
    from cpuvox_tpu.utils import colors as jcol
    from cpuvox_tpu_torch.render import camera as tc, oracle as to
    from cpuvox_tpu_torch.render import segments as ts
    from cpuvox_tpu_torch.utils import colors as tcol

    lods = [scenes.random_world(n=300, seed=5)] * 6
    out = []
    for cmod, smod, omod in ((tc, ts, to), (jc, js, jo)):
        cam, lod_d, far, cd, vps, segs, ctxs, *_ = _frame_geometry(
            cmod, smod, (8.0, 10.0, 8.0), 25.0, 70.0, 0.0, (32, 24))
        td, lr = omod.render_raybuffers_oracle(lods, cam, cd, segs, ctxs)
        out.append([td, lr, omod.reproject_oracle(cam, segs, ctxs, vps, td,
                                                  lr)])
    assert_same(out[0], out[1], "oracle frame")
    assert (out[0][2] != tcol.SKYBOX).any()
    assert tcol.SKYBOX == jcol.SKYBOX and tcol.DEBUG_MAGENTA == jcol.DEBUG_MAGENTA
    assert_same(tcol.to_rgb_image(out[0][2]), jcol.to_rgb_image(out[1][2]),
                "rgb")
    assert_same(tcol.unpack_argb(out[0][2]), jcol.unpack_argb(out[1][2]),
                "unpack")


CASES = {k[5:]: v for k, v in sorted(globals().items())
         if k.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_copy_matches_original(name, tmp_path):
    fn = CASES[name]
    if "tmp_path" in fn.__code__.co_varnames[:fn.__code__.co_argcount]:
        fn(tmp_path)
    else:
        fn()
