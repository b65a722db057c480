"""The port's dynamic surface worlds (``world/dynamic.py``,
``models/dynamic_demo.py``) against the JAX package: every field of the
rebuilt world arrays, the animated heights and the terrain colors, bit for
bit, and ``DynamicTerrain`` frames against JAX's (backend "xla").  The
``cuda`` tests hold the rebuild on the card against the same build on the
CPU, and frames through the kernels against the plain path."""
import numpy as np
import pytest
import torch

from cpuvox_tpu.render import camera as cm
from cpuvox_tpu_torch.config import RenderConfig
from cpuvox_tpu_torch.models.dynamic_demo import DynamicTerrain
from cpuvox_tpu_torch.world import dynamic as td

from test_torch_frame import cuda  # noqa: F401

# test_dynamic.py's helpers are imported inside the tests that use them: it
# imports jax, which the card's machine lacks

torch.set_num_threads(1)

FIELDS = ("col_base", "grid_z", "col_rec", "runs", "runs_rev", "colors")

# tests/test_dynamic.py's specs: a flat band, random tops (past Y - 1 and
# near the floor) with and without 2x2 blocks of disjoint bands, and the
# demo terrain's; (dims, depth, lod_levels, surface)
SPECS = [
    ((16, 32, 16), 4, 3, "flat"),
    ((16, 32, 16), 5, 2, "random"),
    ((16, 32, 16), 5, 2, "multi"),
    ((32, 16, 32), 3, 6, "random"),
]


def surface(dims, depth, kind):
    from test_dynamic import _random_surface

    if kind == "flat":
        top = np.full((dims[0], dims[2]), 10, np.int32)
        return top, None
    return _random_surface(dims, depth, seed=3 + (kind == "multi"),
                           multi_interval=kind == "multi")


def port_arrays(spec, top, colors=None, device="cpu"):
    tt = torch.from_numpy(top).to(device)
    tc = (td.terrain_colors(spec, tt) if colors is None
          else torch.from_numpy(colors.view(np.int32)).to(device))
    return td.build_surface_world_arrays(spec, tt, tc)


def as_numpy(wa):
    return {k: getattr(wa, k).cpu().numpy() for k in FIELDS}


@pytest.mark.parametrize("exact_lod1", [True, False])
@pytest.mark.parametrize("dims,depth,lod_levels,kind", SPECS)
def test_surface_arrays_match_jax(dims, depth, lod_levels, kind, exact_lod1):
    import jax.numpy as jnp
    from cpuvox_tpu.world import dynamic as jd

    top, colors = surface(dims, depth, kind)
    jspec = jd.SurfaceWorldSpec(dims, depth, lod_levels, exact_lod1)
    tspec = td.SurfaceWorldSpec(dims, depth, lod_levels, exact_lod1)
    jc = (jd.terrain_colors(jspec, jnp.asarray(top)) if colors is None
          else jnp.asarray(colors))
    want = jd.build_surface_world_arrays(jspec, jnp.asarray(top), jc)
    wa = port_arrays(tspec, top, colors)
    assert wa.max_runs == jd.surface_world_max_runs(jspec)
    assert wa.occ_tiles is None and wa.rec_fwd is None
    got = as_numpy(wa)
    for k in FIELDS:
        w = np.asarray(getattr(want, k))
        if k == "colors":
            w = w.view(np.int32)
        assert got[k].shape == w.shape, k
        diff = got[k] != w
        assert not diff.any(), (f"{k}: {int(diff.sum())} words differ, first "
                                f"{np.argwhere(diff)[:5].tolist()}")
    if kind == "multi" and exact_lod1:  # LOD1 columns of more than 3 runs
        base = int(got["col_base"][1])
        assert got["col_rec"][base:base + 64, 0].max() > 3


@pytest.mark.parametrize("multi", [False, True])
def test_exact_lod1_matches_static_downsample(multi):
    """LOD1 of the port's surface world is the static builder's downsample
    of the same voxels, occupancy and colors (``rle.downsample``)."""
    from cpuvox_tpu_torch.world import rle
    from test_dynamic import (_band_soup, _dense_from_surface_level,
                              _dense_from_worldlod, _random_surface)

    dims, depth = (16, 32, 16), 5
    top, colors = _random_surface(dims, depth, seed=3 + multi,
                                  multi_interval=multi)
    wa = port_arrays(td.SurfaceWorldSpec(dims, depth, 2), top, colors)
    xz, ys, rgb = _band_soup(dims, depth, top, colors)
    static_lod1 = rle.downsample(rle.build_lod_from_voxels(dims, 0, xz, ys,
                                                           rgb), 1)
    occ_s, col_s = _dense_from_worldlod(static_lod1)
    arrays = as_numpy(wa)
    arrays["colors"] = arrays["colors"].view(np.uint32)
    occ_d, col_d = _dense_from_surface_level(
        type("WA", (), arrays), dims, 1)
    np.testing.assert_array_equal(occ_s, occ_d)
    np.testing.assert_array_equal(col_s[occ_s], col_d[occ_d])


def test_animate_heights_and_colors_match_jax():
    """At the benchmark's size (512 x 512 columns), where an ulp of the
    wave turns into a height: XLA contracts the wave's arguments into an FMA
    and takes glibc's sinf/cosf, which the port reproduces."""
    import jax.numpy as jnp
    from cpuvox_tpu.world import dynamic as jd

    dims, depth = (512, 128, 512), 6
    rng = np.random.default_rng(0)
    base = rng.integers(depth, 126, size=(512, 512)).astype(np.int32)
    jspec = jd.SurfaceWorldSpec(dims, depth, 6, False)
    tspec = td.SurfaceWorldSpec(dims, depth, 6, False)
    for t in (0.0, 0.1, 1.5, 12.25):
        want = np.asarray(jd.animate_heights(jspec, jnp.asarray(base),
                                             jnp.float32(t)))
        got = td.animate_heights(tspec, torch.from_numpy(base), t).numpy()
        assert int((got != want).sum()) == 0, f"t {t}"
    want = np.asarray(jd.terrain_colors(jspec, jnp.asarray(base)))
    got = td.terrain_colors(tspec, torch.from_numpy(base)).numpy()
    np.testing.assert_array_equal(got, want.view(np.int32))


BASE = dict(width=64, height=48, chunk_steps=8, max_march_chunks=24)
DYN_CAM = cm.Camera(position=(16, 12, 4), pitch_deg=25.0, yaw_deg=10.0)


def test_dynamic_terrain_frames_match_jax():
    from cpuvox_tpu.config import RenderConfig as JaxRenderConfig
    from cpuvox_tpu.models.dynamic_demo import DynamicTerrain as JaxTerrain

    j = JaxTerrain.create(dims=(32, 16, 32), depth=3,
                          config=JaxRenderConfig(**BASE, backend="xla"))
    t = DynamicTerrain.create(dims=(32, 16, 32), depth=3,
                              config=RenderConfig(**BASE, backend="xla",
                                                  occupancy_gate="on"),
                              device="cpu")
    assert not t.renderer.occupancy_on  # no occupancy tiles: dense
    for time in (0.0, 1.5):
        want = np.asarray(j.render_frame(time, DYN_CAM))
        got = t.render_frame(time, DYN_CAM).numpy().view(np.uint32)
        assert not (got == np.uint32(0xFFFF1493)).any()
        diff = got != want
        assert not diff.any(), f"t {time}: {int(diff.sum())} pixels differ"


@pytest.mark.cuda
@pytest.mark.parametrize("exact_lod1", [False, True])
def test_surface_rebuild_on_cuda_matches_cpu(cuda, exact_lod1):
    """The rebuild at the benchmark's size on the card, field by field
    against the CPU build (the scatter-adds with repeated indices and the
    int64 maxima included)."""
    spec = td.SurfaceWorldSpec((512, 128, 512), 6, 6, exact_lod1)
    rng = np.random.default_rng(1)
    base = rng.integers(6, 126, size=(512, 512)).astype(np.int32)
    for device_top in (torch.from_numpy(base), torch.from_numpy(base).to(cuda)):
        top = td.animate_heights(spec, device_top, 0.3)
        wa = td.build_surface_world_arrays(spec, top,
                                           td.terrain_colors(spec, top))
        if device_top.is_cuda:
            got = as_numpy(wa)
        else:
            want = as_numpy(wa)
    for k in FIELDS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("exact_lod1", [False, True])
def test_dynamic_terrain_kernels_match_plain_on_cuda(cuda, exact_lod1):
    cfg = dict(dims=(64, 32, 64), depth=4, device=cuda, exact_lod1=exact_lod1)
    cam = cm.Camera(position=(32, 24, 8), pitch_deg=25.0, yaw_deg=10.0)
    plain = DynamicTerrain.create(config=RenderConfig(**BASE, backend="xla"),
                                  **cfg)
    kern = DynamicTerrain.create(config=RenderConfig(**BASE), **cfg)
    for time in (0.0, 0.7):
        want = plain.render_frame(time, cam)
        got = kern.render_frame(time, cam)
        np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
