"""The port's ARGB mode (``argb_records=True``: the column's colors ride in
its record, kernel 2 writes final colors, phase 2 skips the resolve) against
the JAX package and against the port's own index mode.  Tolerance 0: every
texel and pixel.

- the ARGB screen == the JAX Renderer's (Pallas backend in interpret mode,
  ``argb_records=True``) == the port's index-and-resolve screen, on the
  scene and cameras of ``tests/test_pallas_kernel.py:217-250``, with the
  dense and the occupancy-gated march, in both iteration directions;
- the ARGB raybuffer == JAX ``phase1_pallas(max_col_colors=MCC)``;
- the ARGB records == JAX ``build_device_world(inline_colors=True)``'s;
- a world with more than 24 voxels in a column resolves ARGB off;
- on the card (``cuda``): the rasterizer kernel with MCC > 0 against its
  plain version, and an ARGB frame through the kernels against the CPU.

JAX is imported only inside the tests that compare with it: the card's
machine has no jax.
"""
import dataclasses

import numpy as np
import pytest
import torch

import scenes
from cpuvox_tpu_torch.config import RenderConfig
from cpuvox_tpu_torch.render import camera as cm
from cpuvox_tpu_torch.render import device as td
from cpuvox_tpu_torch.render import raymarch as trm
from cpuvox_tpu_torch.render import ray_init
from cpuvox_tpu_torch.render import segments as sg
from cpuvox_tpu_torch.render.frame import Renderer

# the tests' tensors are tiny: more threads only contend with the other
# test workers
torch.set_num_threads(1)

SCREEN = (64, 48)
BASE = dict(width=SCREEN[0], height=SCREEN[1], chunk_steps=8,
            max_march_chunks=64)
# tests/test_pallas_kernel.py:235-250's camera, and one looking up
CAMERAS = {1: ((8, 10, 8), 25.0, 70.0), -1: ((8, 13, 8), -60.0, 200.0)}
MAGENTA = np.uint32(0xFFFF1493)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m cuda")
    return torch.device("cuda")


def lods():
    return [scenes.random_world(n=300, seed=5)] * 6


def camera(direction):
    pos, pitch, yaw = CAMERAS[direction]
    return cm.Camera(position=pos, pitch_deg=pitch, yaw_deg=yaw, screen=SCREEN)


@pytest.mark.parametrize("direction", [1, -1])
@pytest.mark.parametrize("gate", ["off", "on"])
def test_argb_frame_matches_jax_and_index_mode(gate, direction):
    from cpuvox_tpu.config import RenderConfig as JaxRenderConfig
    from cpuvox_tpu.render import camera as jcm
    from cpuvox_tpu.render.frame import Renderer as JaxRenderer

    pos, pitch, yaw = CAMERAS[direction]
    jr = JaxRenderer.create(lods(), JaxRenderConfig(
        **BASE, backend="pallas", pallas_interpret=True, argb_records=True,
        occupancy_gate=gate))
    assert jr.device_world.max_col_colors > 0
    want = jr.render(jcm.Camera(position=pos, pitch_deg=pitch, yaw_deg=yaw,
                                screen=SCREEN))
    outs = {}
    for mode, argb in (("argb", True), ("index", False)):
        r = Renderer.create(lods(), RenderConfig(
            **BASE, argb_records=argb, occupancy_gate=gate), device="cpu")
        assert r.argb_on == argb and r.occupancy_on == (gate == "on")
        assert r.device_world.max_col_colors == (
            jr.device_world.max_col_colors if argb else 0)
        screen, (td_, lr, *rest) = r.render(camera(direction),
                                            return_raybuffers=True)
        assert rest[3].inverse_element_iteration_direction == (direction < 0)
        outs[mode] = (screen, td_, lr)
        diff = screen != want
        assert not diff.any(), (
            f"{mode}: {int(diff.sum())} pixels differ from the JAX ARGB "
            f"screen, first {np.argwhere(diff)[:5].tolist()}")
    # the ARGB raybuffer is the index raybuffer resolved
    for a, b in zip(outs["argb"], outs["index"]):
        assert np.array_equal(a, b)
    assert not (want == MAGENTA).any()
    assert (want != want[0, 0]).any(), "nothing was drawn"


def frame_inputs(world_lods, pos, pitch, yaw, R):
    dw = td.build_device_world(world_lods, inline_colors=True)
    cam = cm.limit_rotation_horizon(cm.Camera(
        position=pos, pitch_deg=pitch, yaw_deg=yaw, screen=SCREEN))
    lod_d, far = cm.setup_lods(cam, max(dw.dims), len(world_lods), 1.0)
    cam_data = cm.make_camera_data(cam, lod_d, far)
    vps = cm.vanishing_point_screen(cam, cm.vanishing_point_world(cam))
    segs = sg.build_segments(cam, vps)
    ctxs = sg.build_segment_contexts(cam, segs, vps)
    static, dda, alive, _ = ray_init.init_rays_np(cam_data, segs, ctxs,
                                                  dw.dims, fixed_size=R)
    direction = -1 if cam_data.inverse_element_iteration_direction else 1
    return dw, cam_data, static, dda, alive, direction


def port_phase1(dw, cam_data, static, dda, alive, direction, device="cpu",
                kernels=False, gated_cells=0):
    def put(d):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in d.items()}

    return trm.phase1(
        trm.world_arrays(dw, device), trm.RayStatic(**put(static)),
        trm.DDAState(**put(dda)), torch.from_numpy(alive).to(device),
        cam_data.lod_distances, cam_data.far_clip, dw.dims[1],
        cam_data.position[1], iteration_direction=direction, chunk=8,
        max_chunks=64, dims=dw.dims, pixel_len=max(SCREEN),
        solid_min_y=dw.solid_min_y, solid_max_y=dw.solid_max_y,
        kernels=kernels, gated_cells=gated_cells).cpu().numpy()


@pytest.mark.parametrize("direction", [1, -1])
def test_argb_raybuffer_matches_jax_phase1_pallas(direction):
    """The port's ARGB raybuffer (plain versions, dense and gated) against
    JAX ``phase1_pallas`` with ``max_col_colors`` in interpret mode, on 1,024
    ray slots (the Pallas path's quantum)."""
    import jax.numpy as jnp
    from cpuvox_tpu.render import raymarch as jrm
    from cpuvox_tpu.render.device import build_device_world

    inputs = frame_inputs(lods(), *CAMERAS[direction], R=1024)
    dw, cam_data, static, dda, alive, d = inputs
    assert d == direction and dw.max_col_colors > 0
    jdw = build_device_world(lods(), inline_colors=True)
    want = np.asarray(jrm.phase1_pallas(
        jrm.world_arrays(jdw),
        jrm.RayStatic(**{k: jnp.asarray(v) for k, v in static.items()}),
        jrm.DDAState(**{k: jnp.asarray(v) for k, v in dda.items()}),
        jnp.asarray(alive), jnp.asarray(cam_data.lod_distances),
        jnp.float32(cam_data.far_clip), float(dw.dims[1]),
        jnp.float32(cam_data.position[1]), direction, 8, 64, jdw.max_runs,
        jdw.dims, max(SCREEN), interpret=True,
        max_col_colors=jdw.max_col_colors,
        skybox_argb=int(jdw.colors[0]), solid_min_y=jdw.solid_min_y,
        solid_max_y=jdw.solid_max_y)).view(np.int32)
    for gated_cells in (0, 8):
        got = port_phase1(*inputs, gated_cells=gated_cells)
        diff = got != want
        assert not diff.any(), (
            f"gated_cells {gated_cells}: {int(diff.sum())} texels differ, "
            f"first (ray, texel): {np.argwhere(diff)[:5].tolist()}")
    # written texels carry bit 31 again; the fill is the skybox's own color
    assert (want == np.uint32(jdw.colors[0]).view(np.int32)).any()
    assert (want.view(np.uint32) >> 24 == 0xFF).all()


@pytest.mark.parametrize("scene", ["random", "deep", "layered"])
def test_argb_records_match_jax(scene):
    from cpuvox_tpu.render import device as jd
    from cpuvox_tpu_torch.models.procedural import layered_world

    from test_torch_copies import SMALL_LAYERED, assert_same

    world = {"random": lods, "deep": scenes.deep_tower_world,
             "layered": lambda: layered_world(**SMALL_LAYERED)}[scene]()
    a = td.build_device_world(world, inline_colors=True)
    b = jd.build_device_world(world, inline_colors=True)
    for f in dataclasses.fields(a):
        assert_same(getattr(a, f.name), getattr(b, f.name), f.name)
    assert td.INLINE_MAX_COLORS == jd.INLINE_MAX_COLORS
    assert 0 < a.max_col_colors <= td.INLINE_MAX_COLORS
    # every scene here packs its runs 16-bit ahead of the colors; the plain
    # int32 run region is held by the frames of the other tests
    assert td.packed_run_words(a.max_runs, a.max_col_colors) != a.max_runs
    for m in range(1, 62):
        for cc in (0, 1, 6, 13, 24):
            assert td.packed_run_words(m, cc) == jd.packed_run_words(m, cc)
    if a.max_col_colors:
        rw = td.packed_run_words(a.max_runs, a.max_col_colors)
        colors = a.rec_fwd[:, td.REC_META + rw:][:, :a.max_col_colors]
        assert (colors >= 0).all(), "inline colors ride with bit 31 cleared"


@pytest.mark.parametrize("pos,pitch,yaw", [((-4, 40, 20), 20.0, 60.0),
                                           ((30, 6, 30), -30.0, 120.0)])
def test_argb_with_packed_runs_matches_index_mode(pos, pitch, yaw):
    """Deep towers: 16-bit packed runs and 23 inline colors in one record,
    through the gated march (the world is mostly empty)."""
    cam = cm.Camera(position=pos, pitch_deg=pitch, yaw_deg=yaw, screen=SCREEN)
    frames = []
    for argb in (True, False):
        r = Renderer.create(scenes.deep_tower_world(),
                            RenderConfig(**BASE, argb_records=argb),
                            device="cpu")
        assert r.argb_on == argb and r.occupancy_on
        frames.append(r.render(cam, return_raybuffers=True))
    (sa, (tda, lra, *_)), (si, (tdi, lri, *_)) = frames
    assert np.array_equal(sa, si) and np.array_equal(tda, tdi)
    assert np.array_equal(lra, lri)
    assert (sa != sa[0, 0]).any(), "nothing was drawn"


def test_world_over_24_colors_resolves_argb_off():
    """A column of 30 voxels is over ``INLINE_MAX_COLORS``: the records carry
    no colors, ARGB mode stays off and the frame is index mode's."""
    from cpuvox_tpu_torch.world import rle

    dims = (16, 64, 16)
    ys = np.arange(30)
    xz = np.full(30, 5 * dims[2] + 7)
    rgb = tuple(np.full(30, v, np.uint8) for v in (200, 90, 30))
    tall = rle.build_lod_from_voxels(dims, 0, xz, ys, rgb)
    cam = cm.Camera(position=(8, 20, -6), pitch_deg=10.0, yaw_deg=0.0,
                    screen=SCREEN)
    frames = []
    for argb in (True, False):
        r = Renderer.create([tall] * 6, RenderConfig(**BASE, argb_records=argb),
                            device="cpu")
        assert not r.argb_on and r.device_world.max_col_colors == 0
        assert r._wa.rec_fwd.shape == r.device_world.rec_fwd.shape
        frames.append(r.render(cam))
    assert np.array_equal(*frames)
    assert (frames[0] != frames[0][0, 0]).any(), "nothing was drawn"


# ------------------------------------------------------------- on the card


def terrain_renderer(device, **kw):
    from cpuvox_tpu_torch.models.procedural import heightmap_world

    world = heightmap_world(dims=(256, 64, 256), seed=3, shell_depth=6,
                            lod_levels=6)
    return Renderer.create(world, RenderConfig(width=160, height=120, **kw),
                           device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [0.35, 0.6])
def test_argb_raster_kernel_matches_plain_on_cuda(cuda, t):
    """The rasterizer kernel with MCC > 0 on a mid-march chunk of a terrain
    frame: the raybuffer and all 8 state fields equal the plain version's."""
    from cpuvox_tpu_torch.bench import path as bench_path
    from cpuvox_tpu_torch.bench.capture import capture, clone
    from cpuvox_tpu_torch.ops import phase1_kernel

    r = terrain_renderer(cuda, argb_records=True)
    mcc = r.device_world.max_col_colors
    assert r.argb_on and mcc > 0
    cam = bench_path.benchmark_camera(t * bench_path.BENCH_CLIP_LENGTH,
                                      r.device_world.dims, r.render_wh)
    cap = capture(r, cam, k=2)
    assert cap.cells.colors.shape[-1] == mcc
    args = (cap.cells, cap.frame.static, cap.consts,
            cap.frame.iteration_direction)
    before = phase1_kernel.chunk_launches
    got = phase1_kernel.rasterize_chunk(clone(cap.rs), *args, index=cap.index)
    torch.cuda.synchronize()
    assert phase1_kernel.chunk_launches == before + 1
    want = phase1_kernel.rasterize_chunk_ref(clone(cap.rs), *args,
                                             index=cap.index)
    for k, x, y in zip(trm.RasterState._fields, got, want):
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), k
    assert (want.raybuf >= 0).sum() > (cap.rs.raybuf >= 0).sum()


@pytest.mark.cuda
@pytest.mark.parametrize("gate", ["off", "on"])
def test_argb_frame_on_cuda_matches_cpu_and_index_mode(cuda, gate):
    from cpuvox_tpu_torch.bench import path as bench_path

    frames = {}
    for name, device, argb in (("cuda argb", cuda, True),
                               ("cpu argb", "cpu", True),
                               ("cuda index", cuda, False)):
        r = terrain_renderer(device, argb_records=argb, occupancy_gate=gate)
        cam = bench_path.benchmark_camera(0.35 * bench_path.BENCH_CLIP_LENGTH,
                                          r.device_world.dims, r.render_wh)
        frames[name] = r.render(cam)
    assert np.array_equal(frames["cuda argb"], frames["cpu argb"])
    assert np.array_equal(frames["cuda argb"], frames["cuda index"])
    assert not (frames["cuda argb"] == MAGENTA).any()
