"""Live-ray compaction in the port's marches: the roll, the gate, the fetch
and the rasterizer work on a live-ray index, rebuilt when the live count has
halved, and nothing else changes.  Tolerance 0 everywhere, f32 as bits.

- ``march`` and ``march_gated`` with and without compaction: the same
  raybuffer and the same 8 state fields, and after the skybox fill JAX
  ``raymarch.phase1``'s raybuffer, on deep RLE towers, a small layered world
  and a terrain, in both iteration directions; the index is rebuilt at least
  twice on the way;
- the plain roll and rasterizer with an index == without it on the indexed
  rays, and leave every other ray untouched;
- the Renderer compacts only where it is asked to, with the same frame;
- on the card (``cuda``): both kernels with an index against their plain
  versions, on a capture with under half the rays alive.

JAX is imported only inside the tests that compare with it.
"""
import numpy as np
import pytest
import torch

import scenes
from cpuvox_tpu_torch.render import camera as cm
from cpuvox_tpu_torch.render import device as td
from cpuvox_tpu_torch.render import raymarch as trm
from cpuvox_tpu_torch.render import ray_init
from cpuvox_tpu_torch.render import segments as sg

# the tests' tensors are tiny: more threads only contend with the other
# test workers
torch.set_num_threads(1)

SCREEN = (64, 48)
R = 384  # 3 * (64 + 48) rays, padded to 128
SMALL_LAYERED = dict(dims=(64, 64, 64), seed=99, shell_depth=4, n_layers=6,
                     lod_levels=4, footprint=0.55)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m cuda")
    return torch.device("cuda")


def lods_for(scene):
    from cpuvox_tpu_torch.models.procedural import (heightmap_world,
                                                    layered_world)

    if scene == "deep":
        return scenes.deep_tower_world()
    if scene == "layered":
        return layered_world(**SMALL_LAYERED)
    return heightmap_world(dims=(128, 32, 128), seed=3, shell_depth=6,
                           lod_levels=6)


def frame_inputs(lods, pos, pitch, yaw):
    dw = td.build_device_world(lods)
    cam = cm.limit_rotation_horizon(cm.Camera(
        position=pos, pitch_deg=pitch, yaw_deg=yaw, screen=SCREEN))
    lod_d, far = cm.setup_lods(cam, max(dw.dims), len(lods), 1.0)
    cam_data = cm.make_camera_data(cam, lod_d, far)
    vps = cm.vanishing_point_screen(cam, cm.vanishing_point_world(cam))
    segs = sg.build_segments(cam, vps)
    ctxs = sg.build_segment_contexts(cam, segs, vps)
    static, dda, alive, _ = ray_init.init_rays_np(cam_data, segs, ctxs,
                                                  dw.dims, fixed_size=R)
    direction = -1 if cam_data.inverse_element_iteration_direction else 1
    return dw, cam_data, static, dda, alive, direction


def put(d, device="cpu"):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in d.items()}


def run_march(dw, cam_data, static, dda, alive, direction, gated_cells,
              compact, chunk):
    """The march alone (no skybox fill): the final ``RasterState`` and the
    number of index rebuilds."""
    st = trm.RayStatic(**put(static))
    rs = trm.init_raster_state(st, max(SCREEN))
    consts = trm.raster_consts(dw.dims[1], cam_data.position[1],
                               dw.solid_min_y, dw.solid_max_y, "cpu")
    args = (trm.world_arrays(dw, "cpu"), st, trm.DDAState(**put(dda)),
            torch.from_numpy(alive), rs,
            torch.from_numpy(cam_data.lod_distances),
            float(np.float32(cam_data.far_clip)), dw.dims, consts, direction,
            chunk, 3 * max(dw.dims) + 64)
    n0 = trm.compact_stats["rebuilds"]
    if gated_cells:
        rs = trm.march_gated(*args, group_cells=gated_cells, kernels=False,
                             compact=compact)
    else:
        rs = trm.march(*args, kernels=False, compact=compact)
    return rs, trm.compact_stats["rebuilds"] - n0


def run_jax(lods, cam_data, static, dda, alive, direction):
    import jax.numpy as jnp
    from cpuvox_tpu.render import raymarch as jrm
    from cpuvox_tpu.render.device import build_device_world

    dw = build_device_world(lods)
    rb = jrm.march_jit(
        jrm.world_arrays(dw),
        jrm.RayStatic(**{k: jnp.asarray(v) for k, v in static.items()}),
        jrm.DDAState(**{k: jnp.asarray(v) for k, v in dda.items()}),
        jnp.asarray(alive), jnp.asarray(cam_data.lod_distances),
        jnp.float32(cam_data.far_clip), jnp.float32(dw.dims[1]),
        jnp.float32(cam_data.position[1]), iteration_direction=direction,
        chunk=8, max_chunks=128, max_runs=dw.max_runs, dims=dw.dims,
        pixel_len=max(SCREEN), solid_min_y=dw.solid_min_y,
        solid_max_y=dw.solid_max_y)
    return np.asarray(rb)


def assert_states_equal(a, b, what):
    for k, x, y in zip(trm.RasterState._fields, a, b):
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), (
            f"{what}: {k} differs in {int((x != y).sum())} elements")


# (name, world, camera position, pitch, yaw, iteration direction)
MARCH_CASES = [
    ("deep_down", "deep", (-4, 40, 20), 20.0, 60.0, 1),
    ("deep_up", "deep", (30, 6, 30), -30.0, 120.0, -1),
    ("layered_down", "layered", (-6, 70, 10), 30.0, 45.0, 1),
    ("layered_up", "layered", (40, 8, 30), -35.0, 200.0, -1),
    ("terrain_down", "terrain", (20, 30, 20), 25.0, 40.0, 1),
    ("terrain_up", "terrain", (64, 4, 64), -30.0, 200.0, -1),
]


@pytest.mark.parametrize("name,scene,pos,pitch,yaw,direction", MARCH_CASES)
def test_compacted_marches_match_uncompacted_and_jax(name, scene, pos, pitch,
                                                     yaw, direction):
    lods = lods_for(scene)
    inputs = frame_inputs(lods, pos, pitch, yaw)
    dw, _cam_data, static, *_ = inputs
    assert inputs[-1] == direction
    want = run_jax(lods, *inputs[1:])
    orig_min = torch.from_numpy(static["orig_min"])[:, None]
    orig_max = torch.from_numpy(static["orig_max"])[:, None]
    pix = torch.arange(max(SCREEN), dtype=torch.int32)[None, :]
    in_range = (pix >= orig_min) & (pix <= orig_max)
    rebuilds = {}
    for march, gated_cells, chunk in (("dense", 0, 8), ("gated", 4, 32)):
        full, n_full = run_march(*inputs, gated_cells, False, chunk)
        comp, n_comp = run_march(*inputs, gated_cells, True, chunk)
        assert n_full == 0
        rebuilds[march] = n_comp
        assert_states_equal(comp, full, f"{name} {march}")
        filled = torch.where((comp.raybuf < 0) & in_range, 0, comp.raybuf)
        diff = filled.numpy() != want
        assert not diff.any(), (
            f"{name} {march}: {int(diff.sum())} texels differ from JAX, "
            f"first (ray, texel): {np.argwhere(diff)[:5].tolist()}")
    assert (want > 0).any(), f"{name}: nothing was drawn"
    # the frame starts with under half its slots alive and dies off slowly
    assert min(rebuilds.values()) >= 2, rebuilds


def test_live_index_is_ascending_and_rebuilt_on_halving():
    rng = np.random.default_rng(4)
    mask = torch.from_numpy(rng.random(384) < 0.3)
    n = int(mask.sum())
    idx = trm.live_index(mask, n)
    assert idx.dtype == torch.int32 and idx.shape == (n,)
    assert torch.equal(idx.long(), torch.nonzero(mask)[:, 0])
    n0 = trm.compact_stats["rebuilds"]
    # 384 slots, 115 alive: under half, so an index is built
    got_n, index = trm.live_rays(mask, None, True)
    assert got_n == n and torch.equal(index, idx)
    # more than half of the index's rays alive: it is kept as it is
    fewer = mask.clone()
    fewer[idx[: n // 3].long()] = False
    _, kept = trm.live_rays(fewer, index, True)
    assert kept is index
    # half or less: rebuilt
    fewer[idx[: n // 2 + 1].long()] = False
    _, rebuilt = trm.live_rays(fewer, index, True)
    assert rebuilt.shape[0] == int(fewer.sum()) <= n // 2
    assert trm.compact_stats["rebuilds"] == n0 + 2
    # compaction off: never an index
    assert trm.live_rays(fewer, None, False)[1] is None


@pytest.mark.parametrize("gate", ["off", "on"])
def test_renderer_compacts_only_when_asked(gate):
    """On the host loop (the CPU) the Renderer marches at full width unless
    it was created with ``compact=True`` or a march is asked to (its
    default, ``compact=None``, compacts only in a march graph); the screen
    and the raybuffer are the same either way, dense and gated."""
    from cpuvox_tpu_torch.config import RenderConfig
    from cpuvox_tpu_torch.render.frame import Renderer

    cfg = RenderConfig(width=SCREEN[0], height=SCREEN[1], occupancy_gate=gate)
    cam = cm.Camera(position=(-6, 70, 10), pitch_deg=30.0, yaw_deg=45.0)
    lods = lods_for("layered")
    plain = Renderer.create(lods, cfg, device="cpu")
    assert plain.compact is None and not plain.compacts(graph=False)
    assert plain.compacts(graph=True)
    n0 = trm.compact_stats["rebuilds"]
    screen, raybuf, _ = plain.render_device(cam)
    assert trm.compact_stats["rebuilds"] == n0
    compacting = Renderer.create(lods, cfg, device="cpu", compact=True)
    got_screen, got_raybuf, _ = compacting.render_device(cam)
    n1 = trm.compact_stats["rebuilds"]
    assert n1 > n0
    assert torch.equal(got_screen, screen) and torch.equal(got_raybuf, raybuf)
    assert (screen != screen[0, 0]).any(), "nothing was drawn"
    # the argument of one march overrides the Renderer's setting, both ways
    f = plain.frame_setup(cam)
    assert torch.equal(plain.march(f, compact=True), raybuf)
    assert trm.compact_stats["rebuilds"] > n1
    n2 = trm.compact_stats["rebuilds"]
    assert torch.equal(
        compacting.march(compacting.frame_setup(cam), compact=False), raybuf)
    assert trm.compact_stats["rebuilds"] == n2


def mid_march(scene, pos, pitch, yaw, device="cpu", skip=2, gated_cells=0):
    """A frame's state after ``skip`` chunks of the uncompacted march, and
    the live-ray index a compacting march would hold there."""
    dw, cam_data, static, dda, alive, direction = frame_inputs(
        lods_for(scene), pos, pitch, yaw)
    wa = trm.world_arrays(dw, device)
    st = trm.RayStatic(**put(static, device))
    dd = trm.DDAState(**put(dda, device))
    al = torch.from_numpy(alive).to(device)
    rs = trm.init_raster_state(st, max(SCREEN))
    consts = trm.raster_consts(dw.dims[1], cam_data.position[1],
                               dw.solid_min_y, dw.solid_max_y, device)
    ld = torch.from_numpy(cam_data.lod_distances).to(device)
    far = float(np.float32(cam_data.far_clip))
    for _ in range(skip):
        dd, al, visits = trm._roll_chunk(dd, al & rs.alive, st.dirs, ld, far,
                                         dw.dims, 8)
        rs = trm.rasterize_cells(rs, trm.chunk_cells(wa, visits, direction),
                                 st, consts, direction)
    live = al & rs.alive
    index = trm.live_index(live, int(live.sum()))
    return wa, st, dd, live, rs, consts, ld, far, dw.dims, direction, index


INDEX_CASES = [("deep", (-4, 40, 20), 20.0, 60.0),
               ("terrain", (64, 4, 64), -30.0, 200.0)]


def check_roll_with_index(roll, ref, scene, pos, pitch, yaw, device="cpu"):
    _wa, st, dd, live, _rs, _c, ld, far, dims, _d, index = mid_march(
        scene, pos, pitch, yaw, device)
    assert 0 < index.shape[0] < R // 2

    def copy():
        return trm.DDAState(*(t.clone() for t in dd)), live.clone()

    full_dda, full_alive, full_vis = ref(*copy(), st.dirs, ld, far, dims, 8)
    got_dda, got_alive, got_vis = roll(*copy(), st.dirs, ld, far, dims, 8,
                                       index=index)
    i = index.long()
    assert got_vis.shape == (8, trm.NVF, index.shape[0])
    assert torch.equal(got_vis, full_vis[:, :, i])
    dead = torch.ones(R, dtype=torch.bool, device=device)
    dead[i] = False
    for k, g, f, before in zip(trm.DDAState._fields + ("alive",),
                               (*got_dda, got_alive), (*full_dda, full_alive),
                               (*dd, live)):
        if g.dtype == torch.float32:
            g, f, before = (t.view(torch.int32) for t in (g, f, before))
        assert torch.equal(g[i], f[i]), k
        assert torch.equal(g[dead], before[dead]), f"{k}: a dead ray moved"


def check_raster_with_index(raster, ref, scene, pos, pitch, yaw,
                            device="cpu"):
    wa, st, dd, live, rs, consts, ld, far, dims, direction, index = mid_march(
        scene, pos, pitch, yaw, device)
    _dda, _alive, visits = trm._roll_chunk(dd, live, st.dirs, ld, far, dims, 8)
    cells = trm.chunk_cells(wa, visits, direction)
    i = index.long()
    cells_k = trm.CellFields(*(None if f is None else f[:, i].contiguous()
                               for f in cells))

    def copy():
        return trm.RasterState(*(t.clone() for t in rs))

    full = ref(copy(), cells, st, consts, direction)
    got = raster(copy(), cells_k, st, consts, direction, index=index)
    # a dead ray's cells are not valid, so the full-width call leaves it
    # untouched too: the two states are equal everywhere
    assert_states_equal(got, full, f"{scene} raster with an index")
    assert (full.raybuf >= 0).sum() > (rs.raybuf >= 0).sum()
    dead = torch.ones(R, dtype=torch.bool, device=device)
    dead[i] = False
    assert_states_equal(trm.RasterState(*(t[dead] for t in got)),
                        trm.RasterState(*(t[dead] for t in rs)),
                        f"{scene}: a dead ray's row or state moved")


@pytest.mark.parametrize("scene,pos,pitch,yaw", INDEX_CASES)
def test_plain_roll_with_index_matches_without(scene, pos, pitch, yaw):
    check_roll_with_index(trm._roll_chunk, trm._roll_chunk, scene, pos,
                          pitch, yaw)


@pytest.mark.parametrize("scene,pos,pitch,yaw", INDEX_CASES)
def test_plain_raster_with_index_matches_without(scene, pos, pitch, yaw):
    check_raster_with_index(trm.rasterize_cells, trm.rasterize_cells, scene,
                            pos, pitch, yaw)


@pytest.mark.cuda
@pytest.mark.parametrize("scene,pos,pitch,yaw", INDEX_CASES)
def test_roll_kernel_with_index_matches_plain_on_cuda(cuda, scene, pos,
                                                      pitch, yaw):
    from cpuvox_tpu_torch.ops import roll_kernel

    before = roll_kernel.launches
    check_roll_with_index(roll_kernel.roll_chunk, roll_kernel.roll_chunk_ref,
                          scene, pos, pitch, yaw, cuda)
    assert roll_kernel.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("scene,pos,pitch,yaw", INDEX_CASES)
def test_raster_kernel_with_index_matches_plain_on_cuda(cuda, scene, pos,
                                                        pitch, yaw):
    from cpuvox_tpu_torch.ops import phase1_kernel

    before = phase1_kernel.chunk_launches
    check_raster_with_index(phase1_kernel.rasterize_chunk,
                            phase1_kernel.rasterize_chunk_ref, scene, pos,
                            pitch, yaw, cuda)
    assert phase1_kernel.chunk_launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("gate", ["off", "on"])
def test_compacted_frame_on_cuda_matches_uncompacted(cuda, gate):
    """A frame through the kernels with and without compaction (the staged
    march graph and the full-width one): the same raybuffer, and the staged
    graph ran iterations below the full width."""
    from cpuvox_tpu_torch.ops import march_loop
    from cpuvox_tpu_torch.bench import path as bench_path
    from cpuvox_tpu_torch.config import RenderConfig
    from cpuvox_tpu_torch.models.procedural import layered_world
    from cpuvox_tpu_torch.render.frame import Renderer

    r = Renderer.create(
        layered_world(dims=(256, 512, 256), seed=99, shell_depth=8,
                      n_layers=13, lod_levels=6, footprint=0.55),
        RenderConfig(width=160, height=120, occupancy_gate=gate), device=cuda)
    for t in (0.35, 0.6):
        cam = bench_path.benchmark_camera(t * bench_path.BENCH_CLIP_LENGTH,
                                          r.device_world.dims, r.render_wh)
        march_loop.stage_stats.reset()
        a = r.march(r.frame_setup(cam), compact=True)
        R = a.shape[0]
        assert sum(n for w, n in march_loop.stage_stats.read().items()
                   if w < R) > 0
        b = r.march(r.frame_setup(cam), compact=False)
        assert torch.equal(a, b)
