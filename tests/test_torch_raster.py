"""The port's phase 1 (torch twin; CUDA rasterizer on the card) against JAX
``raymarch.phase1`` on the same DeviceWorld and the same host ray init.

Bit-exact: every raybuffer texel.  The CUDA kernel is held against the plain
torch chunk rasterizer in all outputs (raybuffer and the 8 state fields).
JAX is imported inside the tests that compare with it, so the ``cuda``
tests also run on the card's machine, which has no jax.
"""
import shutil
import subprocess

import numpy as np
import pytest
import torch

import scenes
from cpuvox_tpu.render import camera as cm
from cpuvox_tpu.render.device import build_device_world
from cpuvox_tpu_torch.ops import phase1_kernel
from cpuvox_tpu_torch.render import ray_init
from cpuvox_tpu_torch.render import raymarch as trm

# the tests' tensors are tiny: more threads only contend with the other
# test workers
torch.set_num_threads(1)

SCREEN = (64, 48)
R = 384  # 3 * (64 + 48) rays, padded to 128
CHUNK = 8
MAX_CHUNKS = 64


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m cuda")
    return torch.device("cuda")


def world(name):
    if name == "floor":
        return [scenes.flat_floor_world()] * 6
    if name == "tower":
        return [scenes.tower_world(x=8, z=12, height=10)] * 6
    if name == "random":
        return [scenes.random_world(n=300, seed=5)] * 6
    return scenes.deep_tower_world()


# (name, world, camera position, pitch, yaw): both iteration directions
# (floor_up, random_up look up) and a camera outside the world.  The deep
# 16-bit-packed records (deep_tower_world) are in test_torch_raster_deep.py;
# floor_down's frame is held by its golden fixture (test_torch_frame.py)
CASES = [
    ("floor_up", "floor", (8, 6, 8), -35.0, 10.0),
    ("tower", "tower", (8.5, 5, 2), 5.0, 0.0),
    ("random", "random", (8, 10, 8), 25.0, 70.0),
    ("outside_world", "random", (-6, 9, -6), 30.0, 45.0),
    ("random_up", "random", (8, 13, 8), -60.0, 200.0),
]


def frame_inputs(name, pos, pitch, yaw):
    lods = world(name)
    dw = build_device_world(lods)
    cam = cm.Camera(position=pos, pitch_deg=pitch, yaw_deg=yaw, screen=SCREEN)
    cam, cam_data, _vps, segs, ctxs = scenes.frame_setup(
        lods[0], cam, lod_distances="renderer")
    static, dda, alive, _meta = ray_init.init_rays_np(
        cam_data, segs, ctxs, dw.dims, fixed_size=R)
    direction = -1 if cam_data.inverse_element_iteration_direction else 1
    return dw, cam_data, static, dda, alive, direction


def test_ray_init_copy_matches_jax():
    """The port's numpy copy of init_rays gives JAX init_rays' bits."""
    from cpuvox_tpu.render import raymarch as jrm

    _, name, pos, pitch, yaw = CASES[3]  # outside the world: entry + LOD skip
    dw, cam_data, static, dda, alive, _ = frame_inputs(name, pos, pitch, yaw)
    lods = world(name)
    cam = cm.Camera(position=pos, pitch_deg=pitch, yaw_deg=yaw, screen=SCREEN)
    cam, cam_data, _vps, segs, ctxs = scenes.frame_setup(
        lods[0], cam, lod_distances="renderer")
    js, jd, ja, _ = jrm.init_rays(cam_data, segs, ctxs, dw.dims, fixed_size=R)
    for k in trm.RayStatic._fields:
        np.testing.assert_array_equal(np.asarray(getattr(js, k)), static[k], k)
    for k in trm.DDAState._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jd, k)), dda[k], k)
    np.testing.assert_array_equal(np.asarray(ja), alive)


def run_jax(dw, cam_data, static, dda, alive, direction):
    import jax.numpy as jnp
    from cpuvox_tpu.render import raymarch as jrm

    wa = jrm.world_arrays(dw)
    rb = jrm.march_jit(
        wa, jrm.RayStatic(**{k: jnp.asarray(v) for k, v in static.items()}),
        jrm.DDAState(**{k: jnp.asarray(v) for k, v in dda.items()}),
        jnp.asarray(alive), jnp.asarray(cam_data.lod_distances),
        jnp.float32(cam_data.far_clip), jnp.float32(dw.dims[1]),
        jnp.float32(cam_data.position[1]), iteration_direction=direction,
        chunk=CHUNK, max_chunks=MAX_CHUNKS, max_runs=dw.max_runs,
        dims=dw.dims, pixel_len=max(SCREEN), solid_min_y=dw.solid_min_y,
        solid_max_y=dw.solid_max_y)
    return np.asarray(rb)


def run_torch(dw, cam_data, static, dda, alive, direction, device="cpu",
              kernels=True):
    def put(d):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in d.items()}

    rb = trm.phase1(
        trm.world_arrays(dw, device), trm.RayStatic(**put(static)),
        trm.DDAState(**put(dda)), torch.from_numpy(alive).to(device),
        cam_data.lod_distances, cam_data.far_clip, dw.dims[1],
        cam_data.position[1], iteration_direction=direction, chunk=CHUNK,
        max_chunks=MAX_CHUNKS, dims=dw.dims, pixel_len=max(SCREEN),
        solid_min_y=dw.solid_min_y, solid_max_y=dw.solid_max_y,
        kernels=kernels)
    return rb.cpu().numpy()


def check_phase1_matches_jax(name, scene, pos, pitch, yaw):
    inputs = frame_inputs(scene, pos, pitch, yaw)
    want = run_jax(*inputs)
    got = run_torch(*inputs)
    diff = got != want
    assert not diff.any(), (
        f"{name}: {int(diff.sum())} texels differ, first (ray, texel): "
        f"{np.argwhere(diff)[:5].tolist()}")
    assert (got >= 0).any(), f"{name}: nothing was drawn"


@pytest.mark.parametrize("name,scene,pos,pitch,yaw", CASES)
def test_phase1_matches_jax(name, scene, pos, pitch, yaw):
    check_phase1_matches_jax(name, scene, pos, pitch, yaw)


def chunk_fixture(device, scene="random", pos=(8, 10, 8), pitch=25.0,
                  yaw=70.0, skip_chunks=2):
    """A mid-march chunk of a real frame: the raster state after
    ``skip_chunks`` chunks, plus the next chunk's cells."""
    dw, cam_data, static, dda, alive, direction = frame_inputs(
        scene, pos, pitch, yaw)

    def put(d):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in d.items()}

    wa = trm.world_arrays(dw, device)
    st = trm.RayStatic(**put(static))
    dd = trm.DDAState(**put(dda))
    al = torch.from_numpy(alive).to(device)
    rs = trm.init_raster_state(st, max(SCREEN))
    consts = trm.raster_consts(dw.dims[1], cam_data.position[1],
                               dw.solid_min_y, dw.solid_max_y, device)
    ld = torch.from_numpy(cam_data.lod_distances).to(device)
    far = float(np.float32(cam_data.far_clip))
    for i in range(skip_chunks + 1):
        dd, al, visits = trm._roll_chunk(dd, al & rs.alive, st.dirs, ld, far,
                                         dw.dims, CHUNK)
        cells = trm.chunk_cells(wa, visits, direction)
        if i < skip_chunks:
            rs = trm.rasterize_cells(rs, cells, st, consts, direction)
    return rs, cells, st, consts, direction


def clone_state(rs):
    return trm.RasterState(*(t.clone() for t in rs))


def test_rasterize_wrapper_takes_plain_version_on_cpu():
    rs, cells, st, consts, direction = chunk_fixture("cpu")
    before = phase1_kernel.chunk_launches
    a = phase1_kernel.rasterize_chunk(clone_state(rs), cells, st, consts,
                                      direction)
    b = phase1_kernel.rasterize_chunk_ref(clone_state(rs), cells, st, consts,
                                          direction)
    assert phase1_kernel.chunk_launches == before
    for k, x, y in zip(trm.RasterState._fields, a, b):
        assert torch.equal(x, y), k


@pytest.mark.cuda
@pytest.mark.parametrize("scene,pos,pitch,yaw", [
    ("random", (8, 10, 8), 25.0, 70.0), ("random", (8, 13, 8), -60.0, 200.0),
    ("deep", (-4, 40, 20), 20.0, 60.0)])
def test_rasterize_kernel_matches_plain_on_cuda(cuda, scene, pos, pitch, yaw):
    rs, cells, st, consts, direction = chunk_fixture(cuda, scene, pos, pitch,
                                                     yaw)
    before = phase1_kernel.chunk_launches
    got = phase1_kernel.rasterize_chunk(clone_state(rs), cells, st, consts,
                                        direction)
    torch.cuda.synchronize()
    assert phase1_kernel.chunk_launches == before + 1
    want = phase1_kernel.rasterize_chunk_ref(clone_state(rs), cells, st,
                                             consts, direction)
    for k, x, y in zip(trm.RasterState._fields, got, want):
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), k


@pytest.mark.cuda
def test_kernel_library_holds_no_vimnmx3(cuda):
    """ptxas 12.9 (sm_90a) fuses max(max(-p, a), b), p a kernel parameter,
    into a VIMNMX3 that drops the negation (csrc/rasterize.cu, "Rolled
    loops").  No kernel of the library holds a VIMNMX3 today; one that
    brings it in must have its operands read in the SASS first."""
    from cpuvox_tpu_torch.ops import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", _build.build()], capture_output=True,
                          text=True, check=True).stdout
    assert "Function :" in sass, "cuobjdump printed no kernel"
    fused = [line.strip() for line in sass.splitlines() if "VIMNMX3" in line]
    assert not fused, fused[:4]


@pytest.mark.cuda
@pytest.mark.parametrize("name,scene,pos,pitch,yaw", CASES)
def test_phase1_kernels_match_cpu_twin_on_cuda(cuda, name, scene, pos, pitch,
                                               yaw):
    """The whole march through the kernels on the card against the CPU twin,
    which test_phase1_matches_jax holds equal to JAX."""
    inputs = frame_inputs(scene, pos, pitch, yaw)
    want = run_torch(*inputs)
    got = run_torch(*inputs, device=cuda)
    assert np.array_equal(got, want), name
