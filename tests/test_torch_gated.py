"""The port's occupancy-gated march against its dense march and the JAX
package, bit-exact (tolerance 0): every raybuffer texel and screen pixel.

- ``raymarch.phase1`` gated (plain torch, small groups so that rays rewind)
  == the port's dense march == JAX ``raymarch.phase1`` (XLA), on deep RLE
  towers, a small layered world and towers in a tall box, in both iteration
  directions;
- the busy-ray rewind on a dense floor with the gate forced on, against the
  JAX Renderer's gated Pallas path (interpret mode), as
  ``tests/test_pallas_kernel.py:131`` holds it against XLA;
- the gated solid-bound pre-kill changes no pixel, as
  ``tests/test_solid_kill.py:94`` holds it;
- the Renderer's gate policy, march budget and group size agree with the
  JAX Renderer's.

The ``cuda`` tests (skipped without a card) hold the rasterizer kernel on a
gated group at MAXR 29, and the roll at chunk 128,
against their plain versions.  JAX is imported only inside the tests that
compare with it: the card's machine has no jax.
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
R = 384  # 3 * (64 + 48) rays, padded to 128
SMALL_LAYERED = dict(dims=(64, 64, 64), seed=99, shell_depth=4, n_layers=6,
                     lod_levels=4, footprint=0.55)
# a world with layered2048's run depth (max_runs 29) and emptiness, small
# enough to build in a fraction of a second
LAYERED_MAXR29 = dict(dims=(256, 512, 256), seed=99, shell_depth=8,
                      n_layers=13, lod_levels=6, footprint=0.55)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m cuda")
    return torch.device("cuda")


def lods_for(scene):
    from cpuvox_tpu_torch.models.procedural import layered_world

    if scene == "deep":
        return scenes.deep_tower_world()
    if scene == "layered":
        return layered_world(**SMALL_LAYERED)
    from test_solid_kill import sparse_towers_tall_box

    return sparse_towers_tall_box()


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


def run_port(dw, cam_data, static, dda, alive, direction, chunk, max_chunks,
             gated_cells=0, kernels=False, device="cpu"):
    def put(d):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in d.items()}

    rb = trm.phase1(
        trm.world_arrays(dw, device), trm.RayStatic(**put(static)),
        trm.DDAState(**put(dda)), torch.from_numpy(alive).to(device),
        cam_data.lod_distances, cam_data.far_clip, dw.dims[1],
        cam_data.position[1], iteration_direction=direction, chunk=chunk,
        max_chunks=max_chunks, dims=dw.dims, pixel_len=max(SCREEN),
        solid_min_y=dw.solid_min_y, solid_max_y=dw.solid_max_y,
        kernels=kernels, gated_cells=gated_cells)
    return rb.cpu().numpy()


def assert_equal(name, got, want):
    diff = got != want
    assert not diff.any(), (f"{name}: {int(diff.sum())} texels differ, first "
                            f"(ray, texel): {np.argwhere(diff)[:5].tolist()}")


# (name, world, camera position, pitch, yaw, iteration direction)
MARCH_CASES = [
    ("deep_down", "deep", (-4, 40, 20), 20.0, 60.0, 1),
    ("deep_up", "deep", (30, 6, 30), -30.0, 120.0, -1),
    ("layered_down", "layered", (-6, 70, 10), 30.0, 45.0, 1),
    ("layered_up", "layered", (40, 8, 30), -35.0, 200.0, -1),
    ("towers_down", "towers", (32.0, 25.0, 8.0), 20.0, 10.0, 1),
    ("towers_up", "towers", (12.0, 18.0, 40.0), -35.0, 200.0, -1),
]


@pytest.mark.parametrize("name,scene,pos,pitch,yaw,direction", MARCH_CASES)
def test_gated_march_matches_dense_and_jax(name, scene, pos, pitch, yaw,
                                           direction):
    """Chunks of 32 and groups of 4 cells: rays with more than 4 gated cells
    in a chunk rewind, many times a frame."""
    lods = lods_for(scene)
    inputs = frame_inputs(lods, pos, pitch, yaw)
    dw = inputs[0]
    assert inputs[-1] == direction
    assert dw.empty_frac >= 0.5  # the gate resolves on for "auto"
    want = run_jax(lods, *inputs[1:])
    dense = run_port(*inputs, chunk=8, max_chunks=128)
    assert_equal(f"{name} dense", dense, want)
    n0 = trm.gated_stats["iterations"]
    gated = run_port(*inputs, chunk=32, max_chunks=3 * max(dw.dims) + 64,
                     gated_cells=4)
    assert trm.gated_stats["iterations"] > n0
    assert_equal(f"{name} gated", gated, want)
    assert (want > 0).any(), f"{name}: nothing was drawn"


def test_gated_rewind_matches_jax_pallas():
    """tests/test_pallas_kernel.py:131's frame: a dense floor with the gate
    forced on, chunk 32, tight LOD distances.  Every ray has more gated cells
    per chunk than its group of 16 holds, so the rewind (restore the
    pre-switch DDA state of the first unprocessed cell) runs all the time,
    across LOD switches.  Held against the JAX Renderer's gated Pallas path
    in interpret mode, screen and raybuffers."""
    from cpuvox_tpu.config import RenderConfig as JaxRenderConfig
    from cpuvox_tpu.render import camera as jcm
    from cpuvox_tpu.render.frame import Renderer as JaxRenderer
    from cpuvox_tpu.world import rle

    from test_torch_frame import assert_frames_equal

    lods = rle.build_lod_chain(scenes.flat_floor_world(dims=(64, 16, 64)), 6)
    kw = dict(width=SCREEN[0], height=SCREEN[1], chunk_steps=32,
              max_march_chunks=64, occupancy_gate="on", lod_error=4.0)
    lod_d = np.array([6, 12, 20, 32, 48, 96], np.float32)
    jr = JaxRenderer.create(lods, JaxRenderConfig(
        **kw, backend="pallas", pallas_interpret=True, host_init=True,
        block_fetch="off", drain_groups=0))
    jr.lod_distances, jr.far_clip = lod_d, 256.0
    want = jr.render(jcm.Camera(position=(32, 4, 32), pitch_deg=12.0,
                                yaw_deg=30.0, screen=SCREEN),
                     return_raybuffers=True)
    r = Renderer.create(lods, RenderConfig(**kw), device="cpu")
    r.lod_distances, r.far_clip = lod_d, 256.0
    assert r.occupancy_on and r.gated_group_cells == 16
    n0 = trm.gated_stats["rewinds"]
    got = r.render(cm.Camera(position=(32, 4, 32), pitch_deg=12.0,
                             yaw_deg=30.0, screen=SCREEN),
                   return_raybuffers=True)
    assert trm.gated_stats["rewinds"] > n0
    assert_frames_equal("rewind", got, want)


@pytest.mark.parametrize("ci", range(3))
def test_gated_solid_kill_changes_no_pixel(ci):
    """tests/test_solid_kill.py:94 on the port: towers in a tall box with the
    gate on; the frame is the same with the solid-bound kill on and off, and
    the same as the dense march's."""
    from test_solid_kill import CAMS

    lods = lods_for("towers")
    cam = CAMS[ci]
    cfg = RenderConfig(width=96, height=64, occupancy_gate="on")
    r_on = Renderer.create(lods, cfg, device="cpu")
    assert r_on.solid_bounds[1] is not None and r_on.occupancy_on
    frames = {}
    for tag, c in (("on", cfg), ("off", dataclasses.replace(
            cfg, solid_kill="off")), ("dense", dataclasses.replace(
                cfg, occupancy_gate="off"))):
        r = dataclasses.replace(r_on, config=c, lod_distances=None)
        frames[tag] = r.render(cam)
    assert (frames["on"] == frames["off"]).all()
    assert (frames["on"] == frames["dense"]).all()


def test_gated_march_budget_guarantees_no_truncation():
    """tests/test_pallas_kernel.py:395 on the port: the gated auto budget is
    3 * max_dim + 64 iterations; the dense march keeps per-chunk
    provisioning."""
    lods = [scenes.random_world(n=300, seed=5)] * 6
    r = Renderer.create(lods, RenderConfig(width=32, height=24,
                                           occupancy_gate="on"), device="cpu")
    assert r.occupancy_on
    chunk, mc = r.march_params
    assert mc >= 3 * max(r.device_world.dims) + 64, (chunk, mc)
    rd = Renderer.create(lods, RenderConfig(width=32, height=24,
                                            occupancy_gate="off"),
                         device="cpu")
    chunk_d, mc_d = rd.march_params
    assert mc_d == (3 * max(rd.device_world.dims)) // chunk_d + 64


def test_gate_policy_matches_jax_renderer():
    """occupancy_on, march_params and the group size resolve as the JAX
    Renderer (backend "pallas") resolves them, on dense and empty worlds,
    small and at layered2048's size."""
    from cpuvox_tpu.config import RenderConfig as JaxRenderConfig
    from cpuvox_tpu.render.frame import Renderer as JaxRenderer

    worlds = {"floor": [scenes.flat_floor_world()] * 6,
              "random": [scenes.random_world(n=300, seed=5)] * 6,
              "deep": scenes.deep_tower_world()}
    settings = [{}, {"occupancy_gate": "on"}, {"occupancy_gate": "off"},
                {"chunk_steps": 24}, {"chunk_steps": 64, "max_march_chunks": 9},
                {"gated_group_cells": 8}]
    for wname, lods in worlds.items():
        port = Renderer.create(lods, RenderConfig(), device="cpu")
        jax = JaxRenderer.create(lods, JaxRenderConfig())
        for kw in settings:
            for big in (False, True):
                pdw, jdw = port.device_world, jax.device_world
                if big:  # layered2048's dims and emptiness
                    pdw = dataclasses.replace(pdw, dims=(2048, 512, 2048),
                                              empty_frac=0.79)
                    jdw = dataclasses.replace(jdw, dims=(2048, 512, 2048),
                                              empty_frac=0.79)
                p = dataclasses.replace(port, device_world=pdw,
                                        config=RenderConfig(**kw))
                j = dataclasses.replace(jax, device_world=jdw,
                                        config=JaxRenderConfig(**kw))
                what = (wname, kw, big)
                assert p.occupancy_on == j.occupancy_on, what
                assert p.march_params == j.march_params, what
                chunk = j.march_params[0]
                gk = kw.get("gated_group_cells") or (
                    16 if chunk % 16 == 0 else 8)
                assert p.gated_group_cells == gk, what
    big = Renderer.create(worlds["deep"], RenderConfig(), device="cpu")
    big.device_world = dataclasses.replace(
        big.device_world, dims=(2048, 512, 2048), empty_frac=0.79)
    assert big.occupancy_on and big.march_params == (128, 6208)
    assert big.gated_group_cells == 16


# ------------------------------------------------------------- on the card


def layered_maxr29_renderer(device, wh=(160, 120)):
    from cpuvox_tpu_torch.models.procedural import layered_world

    r = Renderer.create(layered_world(**LAYERED_MAXR29),
                        RenderConfig(width=wh[0], height=wh[1]), device=device)
    assert r.device_world.max_runs == 29 and r.occupancy_on
    return r


def flythrough_cameras(dims, wh):
    """Two benchmark-path cameras, one of each iteration direction."""
    from cpuvox_tpu_torch.bench import path as bench_path

    return [bench_path.benchmark_camera(t * bench_path.BENCH_CLIP_LENGTH,
                                        dims, wh) for t in (0.35, 0.6)]


@pytest.mark.cuda
def test_gated_raster_kernel_matches_plain_on_cuda(cuda):
    """The rasterizer kernel on a packed group of 16 gated
    cells at MAXR 29, mid-march, in both iteration directions: the raybuffer
    and all 8 state fields equal the plain version's."""
    from cpuvox_tpu_torch.bench.capture import capture, clone
    from cpuvox_tpu_torch.ops import phase1_kernel

    r = layered_maxr29_renderer(cuda)
    directions = set()
    for cam in flythrough_cameras(r.device_world.dims, r.render_wh):
        cap = capture(r, cam, k=3)
        assert cap.gated
        # the march has compacted its rays: the group is the live rays'
        rays = cap.index.shape[0]
        assert rays <= cap.rs.raybuf.shape[0] // 2
        assert cap.cells.runs.shape == (16, rays, 29)
        directions.add(cap.frame.iteration_direction)
        args = (cap.cells, cap.frame.static, cap.consts,
                cap.frame.iteration_direction)
        got = phase1_kernel.rasterize_chunk(clone(cap.rs), *args,
                                            index=cap.index)
        torch.cuda.synchronize()
        want = phase1_kernel.rasterize_chunk_ref(clone(cap.rs), *args,
                                                 index=cap.index)
        for k, x, y in zip(trm.RasterState._fields, got, want):
            if x.dtype == torch.float32:
                x, y = x.view(torch.int32), y.view(torch.int32)
            assert torch.equal(x, y), k
        assert (want.raybuf >= 0).sum() > (cap.rs.raybuf >= 0).sum()
    assert directions == {1, -1}


@pytest.mark.cuda
def test_roll_kernel_matches_plain_at_chunk_128_on_cuda(cuda):
    """The roll kernel at the gated march's chunk of 128 on a mid-march
    state: every visit field and every carried field."""
    from cpuvox_tpu_torch.bench.capture import capture, clone
    from cpuvox_tpu_torch.ops import roll_kernel

    r = layered_maxr29_renderer(cuda)
    cam = flythrough_cameras(r.device_world.dims, r.render_wh)[0]
    cap = capture(r, cam, k=2)
    assert cap.chunk == 128
    rest = (cap.frame.static.dirs, cap.lod_distances, cap.far,
            r.device_world.dims, cap.chunk)
    got = roll_kernel.roll_chunk(clone(cap.dda), cap.alive.clone(), *rest,
                                 index=cap.index)
    torch.cuda.synchronize()
    want = roll_kernel.roll_chunk_ref(clone(cap.dda), cap.alive.clone(), *rest,
                                      index=cap.index)
    for x, y in zip([*got[0], got[1], got[2]], [*want[0], want[1], want[2]]):
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_gated_frame_equals_plain_and_dense_on_cuda(cuda):
    """One frame three ways on the card: gated kernels, gated plain versions
    and the dense kernels give the same raybuffer and screen."""
    r = layered_maxr29_renderer(cuda)
    cam = flythrough_cameras(r.device_world.dims, r.render_wh)[0]
    outs = []
    for kw in ({}, {"backend": "xla"}, {"occupancy_gate": "off"}):
        v = dataclasses.replace(r, config=dataclasses.replace(r.config, **kw),
                                lod_distances=None)
        screen, rb, _ = v.render_device(cam)
        outs.append((screen, rb))
    for screen, rb in outs[1:]:
        assert torch.equal(screen, outs[0][0]) and torch.equal(rb, outs[0][1])
