"""The march loop as a function of its state, and the in-place form that a
CUDA graph replays (``render/march_graph.py``).  Tolerance 0 everywhere, f32
compared as bits.

- ``march_step`` / ``gated_step`` looped while the device-side condition
  holds (``any(alive) & (i < max_chunks)``, what the graph's WHILE node
  checks) == the JAX package's phase 1, dense and gated, in both iteration
  directions: index mode against the XLA twin (``march_jit``), ARGB mode
  against ``phase1_pallas`` in interpret mode;
- five more iterations after every ray died leave the raster state and the
  DDA as they were (the invariant that the WHILE node's first check and the
  budget rely on);
- ``MarchGraph``'s in-place iteration (the body with the next state copied
  back into its buffers, then the control kernel's plain version) == the
  functional step on every field after every iteration, and its march ==
  the loop's raybuffer; across swaps of the world arrays it keeps its
  captures (a copy of the world it owns) and its frames stay right;
- the control's plain version, and ``MarchStats``;
- the two-set ray staging hands each frame its own rays;
- on the card (``cuda``): the graph march == the host-driven march with the
  kernels, and == the plain versions, at 320x180 on both marches in both
  directions, a warm ``render_device`` with no host read, and the device
  counter's iterations == the host loop's.

JAX is imported only inside the tests that compare with it.
"""
import functools

import numpy as np
import pytest
import torch

import scenes
from cpuvox_tpu_torch.ops import march_loop
from cpuvox_tpu_torch.render import camera as cm
from cpuvox_tpu_torch.render import device as td
from cpuvox_tpu_torch.render import raymarch as trm
from cpuvox_tpu_torch.render import ray_init
from cpuvox_tpu_torch.render import segments as sg
from cpuvox_tpu_torch.render.march_graph import MarchGraph

# the tests' tensors are tiny: more threads only contend with the other
# test workers
torch.set_num_threads(1)

SCREEN = (64, 48)
CHUNK, MAX_CHUNKS, GROUP = 8, 64, 4
SMALL_LAYERED = dict(dims=(64, 64, 64), seed=99, shell_depth=4, n_layers=6,
                     lod_levels=4, footprint=0.55)
# (world, argb): camera position, pitch, yaw for each iteration direction
CAMERAS = {
    "layered": {1: ((-6, 70, 10), 30.0, 45.0), -1: ((40, 8, 30), -35.0, 200.0)},
    "random": {1: ((8, 10, 8), 25.0, 70.0), -1: ((8, 13, 8), -60.0, 200.0)},
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m cuda")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def lods_for(scene):
    from cpuvox_tpu_torch.models.procedural import layered_world

    if scene == "layered":
        return layered_world(**SMALL_LAYERED)
    return [scenes.random_world(n=300, seed=5)] * 6


@functools.lru_cache(maxsize=None)
def frame_inputs(scene, argb, direction, R):
    lods = lods_for(scene)
    dw = td.build_device_world(lods, inline_colors=argb)
    pos, pitch, yaw = CAMERAS[scene][direction]
    cam = cm.limit_rotation_horizon(cm.Camera(
        position=pos, pitch_deg=pitch, yaw_deg=yaw, screen=SCREEN))
    lod_d, far = cm.setup_lods(cam, max(dw.dims), len(lods), 1.0)
    cam_data = cm.make_camera_data(cam, lod_d, far)
    vps = cm.vanishing_point_screen(cam, cm.vanishing_point_world(cam))
    segs = sg.build_segments(cam, vps)
    ctxs = sg.build_segment_contexts(cam, segs, vps)
    static, dda, alive, _ = ray_init.init_rays_np(cam_data, segs, ctxs,
                                                  dw.dims, fixed_size=R)
    d = -1 if cam_data.inverse_element_iteration_direction else 1
    assert d == direction
    assert (dw.max_col_colors > 0) == argb
    return dw, cam_data, static, dda, alive


def tensors(d):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in d.items()}


def loop_inputs(scene, argb, direction, group_cells, R=384):
    """(MarchArgs, the state before the first iteration) with the plain
    versions on the CPU."""
    dw, cam_data, static, dda, alive = frame_inputs(scene, argb, direction, R)
    wa = trm.world_arrays(dw, "cpu")
    st = trm.RayStatic(**tensors(static))
    a = trm.MarchArgs(
        wa, st, torch.from_numpy(cam_data.lod_distances.astype(np.float32)),
        float(np.float32(cam_data.far_clip)), dw.dims,
        trm.raster_consts(dw.dims[1], cam_data.position[1], dw.solid_min_y,
                          dw.solid_max_y, "cpu"),
        direction, CHUNK, MAX_CHUNKS, group_cells, kernels=False)
    s = trm.march_state(trm.DDAState(**tensors(dda)), torch.from_numpy(alive),
                        trm.init_raster_state(st, max(SCREEN)))
    return a, s


def step_fn(a):
    return trm.gated_step if a.group_cells else trm.march_step


def loop_to_end(a, s):
    """The steps while the WHILE node's condition holds; after each, the
    liveness is folded (no ray alive that the rasterizer retired), so the
    condition is JAX's ``any(alive & rs.alive)``."""
    step = step_fn(a)
    while bool(s.alive.any()) and int(s.i) < a.max_chunks:
        s = step(a, s)
        assert not (s.alive & ~s.rs.alive).any()
    return s


@functools.lru_cache(maxsize=None)
def jax_raybuffer(scene, argb, direction):
    """JAX phase 1: the XLA twin in index mode; in ARGB mode, which only its
    Pallas path writes, ``phase1_pallas`` in interpret mode on 1,024 ray
    slots (its quantum).  Returns (raybuffer, R)."""
    import jax.numpy as jnp
    from cpuvox_tpu.render import raymarch as jrm
    from cpuvox_tpu.render.device import build_device_world

    R = 1024 if argb else 384
    dw, cam_data, static, dda, alive = frame_inputs(scene, argb, direction, R)
    jdw = build_device_world(lods_for(scene), inline_colors=argb)
    args = (jrm.world_arrays(jdw),
            jrm.RayStatic(**{k: jnp.asarray(v) for k, v in static.items()}),
            jrm.DDAState(**{k: jnp.asarray(v) for k, v in dda.items()}),
            jnp.asarray(alive), jnp.asarray(cam_data.lod_distances),
            jnp.float32(cam_data.far_clip))
    if argb:
        rb = jrm.phase1_pallas(
            *args, float(dw.dims[1]), jnp.float32(cam_data.position[1]),
            direction, CHUNK, MAX_CHUNKS, jdw.max_runs, jdw.dims, max(SCREEN),
            interpret=True, max_col_colors=jdw.max_col_colors,
            skybox_argb=int(jdw.colors[0]), solid_min_y=jdw.solid_min_y,
            solid_max_y=jdw.solid_max_y)
        return np.asarray(rb).view(np.int32), R
    rb = jrm.march_jit(
        *args, jnp.float32(dw.dims[1]), jnp.float32(cam_data.position[1]),
        iteration_direction=direction, chunk=CHUNK, max_chunks=MAX_CHUNKS,
        max_runs=dw.max_runs, dims=dw.dims, pixel_len=max(SCREEN),
        solid_min_y=dw.solid_min_y, solid_max_y=dw.solid_max_y)
    return np.asarray(rb), R


def assert_equal(name, got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    diff = got != want
    assert not diff.any(), (f"{name}: {int(diff.sum())} elements differ, "
                            f"first {np.argwhere(diff)[:5].tolist()}")


def bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def assert_states_equal(name, got, want):
    for k, (x, y) in enumerate(zip(trm.state_tensors(got),
                                   trm.state_tensors(want))):
        assert x.dtype == y.dtype and x.shape == y.shape, (name, k)
        assert torch.equal(bits(x), bits(y)), f"{name}: state field {k}"


LOOP_CASES = [("layered", False), ("random", True)]


@pytest.mark.parametrize("direction", [1, -1])
@pytest.mark.parametrize("scene,argb", LOOP_CASES)
def test_step_loop_matches_jax_phase1(scene, argb, direction):
    """Dense and gated (groups of 4 cells in chunks of 8, so that rays
    rewind) against JAX phase 1; both loops end with every ray dead, inside
    the budget."""
    want, R = jax_raybuffer(scene, argb, direction)
    for gated in (0, GROUP):
        a, s = loop_inputs(scene, argb, direction, gated, R)
        s = loop_to_end(a, s)
        assert not s.alive.any() and int(s.i) < MAX_CHUNKS
        got = trm.fill_skybox(a.wa, a.static, s.rs.raybuf)
        assert_equal(f"{scene} argb={argb} gated={gated}", got, want)
        if gated:
            assert int(s.rewound) > 0, "no ray rewound: the case is too easy"


@pytest.mark.parametrize("gated", [0, GROUP])
def test_steps_after_the_end_change_nothing(gated):
    a, s = loop_inputs("random", False, -1, gated)
    s = loop_to_end(a, s)
    assert not s.alive.any()
    end = s
    for k in range(5):
        s = step_fn(a)(a, s)
        for x, y in zip([*s.rs, *s.dda], [*end.rs, *end.dda]):
            assert torch.equal(bits(x), bits(y)), f"iteration {k + 1}"
        assert not s.alive.any()
        assert int(s.rewound) == int(end.rewound)
    assert int(s.i) == int(end.i) + 5


@pytest.mark.parametrize("direction", [1, -1])
@pytest.mark.parametrize("gated", [0, GROUP])
def test_in_place_body_matches_functional_step(gated, direction):
    """``MarchGraph`` on the CPU: its buffers loaded with the frame, the
    prologue, the control's first check, then per iteration the in-place
    body and the control, against the functional step on every field
    (the camera height a ray in the buffers, a scalar in the step)."""
    a, s = loop_inputs("random", False, direction, gated)
    dw, cam_data, static, dda, alive = frame_inputs("random", False,
                                                    direction, 384)
    g = MarchGraph(384, max(SCREEN), dw.dims[1],
                   (dw.solid_min_y, dw.solid_max_y), "cpu")
    v = g.variant(a.wa, cam_data.lod_distances, cam_data.far_clip, dw.dims,
                  direction, CHUNK, MAX_CHUNKS, gated)
    g.load(a.static, s.dda, torch.from_numpy(alive), cam_data.position[1])
    g.prologue()
    cond = g.control(v.args, first=True)
    assert_states_equal("before the first iteration", g.state, s)
    n = 0
    while bool(cond):
        g.body(v.args)
        cond = g.control(v.args, first=False)
        s = step_fn(a)(a, s)
        n += 1
        assert_states_equal(f"iteration {n}", g.state, s)
        assert int(cond) == int(s.alive.any() & (s.i < MAX_CHUNKS))
    assert n == int(s.i) > 0
    want = trm.fill_skybox(a.wa, a.static, s.rs.raybuf)
    assert_equal("raybuffer", g.state.rs.raybuf, s.rs.raybuf)
    # the whole frame through the graph's plain version, twice: the second
    # frame's buffers start from the first's end state
    for _ in range(2):
        got = g.march(v, trm.RayStatic(**tensors(static)),
                      trm.DDAState(**tensors(dda)), torch.from_numpy(alive),
                      cam_data.position[1])
        assert_equal("march", got, want)
        assert got.data_ptr() != g.state.rs.raybuf.data_ptr()


def test_graph_keeps_its_captures_across_world_swaps():
    """A Renderer that swaps its world arrays (a dynamic world): the first
    set is read in place, the first swap makes the graph's own copy (a new
    variant), and later swaps of the same layout are copied into it (the
    same variant, no new capture).  Each frame == the functional loop on
    the arrays of that frame; the two worlds (LOD0's column records in
    reverse order) give different frames."""
    a, s0 = loop_inputs("random", False, 1, 0)
    dw, cam_data, static, dda, alive = frame_inputs("random", False, 1, 384)
    n0 = int(a.wa.col_base[1])

    def reversed_lod0(rec):
        out = rec.clone()
        out[:n0] = rec[:n0].flip(0)
        return out

    worlds = [a.wa, a.wa._replace(rec_fwd=reversed_lod0(a.wa.rec_fwd),
                                  rec_rev=reversed_lod0(a.wa.rec_rev))]
    g = MarchGraph(384, max(SCREEN), dw.dims[1],
                   (dw.solid_min_y, dw.solid_max_y), "cpu")
    frames, variants = [], []
    for k in (0, 1, 0, 1):
        wa = worlds[k]
        v = g.variant(wa, cam_data.lod_distances, cam_data.far_clip, dw.dims,
                      1, CHUNK, MAX_CHUNKS, 0)
        got = g.march(v, a.static, s0.dda, torch.from_numpy(alive),
                      cam_data.position[1])
        aw = a._replace(wa=wa)
        want = trm.fill_skybox(wa, a.static, loop_to_end(
            aw, trm.march_state(s0.dda, torch.from_numpy(alive),
                                trm.init_raster_state(a.static,
                                                      max(SCREEN)))).rs.raybuf)
        assert_equal(f"world {k}", got, want)
        frames.append(got)
        variants.append(v)
    assert v.args.wa is not worlds[1] and variants[0].args.wa is worlds[0]
    assert variants[1] is variants[2] is variants[3] is not variants[0]
    assert not torch.equal(frames[0], frames[1])


def test_loop_control_ref():
    alive = torch.tensor([True, True, False, True])
    rs_alive = torch.tensor([True, False, True, True])
    counter = torch.tensor(7, dtype=torch.int32)
    cond = march_loop.loop_control(alive, rs_alive, counter, 3, first=True)
    assert alive.tolist() == [True, False, False, True]
    assert int(counter) == 0 and cond.dtype == torch.int32 and int(cond) == 1
    for want_i, want_cond in ((1, 1), (2, 1), (3, 0)):
        cond = march_loop.loop_control(alive, rs_alive, counter, 3)
        assert (int(counter), int(cond)) == (want_i, want_cond)
    rs_alive[:] = False
    cond = march_loop.loop_control(alive, rs_alive, counter, 100)
    assert not alive.any() and int(cond) == 0 and int(counter) == 4


def test_march_stats():
    st = trm.MarchStats(iterations=0, rewinds=0)
    st.add(iterations=3)
    st.add(iterations=torch.tensor(4, dtype=torch.int32),
           rewinds=torch.tensor(5, dtype=torch.int64))
    assert dict(st) == {"iterations": 7, "rewinds": 5}
    st.update(iterations=0)
    assert dict(st) == {"iterations": 0, "rewinds": 5}
    with pytest.raises(KeyError):
        st.add(chunks=1)


def test_staging_hands_each_frame_its_own_rays():
    """Two cameras in turn through one ``RayStaging``: each frame's tensors
    equal its own ``init_rays_np`` fields, and stay so after the next two
    frames have been staged (both host sets reused).  The order 0, 1, 1, 0,
    0, 1 puts the other camera into a host set that an earlier frame used,
    so a frame that kept a view of its host set would show it."""
    R = 384
    inputs = [frame_inputs("layered", False, d, R) for d in (1, -1)]
    staging = ray_init.RayStaging(R, "cpu")
    held = []
    for cam in (0, 1, 1, 0, 0, 1):
        _dw, _cd, static, dda, alive = inputs[cam]
        st, dd, al = staging.put(static, dda, alive)
        held.append((cam, st, dd, al))
        for j, hs, hd, ha in held[-3:]:
            _dw, _cd, s_np, d_np, a_np = inputs[j]
            for name, t in zip(trm.RayStatic._fields, hs):
                assert t.is_contiguous()
                assert_equal(name, t.numpy(), s_np[name])
            for name, t in zip(trm.DDAState._fields, hd):
                assert_equal(name, t.numpy(), d_np[name])
            assert ha.dtype == torch.bool
            assert_equal("alive", ha.numpy(), a_np)
    assert not np.array_equal(inputs[0][2]["dirs"], inputs[1][2]["dirs"])


@pytest.mark.cuda
@pytest.mark.parametrize("scene,gate", [("terrain", "off"),
                                        ("layered", "on")])
def test_graph_march_on_cuda(cuda, scene, gate):
    """``[loop]`` (a)-(c) at 320x180: in both iteration directions, the
    graph march == ``raymarch.march`` / ``march_gated`` with the kernels on
    the same rays == the plain versions; a warm ``render_device`` under
    ``set_sync_debug_mode("error")``; the device counter's iterations ==
    the host loop's."""
    import dataclasses

    from cpuvox_tpu_torch.bench import path as bench_path
    from cpuvox_tpu_torch.config import RenderConfig
    from cpuvox_tpu_torch.models.procedural import (heightmap_world,
                                                    layered_world)
    from cpuvox_tpu_torch.render.frame import Renderer

    lods = (heightmap_world(dims=(256, 64, 256), seed=3, shell_depth=6,
                            lod_levels=6) if scene == "terrain" else
            layered_world(dims=(256, 512, 256), seed=99, shell_depth=8,
                          n_layers=13, lod_levels=6, footprint=0.55))
    r = Renderer.create(lods, RenderConfig(width=320, height=180,
                                           occupancy_gate=gate), device=cuda)
    plain = dataclasses.replace(r, config=dataclasses.replace(
        r.config, backend="xla"))
    directions = set()
    for t in (0.35, 0.6, 0.9):
        cam = bench_path.benchmark_camera(
            t * bench_path.BENCH_CLIP_LENGTH, r.device_world.dims, (320, 180))
        f = r.frame_setup(cam)
        directions.add(f.iteration_direction)
        n0 = march_loop.graph_stats["iterations"]
        got = r.march(f)
        graph_iters = march_loop.graph_stats["iterations"] - n0
        key = "iterations" if r.occupancy_on else "chunks"
        stats = trm.gated_stats if r.occupancy_on else trm.compact_stats
        h0 = stats[key]
        host = r.march_rays(f.static, f.dda, f.alive0, f.cam_data,
                            f.cam_data.position[1], f.iteration_direction,
                            compact=False)
        assert graph_iters == stats[key] - h0 > 0
        assert torch.equal(got, host)
        fp = plain.frame_setup(cam)
        assert torch.equal(got, plain.march(fp))
        r.render_device(cam)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            screen, rb, _g = r.render_device(cam)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert torch.equal(rb, got)
        want, _rb, _g = plain.render_device(cam)
        assert torch.equal(screen, want)
    assert directions == {1, -1}
