"""The port's multi-device renderer (``cpuvox_tpu_torch/parallel/``): the
world sharded by LOD0 tiles with its camera-local window
(``world_shard.py``), the ray-sharded frame (``mesh.py``) and the
camera-sharded batch (``batch.py``'s ``rmesh``).

On the CPU the mesh is ``["cpu"] * 8``, as the JAX tests' 8 virtual
devices (``tests/conftest.py``): owner striping depends on the count.
Held, bit for bit, against the JAX package (the window arithmetic, the
sharded world's tables, the ``ShardedRenderer``'s frames with backend
"xla") on ``tests/test_world_shard.py``'s world, and against the port's
unsharded Renderer.  The window is forced to a strict subset of the grid
(``lod_distances[0]`` 20 or 10, as ``test_world_shard.py`` does): only then
do the window remap, the sentinel and the three rebases show.  The ``cuda``
cases hold the rasterizer's window against its plain version and a
sharded frame through the kernels against the plain versions on the card.
"""
import numpy as np
import pytest
import torch

from cpuvox_tpu_torch.config import RenderConfig
from cpuvox_tpu_torch.models.procedural import heightmap_world
from cpuvox_tpu_torch.parallel import (RenderMesh, ShardedRenderer,
                                       ShardedWorld, shard_ray_state)
from cpuvox_tpu_torch.parallel.batch import render_camera_batch
from cpuvox_tpu_torch.parallel.mesh import render_frame_sharded
from cpuvox_tpu_torch.render import camera as cm
from cpuvox_tpu_torch.render import raymarch as rm
from cpuvox_tpu_torch.render.frame import Renderer

from test_torch_frame import cuda  # noqa: F401

torch.set_num_threads(1)

SCREEN = (96, 64)  # tests/test_world_shard.py's, for the JAX comparisons
SMALL = (64, 48)  # the comparisons with the unsharded Renderer
CPU8 = ["cpu"] * 8
DOWN = cm.Camera(position=(64.0, 40.0, 64.0), pitch_deg=18.0, yaw_deg=30.0,
                 screen=SCREEN)
UP = cm.Camera(position=(64.0, 50.0, 64.0), pitch_deg=-25.0, yaw_deg=200.0,
               screen=SCREEN)  # the upward iteration direction
CORNER = cm.Camera(position=(5.0, 45.0, 5.0), pitch_deg=10.0, yaw_deg=45.0,
                   screen=SCREEN)  # the window clipped at the world's corner
# the deep tower world's cameras (``test_world_shard.py:113-116``)
DEEP_CAMS = [cm.Camera(position=(32.0, 40.0, 32.0), pitch_deg=20.0,
                       yaw_deg=35.0, screen=SCREEN),
             cm.Camera(position=(20.0, 30.0, 44.0), pitch_deg=-15.0,
                       yaw_deg=220.0, screen=SCREEN)]


def world():
    """``tests/test_world_shard.py``'s world: 128 x 64 x 128, 4 LODs."""
    return heightmap_world(dims=(128, 64, 128), seed=7, shell_depth=4,
                           lod_levels=4)


@pytest.fixture(scope="module")
def small_world():
    return world()


def cfg(screen=SCREEN, **kw):
    kw.setdefault("backend", "xla")
    return RenderConfig(width=screen[0], height=screen[1], **kw)


def force_lod0(renderers, first_cam, r0: float):
    """Set ``lod_distances[0]`` to ``r0`` on every Renderer (the port's or
    JAX's, or a ``ShardedRenderer``'s inner one) after the first camera's
    setup, so the tile window is a strict subset of the grid."""
    first = renderers[0]
    first = getattr(first, "inner", first)
    first.setup_camera(first_cam)
    ld = first.lod_distances.copy()
    ld[0] = r0
    for r in renderers:
        r = getattr(r, "inner", r)
        r.lod_distances = ld.copy()
        r.far_clip = first.far_clip


def assert_equal(name, got, want):
    diff = np.asarray(got) != np.asarray(want)
    assert not diff.any(), f"{name}: {int(diff.sum())} elements differ"


# ------------------------------------------------------------ (a) indices

# (tx0, tz0, log2 T, W): inside the grid, clipped at the low and at the high
# corner, and wider than the grid
WINDOWS = [(2, 1, 4, 5), (-2, -2, 4, 5), (5, 6, 4, 5), (-1, 3, 5, 3),
           (0, 0, 4, 9)]


@pytest.mark.parametrize("win", WINDOWS + [None])
def test_window_indices_match_jax(small_world, win):
    """The port's ``_cell_index`` and ``_occ_tile_index`` equal JAX's
    (``raymarch.py:100-146``, eager ``jnp``) on random cells at raw LOD -1
    to 9, in and off the window and off the world.  The tables are read at
    the LOD clamped to 0..7, the window applies where the raw LOD is 0: a
    raw -1 tells the two apart."""
    import types

    import jax.numpy as jnp

    from cpuvox_tpu.render import raymarch as jrm
    from cpuvox_tpu_torch.render.device import build_device_world

    dw = build_device_world(small_world)
    rng = np.random.default_rng(11)
    n = 4096
    v_lod = rng.integers(-1, 10, n).astype(np.int32)
    v_lod[: n // 2] = 0  # half the cells at LOD0, where the window applies
    x = rng.integers(-48, 176, n).astype(np.int32)
    z = rng.integers(-48, 176, n).astype(np.int32)
    shift = np.maximum(v_lod, 0)
    xc, zc = x >> shift, z >> shift
    lodc = np.clip(v_lod, 0, 7)
    tables = ("col_base", "grid_z", "tile_base", "tile_gz")
    jwa = types.SimpleNamespace(
        win=None if win is None else jnp.asarray(win, jnp.int32),
        **{k: jnp.asarray(getattr(dw, k)) for k in tables})
    pwa = types.SimpleNamespace(
        win=win, **{k: torch.from_numpy(getattr(dw, k)) for k in tables})
    j_args = [jnp.asarray(a) for a in (lodc, v_lod, xc, zc)]
    p_args = [torch.from_numpy(a) for a in (lodc, v_lod, xc, zc)]
    for name in ("_cell_index", "_occ_tile_index"):
        want = np.asarray(getattr(jrm, name)(jwa, *j_args))
        got = getattr(rm, name)(pwa, *p_args).numpy()
        assert got.dtype == np.int32
        assert_equal(f"{name} {win}", got, want)
    if win is not None:  # the cases reach both sides of the window
        slot = rm._window_slot(win, p_args[2], p_args[3])[0].numpy()
        lod0 = v_lod == 0
        assert (slot[lod0] == win[3] ** 2).any()
        assert (slot[lod0] < win[3] ** 2).any()


# ------------------------------------------------------------ (b) tables


@pytest.mark.parametrize("tile_cols", [16, 32])
def test_sharded_world_matches_jax(small_world, tile_cols):
    """``ShardedWorld.build`` over 8 CPU shards equals the JAX build on the
    8-device mesh field for field, the per-owner shards joined into JAX's
    striped global layout; and a window's exchange (off-world tiles
    included) equals JAX's psum exchange, the slot-1 rebase with it."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from cpuvox_tpu.parallel.world_shard import ShardedWorld as JaxWorld

    mesh = Mesh(np.array(jax.devices()), axis_names=("world",))
    assert mesh.devices.size == len(CPU8)
    want = JaxWorld.build(small_world, mesh, tile_cols=tile_cols)
    got = ShardedWorld.build(small_world, CPU8, tile_cols=tile_cols)
    for k in ("tl", "nt_x", "nt_z", "cb", "rec_w", "dims", "max_runs",
              "lod_levels", "lod0_voxels", "empty_frac", "solid_min_y",
              "solid_max_y"):
        assert getattr(got, k) == getattr(want, k), k
    for k in ("coarse_fwd", "coarse_rev", "coarse_colors", "col_base",
              "grid_z", "coarse_occ", "tile_base", "tile_gz"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype, k
        assert_equal(k, a, b)
    assert got.skybox == want.skybox
    owned = {"fwd": "owned_fwd", "rev": "owned_rev", "colors": "owned_colors",
             "occ": "owned_occ"}
    for name, k in owned.items():
        shards = getattr(got, k)
        assert len(shards) == 8
        assert_equal(k, torch.cat(shards).numpy(), np.asarray(getattr(want, k)))
    # a window clipped at the world's edge: tile ids -1 off the world
    nt_x, nt_z = got.nt_x, got.nt_z
    wi = np.arange(3)
    txs, tzs = nt_x - 2 + wi[:, None], -1 + wi[None, :]
    valid = (txs >= 0) & (txs < nt_x) & (tzs >= 0) & (tzs < nt_z)
    tids = np.where(valid, txs * nt_z + tzs, -1).astype(np.int32).ravel()
    jgot = want.make_exchange()(
        {n: getattr(want, k) for n, k in owned.items()}, ("fwd", "rev"),
        jnp.asarray(tids))
    pgot, moved = got.exchange(tids, torch.device("cpu"))
    for name in owned:
        assert_equal(f"exchange {name}", pgot[name].numpy(),
                     np.asarray(jgot[name]))
    per_tile = sum(v[0][0].numel() * 4 for v in got.owned().values())
    assert moved == int(valid.sum()) * per_tile


# ------------------------------------------------------------ (c) frames


def test_sharded_frames_match_jax(small_world):
    """The port's ``ShardedRenderer`` frames equal the JAX
    ``ShardedRenderer``'s (backend "xla") with the window a strict subset of
    the grid, looking down and up."""
    import jax
    from jax.sharding import Mesh

    from cpuvox_tpu.config import RenderConfig as JaxConfig
    from cpuvox_tpu.parallel.world_shard import ShardedRenderer as JaxSharded

    mesh = Mesh(np.array(jax.devices()), axis_names=("world",))
    jsr = JaxSharded(small_world, mesh, JaxConfig(
        width=SCREEN[0], height=SCREEN[1], backend="xla"), tile_cols=16)
    sr = ShardedRenderer(small_world, CPU8, cfg(), tile_cols=16)
    force_lod0([sr, jsr], DOWN, 20.0)
    for cam in (DOWN, UP):
        want = jsr.render(cam)
        got = sr.render(cam)
        assert sr._window_key == jsr._window_key
        assert_equal(f"camera {cam.position}", got, want)
    assert sr._window_key[2] < sr.sw.nt_x  # a strict subset
    assert (want != want[0, 0]).any(), "nothing was drawn"


# ------------------------------------------------------------ (d) unsharded


def test_window_cases_match_unsharded(small_world):
    """The corner-clipped window (its off-world slots) and one at the far
    edge, then the whole-grid window at the world's own LOD distances: each
    frame equals the unsharded Renderer's."""
    plain = Renderer.create(small_world, cfg(SMALL), device="cpu")
    sr = ShardedRenderer(small_world, CPU8, cfg(SMALL), tile_cols=16)
    far = cm.Camera(position=(120.0, 35.0, 10.0), pitch_deg=30.0,
                    yaw_deg=160.0, screen=SCREEN)
    keys = []
    for r0, cams in ((20.0, (CORNER, far)), (None, (DOWN,))):
        if r0 is None:  # back to the world's own distances
            plain = Renderer.create(small_world, cfg(SMALL), device="cpu")
            sr = ShardedRenderer(small_world, CPU8, cfg(SMALL), tile_cols=16)
        else:
            force_lod0([plain, sr], DOWN, r0)
        for cam in cams:
            assert_equal(f"{r0} {cam.position}", sr.render(cam),
                         plain.render(cam))
            keys.append(sr._window_key)
    assert keys[0][:2] == (-2, -2) and keys[0][2] < sr.sw.nt_x
    assert keys[1][1] < 0 and keys[1][0] + keys[1][2] > sr.sw.nt_x
    assert keys[2] == (0, 0, sr.sw.nt_x)  # the whole grid


def test_window_memoization(small_world):
    """A still camera exchanges nothing; a tile crossing exchanges once."""
    plain = Renderer.create(small_world, cfg(SMALL), device="cpu")
    sr = ShardedRenderer(small_world, CPU8, cfg(SMALL), tile_cols=16)
    force_lod0([plain, sr], DOWN, 20.0)
    cam = cm.Camera(position=(30.0, 40.0, 30.0), pitch_deg=15.0,
                    yaw_deg=10.0, screen=SCREEN)
    sr.render(cam)
    n1, b1 = sr._n_exchanges, sr._exchange_bytes
    sr.render(cam)
    assert (sr._n_exchanges, sr._exchange_bytes) == (n1, b1)
    cam2 = cm.Camera(position=(34.0, 40.0, 30.0), pitch_deg=15.0,
                     yaw_deg=10.0, screen=SCREEN)  # the next tile in x
    assert_equal("crossed", sr.render(cam2), plain.render(cam2))
    assert sr._n_exchanges == n1 + 1 and sr._exchange_bytes > b1


def deep_world():
    import scenes

    return scenes.deep_tower_world()


DEEP = dict(occupancy_gate="on", chunk_steps=32, max_march_chunks=64)


def test_gated_window_matches_unsharded():
    """The gated march on the active window (occupancy rows striped with the
    tiles, the stage-A tile rows through the window): bit-equal to the
    unsharded gated Renderer, with a strict-subset window."""
    lods = deep_world()
    plain = Renderer.create(lods, cfg(SMALL, **DEEP), device="cpu")
    sr = ShardedRenderer(lods, CPU8, cfg(SMALL, **DEEP), tile_cols=16)
    assert sr.sw.owned_occ is not None
    force_lod0([plain, sr], DEEP_CAMS[0], 10.0)
    for cam in DEEP_CAMS:
        assert_equal(f"gated {cam.position}", sr.render(cam),
                     plain.render(cam))
        assert sr.inner.occupancy_on
    assert sr._window_key[2] < sr.sw.nt_x


def ray_world():
    """``tests/test_multichip.py``'s world for the ray-sharded frame."""
    import scenes

    return [scenes.random_world(n=250, seed=4)] * 6


RAY_CAM = cm.Camera(position=(8, 9, 8), pitch_deg=25.0, yaw_deg=70.0)


@pytest.mark.parametrize("gate,compact,host_init", [
    ("off", False, True), ("off", True, False), ("on", True, True),
    ("on", False, True)])
def test_ray_sharded_frame_matches_unsharded(gate, compact, host_init):
    """One camera's rays over 4 shards (``render_frame_sharded``), dense and
    gated, compacted or not, host or device ray init: the screen equals the
    unsharded frame."""
    r = Renderer.create(ray_world(), RenderConfig(
        width=64, height=48, chunk_steps=8, max_march_chunks=48,
        backend="xla", occupancy_gate=gate, host_init=host_init),
        device="cpu", compact=compact)
    rmesh = RenderMesh.create(["cpu"] * 4)
    assert rmesh.n_ray_shards == 4
    got = render_frame_sharded(r, RAY_CAM, rmesh)
    assert r.occupancy_on == (gate == "on")
    assert_equal("ray-sharded", got, r.render(RAY_CAM))


def test_shard_ray_state_splits_contiguously():
    """Contiguous slices in order, one a shard, each on its device; the
    replica of a world on its own device is the world itself."""
    r = Renderer.create(ray_world(), RenderConfig(width=64, height=48),
                        device="cpu")
    f = r.frame_setup(RAY_CAM)
    rmesh = RenderMesh.create(["cpu"] * 4)
    parts = shard_ray_state(rmesh, f.static, f.dda, f.alive0)
    assert len(parts) == 4
    for k, field in enumerate(f.static):
        assert_equal(rm.RayStatic._fields[k], torch.cat(
            [p[0][k] for p in parts]), field)
    assert_equal("alive0", torch.cat([p[2] for p in parts]), f.alive0)
    assert rmesh.replica(r._wa, torch.device("cpu")) is r._wa
    with pytest.raises(ValueError):
        shard_ray_state(RenderMesh.create(["cpu"] * 5), f.static, f.dda,
                        f.alive0)  # 384 rays


def test_camera_sharded_batch_matches_unsharded():
    """A batch of 7 cameras (4 looking down, 3 up) split over 3 shards in
    uneven contiguous blocks equals the unsharded batch, in input order."""
    r = Renderer.create(ray_world(), RenderConfig(
        width=64, height=48, chunk_steps=8, max_march_chunks=48,
        backend="xla"), device="cpu")
    cams = [cm.Camera(position=(8, 9, 8), pitch_deg=(20.0 + 3 * i) * (
        -1 if i % 2 else 1), yaw_deg=45.0 * i) for i in range(7)]
    got = render_camera_batch(r, cams, rmesh=RenderMesh.create(["cpu"] * 3))
    want = render_camera_batch(r, cams)
    assert got.shape == (7, 48, 64) and got.device == want.device
    assert_equal("camera-sharded", got, want)


def test_composed_matches_unsharded():
    """LOD0 striped over 8 shards and one camera's rays over the same 8
    (``ray_mesh``): the gated frames equal the unsharded Renderer's, with a
    strict-subset window."""
    lods = deep_world()
    plain = Renderer.create(lods, cfg(SMALL, **DEEP), device="cpu")
    sr = ShardedRenderer(lods, CPU8, cfg(SMALL, **DEEP), tile_cols=16,
                         ray_mesh=RenderMesh.create(CPU8))
    force_lod0([plain, sr], DEEP_CAMS[0], 10.0)
    for cam in DEEP_CAMS:
        assert_equal(f"composed {cam.position}", sr.render(cam),
                     plain.render(cam))
    assert sr._window_key[2] < sr.sw.nt_x
    with pytest.raises(ValueError):
        sr.render(DEEP_CAMS[0], return_raybuffers=True)


# ------------------------------------------------------------ (e) refusals


def test_refusals(small_world):
    from test_torch_frame import split_layout_world

    with pytest.raises(ValueError, match="ARGB"):
        ShardedRenderer(small_world, CPU8, cfg(argb_records=True))
    with pytest.raises(ValueError, match="power of two"):
        ShardedWorld.build(small_world, CPU8, tile_cols=24)
    with pytest.raises(ValueError, match="inline record layout"):
        ShardedWorld.build([split_layout_world()] * 6, CPU8, tile_cols=16)
    with pytest.raises(ValueError, match="empty list"):
        RenderMesh.create([])


def test_render_mesh_never_falls_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RenderMesh.create()


def test_demo_world_shard_on_cpu(small_world, tmp_path):
    """``demo.py --world-shard`` renders through a ``ShardedRenderer`` over
    ``--device`` (a saved 128 x 64 x 128 world, tiles of 16 columns)."""
    from cpuvox_tpu_torch import demo
    from cpuvox_tpu_torch.world.save import save_world

    path = tmp_path / "small.world"
    save_world(str(path), small_world)
    out = tmp_path / "frames"
    demo.main(["--world", str(path), "--world-shard", "--tile-cols", "16",
               "--device", "cpu", "--backend", "xla", "--width", "96",
               "--height", "64", "--frames", "1", "--out", str(out)])
    assert (out / "frame_000.ppm").stat().st_size > 0


# ------------------------------------------------------------ the card


@pytest.mark.cuda
def test_rasterize_visits_window_matches_plain_on_cuda(cuda):
    """The kernel's window (``csrc/rasterize.cu::cell_index``) against the
    plain ``_cell_index`` on a dense chunk of a strict-subset active world:
    raybuffer and the 8 state fields, bit for bit."""
    from cpuvox_tpu_torch.bench.capture import capture, clone
    from cpuvox_tpu_torch.ops import phase1_kernel as pk

    sr = ShardedRenderer(world(), [cuda] * 4, cfg(backend="kernels"),
                         tile_cols=16)
    force_lod0([sr], DOWN, 20.0)
    sr.render(DOWN)
    assert sr.inner._wa.win is not None and sr._window_key[2] < sr.sw.nt_x
    for k in (0, 1):
        cap = capture(sr.inner, DOWN, k, compact=False)
        assert not cap.gated
        vis = cap.src
        if k == 0:  # the first chunk's cells lie in LOD0's radius
            assert ((vis[:, 4] == 0) & (vis[:, 5] != 0)).any()
        args = (cap.wa, cap.src, cap.frame.static, cap.consts,
                cap.frame.iteration_direction)
        want = pk.rasterize_visits_ref(clone(cap.rs), *args, index=cap.index)
        n = pk.launches
        got = pk.rasterize_visits(clone(cap.rs), *args, index=cap.index)
        assert pk.launches == n + 1
        for name, a, b in zip(rm.RasterState._fields, got, want):
            assert_equal(f"chunk {k} {name}", a.cpu(), b.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("gate", ["off", "on"])
def test_sharded_renderer_kernels_match_plain_on_cuda(cuda, gate):
    """A ``ShardedRenderer`` frame through the kernels equals one through
    the plain versions on the card, with a strict-subset window; and the
    ray-sharded frame over 4 shards of the card equals the unsharded one."""
    lods = world() if gate == "off" else deep_world()
    kw = {} if gate == "off" else DEEP
    r0, cams = (20.0, (DOWN, UP)) if gate == "off" else (10.0, DEEP_CAMS)
    srs = [ShardedRenderer(lods, [cuda] * 4, cfg(backend=b, **kw),
                           tile_cols=16) for b in ("kernels", "xla")]
    force_lod0(srs, cams[0], r0)
    for cam in cams:
        assert_equal(f"{gate} {cam.position}", srs[0].render(cam),
                     srs[1].render(cam))
    plain = Renderer.create(lods, cfg(backend="kernels", **kw), device=cuda)
    got = render_frame_sharded(plain, cams[1], RenderMesh.create([cuda] * 4))
    assert_equal("ray-sharded", got, plain.render(cams[1]))
