"""The gated march's gate and rewind kernels (``ops/gate_kernel.py``,
``csrc/gate.cu``) against their plain versions, bit for bit (tolerance 0,
f32 as bits).

On the CPU: ``raymarch.gated_body`` takes the plain gate and rewind
(``gate_ref``/``rewind_ref``: ``gated_group`` and ``rewind_apply``) with
the plain versions (``kernels`` False), and the gate and rewind ops with
the kernels, which on a CPU tensor take the same plain functions; with the
graph route forced (the march graph's plain version) the two give the
same frame.

The ``cuda`` cases (skipped without a card) hold the gate kernel against
``gated_group`` (packed cells, ``proc``, count, cap, the rewind snapshot,
``rs.alive`` after the pre-kill, the overflow count) and the rewind kernel
against ``rewind_ref`` (every DDA field, ``alive``, the rewind count),
each kernel's launch counted on the device: on
mid-march states of a deep layered world, at full width and on a live-ray
index, with and without solid bounds, a camera height a ray, a world-shard
window and groups of 8 and 16; and on random visits whose chunks cross more
than the gate's tile budget.  Then gated frames through the Renderer's
graph, the batch graph and the shards' graphs against the plain march.
"""
import dataclasses

import numpy as np
import pytest
import torch

from cpuvox_tpu_torch.config import RenderConfig
from cpuvox_tpu_torch.ops import gate_kernel
from cpuvox_tpu_torch.render import camera as cm
from cpuvox_tpu_torch.render import raymarch as trm
from cpuvox_tpu_torch.render.frame import Renderer

torch.set_num_threads(1)

# a small layered world; chunks of 32 and groups of 4 cells, so that rays
# rewind many times a frame
CAM = cm.Camera(position=(-6, 70, 10), pitch_deg=30.0, yaw_deg=45.0)
SMALL = dict(width=48, height=32, chunk_steps=32, gated_group_cells=4,
             occupancy_gate="on")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m cuda")
    return torch.device("cuda")


def bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def assert_same(name, got, want):
    assert got.dtype == want.dtype and got.shape == want.shape, name
    assert torch.equal(bits(got), bits(want)), (
        f"{name}: {int((bits(got) != bits(want)).sum())} elements differ")


# ------------------------------------------------------------ on the CPU


@pytest.fixture(scope="module")
def small_layered():
    """A Renderer on a small layered world, with the kernels."""
    from cpuvox_tpu_torch.models.procedural import layered_world

    lods = layered_world(dims=(64, 64, 64), seed=99, shell_depth=4,
                         n_layers=6, lod_levels=4, footprint=0.55)
    return Renderer.create(lods, RenderConfig(**SMALL), device="cpu")


def with_backend(r, backend):
    return dataclasses.replace(r, config=dataclasses.replace(
        r.config, backend=backend), lod_distances=None)


@pytest.mark.parametrize("kernels", [False, True])
def test_gated_body_takes_the_gate_ops_with_the_kernels(monkeypatch,
                                                        small_layered,
                                                        kernels):
    """A gated frame with the kernels through the march graph's plain
    version (the graph route forced, as on the card): every iteration calls
    the gate and rewind ops once (on the CPU their plain versions, in
    place, which count nothing); with the plain versions, on the host
    loop, ``gate_ref`` and ``rewind_ref`` alone; the frames are equal."""
    monkeypatch.setattr(Renderer, "graph_route",
                        lambda self, device=None: self.kernels)
    calls = {"gate": 0, "rewind": 0, "gate_ref": 0, "rewind_ref": 0,
             "gated_group": 0, "rewind_apply": 0}

    def spy(module, name, key):
        fn = getattr(module, name)

        def counted(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(module, name, counted)

    for name in calls:
        spy(gate_kernel if name in ("gate", "rewind", "gate_ref",
                                    "rewind_ref") else trm, name, name)
    r = with_backend(small_layered, "pallas" if kernels else "xla")
    assert r.occupancy_on and r.kernels == kernels
    trm.gated_stats.reset()
    got = r.render(CAM)
    n = trm.gated_stats["iterations"]
    assert n > 0 and trm.gated_stats["rewinds"] > 0
    assert trm.gated_stats["gate_launches"] == 0
    assert trm.gated_stats["rewind_launches"] == 0
    assert calls == {"gate": n * kernels, "rewind": n * kernels,
                     "gate_ref": n, "rewind_ref": n, "gated_group": n,
                     "rewind_apply": n}
    monkeypatch.undo()
    want = with_backend(small_layered, "xla" if kernels else "pallas")
    np.testing.assert_array_equal(got, want.render(CAM))


# ------------------------------------------------------------- on the card

LAYERED_MAXR29 = dict(dims=(256, 512, 256), seed=99, shell_depth=8,
                      n_layers=13, lod_levels=6, footprint=0.55)


def layered_renderer(device, group_cells=0):
    from cpuvox_tpu_torch.models.procedural import layered_world

    r = Renderer.create(layered_world(**LAYERED_MAXR29), RenderConfig(
        width=160, height=120, gated_group_cells=group_cells),
        device=device)
    assert r.occupancy_on and r.device_world.max_runs == 29
    return r


def path_camera(r, t):
    from cpuvox_tpu_torch.bench import path as bench_path

    return bench_path.benchmark_camera(t * bench_path.BENCH_CLIP_LENGTH,
                                       r.device_world.dims, r.render_wh)


def clone(nt):
    return type(nt)(*(t.clone() for t in nt))


def mid_march(r, cam, k: int, compact: bool, per_ray_cam=False, solid=True):
    """A frame's gated march after ``k`` iterations of the plain versions
    (compacted as the host loop compacts): (args, state, the next
    iteration's live-ray index)."""
    f = r.frame_setup(cam)
    dev = r.device
    chunk, budget = r.march_params
    cam_y = f.cam_data.position[1]
    if per_ray_cam:  # a height a ray, as a camera batch has
        R = f.alive0.shape[0]
        cam_y = np.float32(cam_y) + (np.arange(R) % 5 - 2).astype(np.float32)
    smin, smax = r.solid_bounds if solid else (None, None)
    consts = trm.raster_consts(r.device_world.dims[1], cam_y, smin, smax,
                               dev)
    a = trm.MarchArgs(
        r._wa, f.static,
        torch.from_numpy(f.cam_data.lod_distances).to(dev),
        float(np.float32(f.cam_data.far_clip)), r.device_world.dims, consts,
        f.iteration_direction, chunk, budget, r.gated_group_cells, False)
    s = trm.march_state(clone(f.dda), f.alive0,
                        trm.init_raster_state(f.static, max(r.render_wh)))
    index = None
    for _ in range(k):
        n, index = trm.live_rays(s.alive, index, compact)
        assert n, "the march ended before the capture"
        s = trm.gated_step(a, s, index)
    _n, index = trm.live_rays(s.alive, index, compact)
    return a, s, index


def overflow_steps(wa, visits) -> int:
    """Valid steps whose tile slot is past the gate's budget of C // 8 + 4
    (``raymarch.gated_group``'s stage A)."""
    v_lod = visits[:, 4]
    lodc = v_lod.clamp(0, 7)
    ti = trm._occ_tile_index(wa, lodc, v_lod, visits[:, 0] >> v_lod,
                             visits[:, 1] >> v_lod)
    new = torch.ones_like(ti, dtype=torch.bool)
    new[1:] = ti[1:] != ti[:-1]
    slot = torch.cumsum(new.to(torch.int32), 0) - 1
    return int(((slot >= visits.shape[0] // 8 + 4)
                & (visits[:, 5] != 0)).sum())


def check_gate(wa, visits, rs, consts, gk, index):
    """The gate kernel against ``gated_group`` on the same inputs; returns
    the plain version's (rs, group)."""
    rs_k, rs_p = clone(rs), clone(rs)
    counters = torch.zeros(3, dtype=torch.int64, device=visits.device)
    got = gate_kernel.gate(wa, visits, rs_k, consts, gk, counters,
                           index=index)
    torch.cuda.synchronize()
    want = gate_kernel.gate_ref(wa, visits, rs_p, consts, gk,
                                torch.zeros_like(counters), index=index)
    for name in ("count", "cap", "snap"):
        assert_same(name, getattr(got, name), getattr(want, name))
    assert_same("packed", got.cells.rows, want.cells.rows)
    assert_same("proc", got.cells.proc, want.cells.proc)
    for name, x, y in zip(trm.RasterState._fields, rs_k, rs_p):
        assert_same(f"rs.{name}", x, y)
    assert counters.tolist() == [1, overflow_steps(wa, visits), 0]
    return rs_p, want, int(counters[1])


def check_rewind(s, rs, g, index):
    """The rewind kernel against ``rewind_ref`` on the state after the
    rasterizer; the kernel counts its launch."""
    outs = []
    for fn in (gate_kernel.rewind, gate_kernel.rewind_ref):
        dda, alive = clone(s.dda), s.alive.clone()
        rewound = torch.zeros((), dtype=torch.int64, device=alive.device)
        counters = torch.zeros(3, dtype=torch.int64, device=alive.device)
        fn(dda, alive, rewound, counters, rs, g, index=index)
        outs.append((dda, alive, rewound, counters.tolist()))
    torch.cuda.synchronize()
    (dk, ak, nk, ck), (dp, ap, n_p, cp) = outs
    assert ck == [0, 0, 1] and cp == [0, 0, 0]
    for name, x, y in zip(trm.DDAState._fields, dk, dp):
        assert_same(f"dda.{name}", x, y)
    assert_same("alive", ak, ap)
    assert int(nk) == int(n_p)
    return int(nk)


GATE_CASES = [  # (path time, compact, per-ray camera, solid, window, GK)
    (0.35, True, False, True, False, 16),
    (0.6, False, False, True, False, 16),
    (0.35, True, True, True, False, 8),
    (0.6, True, False, False, True, 16),
    (0.6, False, True, False, False, 8),
]


@pytest.mark.cuda
@pytest.mark.parametrize("t,compact,per_ray,solid,window,gk", GATE_CASES)
def test_gate_and_rewind_kernels_match_plain_on_cuda(cuda, t, compact,
                                                     per_ray, solid, window,
                                                     gk):
    """Mid-march of a deep layered world at 160x120: the gate kernel ==
    ``gated_group``, then (after the plain rasterizer) the rewind kernel ==
    ``rewind_ref``, three iterations in a row."""
    from cpuvox_tpu_torch.ops import phase1_kernel

    r = layered_renderer(cuda, gk)
    a, s, index = mid_march(r, path_camera(r, t), 3, compact, per_ray,
                            solid)
    assert (index is not None) == compact and a.group_cells == gk
    assert (a.consts["solid_max_y"] is not None) == solid
    if window:  # 3 x 3 tiles of 64 columns from tile (1, 0): the world's
        # LOD0 rows in another order, and the sentinel slot off it
        a = a._replace(wa=a.wa._replace(win=torch.tensor(
            [1, 0, 6, 3], dtype=torch.int32, device=cuda)))
    rewinds = gated = 0
    for _ in range(3):
        dda, alive, visits = trm._roll_chunk(
            clone(s.dda), s.alive.clone(), a.static.dirs, a.lod_distances,
            a.far_clip, a.dims, a.chunk, index=index)
        rs, g, _ovf = check_gate(a.wa, visits, s.rs, a.consts, gk, index)
        gated += int(g.cells.proc.sum())
        rs = phase1_kernel.rasterize_visits_ref(
            rs, a.wa, g.cells, a.static, a.consts, a.iteration_direction,
            index=index)
        rewinds += check_rewind(s._replace(dda=dda, alive=alive), rs, g,
                                index)
        s = trm.gated_step(a, s, index)
        _n, index = trm.live_rays(s.alive, index, compact)
    assert gated > 0 and rewinds > 0, "the case is too easy"


def random_gate_inputs(device, R, C, seed, solid, per_ray, window):
    """Random visits over a random occupancy table: every step may start a
    new tile, so chunks cross far more tiles than the gate's budget; f32
    fields hold -0.0, infinities and NaNs now and then."""
    rng = np.random.default_rng(seed)

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    n_tiles = 96
    occ = rng.integers(-2**31, 2**31, (n_tiles, 8), dtype=np.int64)
    occ[:, 4] = rng.integers(0, 64, n_tiles)
    occ[:, 5] = occ[:, 4] + rng.integers(0, 64, n_tiles)
    wa = trm.WorldArrays(
        col_base=put(np.arange(8, dtype=np.int32) * 4096),
        grid_z=put(np.full(8, 64, np.int32)), rec_fwd=None, rec_rev=None,
        colors=put(np.zeros(1, np.int32)), max_runs=1,
        occ_tiles=put(occ.astype(np.int32)),
        tile_base=put(np.arange(8, dtype=np.int32) * 12),
        tile_gz=put(np.full(8, 4, np.int32)),
        win=put(np.array([1, 0, 4, 3], np.int32)) if window else None)
    vis = np.zeros((C, trm.NVF, R), np.int32)
    vis[:, 0:2] = rng.integers(-4, 260, (C, 2, R))
    vis[:, 4] = rng.integers(0, 4, (C, R))
    # valid: a prefix of each ray's steps (the roll's), some rays none
    vis[:, 5] = np.arange(C)[:, None] < rng.integers(0, C + 1, R)[None, :]
    f32 = rng.uniform(0.0, 120.0, (C, 6, R)).astype(np.float32)
    special = np.array([-0.0, np.inf, -np.inf, np.nan], np.float32)
    pick = rng.random((C, 6, R)) < 0.03
    f32[pick] = special[rng.integers(0, 4, int(pick.sum()))]
    vis[:, [2, 3, 8, 9, 10, 11]] = f32.view(np.int32)
    vis[:, 6:8] = rng.integers(-4, 260, (C, 2, R))
    vis[:, 12] = rng.integers(0, 6, (C, R))
    rs = trm.RasterState(
        raybuf=put(np.full((R, 4), -1, np.int32)),
        nfp_min=put(np.zeros(R, np.int32)), nfp_max=put(np.zeros(R, np.int32)),
        fb_min=put(np.zeros(R, np.float32)),
        fb_max=put(np.zeros(R, np.float32)),
        f_active=put(rng.random(R) < 0.7),
        fdir_min=put(rng.uniform(-1.0, 0.6, R).astype(np.float32)),
        fdir_max=put(rng.uniform(-0.6, 1.0, R).astype(np.float32)),
        alive=put(rng.random(R) < 0.9))
    cam_y = (rng.uniform(0, 64, R).astype(np.float32) if per_ray
             else np.float32(32.0))
    consts = trm.raster_consts(64.0, cam_y, *((8.0, 56.0) if solid
                                               else (None, None)), device)
    return wa, put(vis), rs, consts


@pytest.mark.cuda
@pytest.mark.parametrize("solid,per_ray,window,indexed,gk",
                         [(True, False, False, False, 16),
                          (False, True, True, True, 8),
                          (True, True, False, True, 16)])
def test_gate_kernel_past_its_tile_budget_on_cuda(cuda, solid, per_ray,
                                                  window, indexed, gk):
    """Random visits (C 128, the budget 20 slots): the overflow steps occur
    and are counted, and every output equals ``gated_group``'s; then the
    rewind kernel on random raster liveness equals ``rewind_ref``."""
    R = 1000
    wa, visits, rs, consts = random_gate_inputs(cuda, R, 128, 7 + gk, solid,
                                                per_ray, window)
    index = None
    if indexed:  # 600 distinct rays in no order
        perm = np.random.default_rng(3).permutation(R)[:600]
        index = torch.from_numpy(perm.astype(np.int32)).to(cuda)
        visits = visits[:, :, :600].contiguous()
    rs_p, g, overflow = check_gate(wa, visits, rs, consts, gk, index)
    assert overflow > 0 and int((g.count > g.cap).sum()) > 0
    if solid:
        assert bool((rs_p.alive != rs.alive).any()), "no ray pre-killed"
    gen = np.random.default_rng(11)
    dda = trm.DDAState(*(torch.from_numpy(x).to(cuda) for x in (
        gen.integers(0, 256, (R, 2)).astype(np.int32),
        gen.uniform(0, 9, (R, 2)).astype(np.float32),
        np.select([gen.random((R, 2)) < 0.1, gen.random((R, 2)) < 0.05],
                  [np.inf, np.nan], gen.uniform(0, 3, (R, 2))).astype(
                      np.float32),
        gen.choice([-4, -1, 1, 2], (R, 2)).astype(np.int32),
        gen.uniform(0, 9, (R, 2)).astype(np.float32),
        gen.integers(0, 6, R).astype(np.int32))))
    s = trm.march_state(dda, torch.from_numpy(gen.random(R) < 0.5).to(cuda),
                        rs_p)
    assert check_rewind(s, rs_p, g, index) > 0


@pytest.mark.cuda
def test_gated_frames_through_the_graphs_match_plain_on_cuda(cuda):
    """Gated frames through the kernels, every texel against the plain
    march: the Renderer's staged frame graph, a camera batch's graphs and
    the ray shards' graphs; in each the gate and rewind kernels launched
    once a gated iteration, as the kernels count on the device."""
    from cpuvox_tpu_torch.parallel import RenderMesh
    from cpuvox_tpu_torch.parallel.batch import render_camera_batch
    from cpuvox_tpu_torch.parallel.mesh import render_frame_sharded

    r = layered_renderer(cuda)
    plain = dataclasses.replace(r, config=dataclasses.replace(
        r.config, backend="xla"), lod_distances=None)
    cams = [path_camera(r, t) for t in (0.35, 0.6)]

    def counted(fn):
        trm.gated_stats.reset()
        out = fn()
        stats = dict(trm.gated_stats)
        assert stats["iterations"] > 0 and stats["rewinds"] > 0
        assert (stats["gate_launches"] == stats["rewind_launches"]
                == stats["iterations"]), stats
        return out

    for cam in cams:
        _s, rb, _ = counted(lambda: r.render_device(cam))
        _s, rb_plain, _ = plain.render_device(cam)
        assert torch.equal(rb, rb_plain)
    assert torch.equal(counted(lambda: render_camera_batch(r, cams)),
                       render_camera_batch(plain, cams))
    rmesh = RenderMesh.create([cuda] * 4)
    np.testing.assert_array_equal(
        counted(lambda: render_frame_sharded(r, cams[0], rmesh)),
        plain.render(cams[0]))
