"""The staged live-ray compaction of the march graph
(``render/march_graph.py``): a WHILE loop a stage of halving width, the live
rays packed into the next stage's index between two stages, the port of
``phase1_pallas``'s staged march (``cpuvox_tpu/render/raymarch.py:1010-1024``,
``:1085-1092``, ``:1126-1129``, ``:1583-1605``).  Tolerance 0 everywhere.

- ``raymarch.stage_widths(R, 1024)`` == the reference's ``sizes`` rule, run
  from the reference's own source lines;
- ``raymarch.stage_index`` and the graph's pack == the reference's
  ``jnp.argsort(jnp.logical_not(alive))[:w]`` on seeded masks;
- the control's plain version with a threshold and in check mode;
- the staged plain graph at a quantum of 32 rays (five stages of 384 rays,
  six of 1,024) == the uncompacted plain graph == the host loop with
  compaction == the JAX package's phase 1 (the XLA twin in index mode,
  ``phase1_pallas`` in interpret mode in ARGB mode), dense and gated
  (groups of 4 cells in chunks of 8, so that rays rewind), in both
  iteration directions, with the iterations and rewinds of the
  uncompacted loop and iterations in more than one stage;
- a compacted Renderer on the graph route marches through the staged
  graph, never through ``march_on_host``, and leaves ``compact_stats`` as
  it was; a compacted camera batch too;
- on the card (``cuda``): the staged graph == the host loop with the
  kernels, at 320x180 on both marches in both directions, with no host read
  under ``set_sync_debug_mode("error")``.

JAX is imported only inside the tests that compare with it.
"""
import inspect
import textwrap

import numpy as np
import pytest
import torch

from cpuvox_tpu_torch.config import RenderConfig
from cpuvox_tpu_torch.ops import march_loop
from cpuvox_tpu_torch.render import camera as cm
from cpuvox_tpu_torch.render import raymarch as trm
from cpuvox_tpu_torch.render.frame import Renderer
from cpuvox_tpu_torch.render.march_graph import MarchGraph
from test_torch_march_loop import (CHUNK, GROUP, LOOP_CASES, MAX_CHUNKS,
                                   SCREEN, assert_equal, frame_inputs,
                                   jax_raybuffer, loop_inputs, lods_for)

# the tests' tensors are tiny: more threads only contend with the other
# test workers
torch.set_num_threads(1)

QUANTUM = 32  # a test quantum: five stages of 384 rays, six of 1,024


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m cuda")
    return torch.device("cuda")


def jax_sizes(R: int) -> list:
    """The reference's stage sizes for ``R`` rays, computed by its own lines
    (``phase1_pallas``'s ``sizes = [R]`` loop, cut from its source)."""
    from cpuvox_tpu.render import raymarch as jrm

    src = inspect.getsource(jrm.phase1_pallas).splitlines()
    a = next(i for i, x in enumerate(src) if x.strip() == "sizes = [R]")
    b = next(i for i in range(a, len(src)) if "sizes.append(nxt)" in src[i])
    scope = {"R": R}
    exec(textwrap.dedent("\n".join(src[a:b + 1])), scope)
    return scope["sizes"]


@pytest.mark.parametrize("R", [1024, 2048, 3072, 9216, 65536, 100352])
def test_stage_widths_match_jax(R):
    want = jax_sizes(R)
    assert list(trm.stage_widths(R, 1024)) == want
    assert len(want) > 1 or R == 1024


def test_stage_widths_at_the_cards_quantum():
    """The card's schedule at 1080p's ray count: halving, a multiple of the
    quantum each, down to the quantum."""
    w = trm.stage_widths(9088)
    assert w[0] == 9088 and w[-1] == trm.STAGE_QUANTUM
    assert all(x % trm.STAGE_QUANTUM == 0 for x in w[1:])
    assert all(b >= a // 2 and b < a for a, b in zip(w, w[1:]))
    assert trm.stage_widths(trm.STAGE_QUANTUM) == (trm.STAGE_QUANTUM,)


@pytest.mark.parametrize("R,p,width", [(384, 0.3, 192), (1000, 0.05, 64),
                                       (256, 0.0, 128)])
def test_stage_index_matches_jax_argsort(R, p, width):
    """``stage_index`` and the graph's pack (a cumsum rank and a scatter)
    == the reference's pack, ``jnp.argsort(jnp.logical_not(alive))[:w]``:
    live rays first, ascending, then dead ones, ascending."""
    import jax.numpy as jnp

    alive = np.random.default_rng(R).random(R) < p
    want = np.asarray(jnp.argsort(jnp.logical_not(jnp.asarray(alive)))[:width])
    got = trm.stage_index(torch.from_numpy(alive), width)
    assert got.dtype == torch.int32
    assert_equal("stage_index", got.numpy(), want)
    g = MarchGraph(R, 8, 64.0, (None, None), "cpu")
    g.state.alive.copy_(torch.from_numpy(alive))
    g.pack(width)
    assert_equal("pack", g.index(width).numpy(), want)
    assert len(set(want.tolist())) == width


def test_loop_control_threshold_and_check():
    """The condition counts the live rays against the threshold; check mode
    neither resets nor advances the counter; the exit slot gets the
    counter."""
    alive = torch.tensor([True, True, False, True, True])
    rs_alive = torch.tensor([True, False, True, True, True])
    counter = torch.tensor(7, dtype=torch.int32)
    exit_out = torch.tensor(-5, dtype=torch.int32)
    ctl = march_loop.loop_control
    # 3 rays live after the fold: over a threshold of 2, not of 3
    assert int(ctl(alive, rs_alive, counter, 9, first=True, threshold=2,
                   exit_out=exit_out)) == 1
    assert alive.tolist() == [True, False, False, True, True]
    assert int(counter) == 0 and int(exit_out) == 0
    assert int(ctl(alive, rs_alive, counter, 9, threshold=3,
                   exit_out=exit_out)) == 0
    assert int(counter) == 1 and int(exit_out) == 1
    for _ in range(2):
        assert int(ctl(alive, rs_alive, counter, 9, threshold=2,
                       check=True)) == 1
        assert int(counter) == 1
    # the budget still ends the loop in check mode
    assert int(ctl(alive, rs_alive, counter, 1, check=True)) == 0
    with pytest.raises(ValueError):
        ctl(alive, rs_alive, counter, 9, first=True, check=True)


def march_graph_ways(scene, argb, direction, gated, R):
    """The frame's raybuffer, iterations and rewinds through the plain
    graph uncompacted and staged, and through the host loop compacted;
    the staged variant's widths and exit counters."""
    a, s = loop_inputs(scene, argb, direction, gated, R)
    dw, cam_data, _static, _dda, alive = frame_inputs(scene, argb, direction,
                                                      R)
    g = MarchGraph(R, max(SCREEN), dw.dims[1],
                   (dw.solid_min_y, dw.solid_max_y), "cpu")
    args = (a.wa, cam_data.lod_distances, cam_data.far_clip, dw.dims,
            direction, CHUNK, MAX_CHUNKS, gated)
    out = {}
    for name, widths in (("uncompacted graph", None),
                         ("staged graph", trm.stage_widths(R, QUANTUM))):
        v = g.variant(*args, widths=widths)
        rb = g.march(v, a.static, s.dda, torch.from_numpy(alive),
                     cam_data.position[1])
        out[name] = (rb, int(g.state.i), int(g.state.rewound))
    hs, hi = trm.march_on_host(a, s, compact=True)
    out["host loop, compacted"] = (trm.fill_skybox(a.wa, a.static,
                                                   hs.rs.raybuf),
                                   hi, int(hs.rewound))
    return out, v


@pytest.mark.parametrize("direction", [1, -1])
@pytest.mark.parametrize("scene,argb", LOOP_CASES)
def test_staged_graph_matches_uncompacted_host_loop_and_jax(scene, argb,
                                                            direction):
    want, R = jax_raybuffer(scene, argb, direction)
    for gated in (0, GROUP):
        out, v = march_graph_ways(scene, argb, direction, gated, R)
        assert len(v.widths) >= 3, v.widths
        _rb, iters, rewinds = out["uncompacted graph"]
        for name, (rb, i, rw) in out.items():
            assert_equal(f"{scene} argb={argb} gated={gated} {name}", rb,
                         want)
            assert (i, rw) == (iters, rewinds), name
        exits = v.exits.tolist()
        per_stage = np.diff([0, *exits])
        assert exits[-1] == iters > 0 and (per_stage >= 0).all(), exits
        assert (per_stage > 0).sum() >= 2, (v.widths, exits)
        if gated:
            assert rewinds > 0, "no ray rewound: the case is too easy"


@pytest.fixture
def graph_route(monkeypatch):
    """A CPU Renderer takes the march graph's route: its plain version."""
    monkeypatch.setattr(Renderer, "graph_route",
                        lambda self, device=None: True)


def test_compacted_renderer_takes_the_staged_graph(graph_route, monkeypatch):
    """On the graph route a compacted Renderer (the gated march) marches
    through the staged graph: never through ``march_on_host``, ``compact_stats`` unchanged,
    the stage counters advanced, the frame == the uncompacted graph's and
    the host loop's; a compacted camera batch goes through a staged batch
    graph too."""
    from cpuvox_tpu_torch.parallel.batch import render_camera_batch

    cfg = RenderConfig(width=SCREEN[0], height=SCREEN[1],
                       occupancy_gate="on")
    cam = cm.Camera(position=(-6, 70, 10), pitch_deg=30.0, yaw_deg=45.0)
    lods = lods_for("layered")
    host = Renderer.create(lods, cfg, device="cpu", compact=True)
    monkeypatch.setattr(Renderer, "graph_route",
                        lambda self, device=None: False)
    want = host.render_device(cam)[:2]
    monkeypatch.setattr(Renderer, "graph_route",
                        lambda self, device=None: True)

    def no_host_loop(*a, **kw):
        raise AssertionError("a march on the graph route took the host loop")

    monkeypatch.setattr(trm, "march_on_host", no_host_loop)
    r = Renderer.create(lods, cfg, device="cpu", compact=True)
    before = dict(trm.compact_stats)
    march_loop.stage_stats.reset()
    screen, raybuf, _g = r.render_device(cam)
    assert torch.equal(screen, want[0]) and torch.equal(raybuf, want[1])
    assert dict(trm.compact_stats) == before
    R = raybuf.shape[0]
    (slot, v), = r._graph.variants.items()
    assert v.widths == trm.stage_widths(R) == slot[2] and len(v.widths) > 1
    assert sum(march_loop.stage_stats.read().values()) == int(v.exits[-1])
    assert torch.equal(r.march(r.frame_setup(cam), compact=False), raybuf)
    assert len(r._graph.variants) == 2
    cams = [cam, cm.Camera(position=(40, 8, 30), pitch_deg=-35.0,
                           yaw_deg=200.0)]
    got = render_camera_batch(r, cams)
    (key, bg), = r._batch_graphs.items()
    assert all(len(v.widths) > 1 for v in bg.variants.values())
    assert dict(trm.compact_stats) == before
    for i, c in enumerate(cams):
        assert torch.equal(got[i], r.render_device(c)[0])


def test_graph_route_ignores_compaction():
    """The route is a CUDA device with the kernels, compacted or not; the
    default (``compact=None``) stages a march graph and leaves the host
    loop uncompacted."""
    lods = lods_for("random")
    for compact in (False, True, None):
        r = Renderer.create(lods, RenderConfig(width=32, height=24),
                            device="cpu", compact=compact)
        assert not r.graph_route()
        assert r.graph_route("cuda")
        assert r.stage_widths(1536) == ((1536,) if compact is False else
                                        trm.stage_widths(1536))
        assert r.march_kwargs()["compact"] is bool(compact)
        plain = Renderer.create(lods, RenderConfig(width=32, height=24,
                                                   backend="xla"),
                                device="cpu", compact=compact)
        assert not plain.graph_route("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("scene,gate", [("terrain", "off"),
                                        ("layered", "on")])
def test_staged_graph_on_cuda(cuda, scene, gate):
    """At 320x180, in both iteration directions: the staged graph == the
    uncompacted graph == the host loop with the kernels (compacted), the
    iterations equal, a warm compacted ``render_device`` under
    ``set_sync_debug_mode("error")``, and ``march_on_host`` never called
    by the compacted Renderer."""
    from cpuvox_tpu_torch.bench import path as bench_path
    from cpuvox_tpu_torch.models.procedural import (heightmap_world,
                                                    layered_world)

    lods = (heightmap_world(dims=(256, 64, 256), seed=3, shell_depth=6,
                            lod_levels=6) if scene == "terrain" else
            layered_world(dims=(256, 512, 256), seed=99, shell_depth=8,
                          n_layers=13, lod_levels=6, footprint=0.55))
    r = Renderer.create(lods, RenderConfig(width=320, height=180,
                                           occupancy_gate=gate), device=cuda,
                        compact=True)
    host_calls = []
    on_host = trm.march_on_host

    def spy(*a, **kw):
        host_calls.append(1)
        return on_host(*a, **kw)

    directions = set()
    for t in (0.35, 0.6, 0.9):
        cam = bench_path.benchmark_camera(
            t * bench_path.BENCH_CLIP_LENGTH, r.device_world.dims, (320, 180))
        f = r.frame_setup(cam)
        directions.add(f.iteration_direction)
        trm.march_on_host = spy
        try:
            n0 = march_loop.graph_stats["iterations"]
            staged = r.march(f)
            it_staged = march_loop.graph_stats["iterations"] - n0
        finally:
            trm.march_on_host = on_host
        assert not host_calls
        full = r.march(f, compact=False)
        it_full = march_loop.graph_stats["iterations"] - n0 - it_staged
        host = r.march_rays(f.static, f.dda, f.alive0, f.cam_data,
                            f.cam_data.position[1], f.iteration_direction,
                            compact=True)
        assert torch.equal(staged, full) and torch.equal(staged, host)
        assert it_staged == it_full > 0
        r.render_device(cam)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            _screen, rb, _g = r.render_device(cam)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert torch.equal(rb, staged)
    assert directions == {1, -1}
    assert any(len(v.widths) > 1 for v in r._graph.variants.values())


@pytest.mark.parametrize("compact", [False, True])
def test_world_shard_window_moves_keep_the_graph(graph_route, compact):
    """A ``ShardedRenderer`` whose inner Renderer takes the graph route (its
    plain version here), uncompacted and staged, over a path whose window
    corner moves a tile each frame: every frame == the unsharded
    Renderer's, and from the first move on (the graph's own copy of the
    active world) no variant is made anew: the window is a device tensor
    that the graph copies in place with the tables."""
    from cpuvox_tpu_torch.parallel import ShardedRenderer
    from test_torch_shard import CPU8, DOWN, SMALL, cfg, force_lod0, world

    lods = world()
    plain = Renderer.create(lods, cfg(SMALL), device="cpu", compact=compact)
    sr = ShardedRenderer(lods, CPU8, cfg(SMALL), tile_cols=16)
    sr.inner.compact = compact
    force_lod0([plain, sr], DOWN, 20.0)
    corners, variants = [], []
    for k, x in enumerate((30.0, 34.0, 50.0, 66.0, 82.0)):
        cam = cm.Camera(position=(x, 40.0, 30.0 + 4.0 * k), pitch_deg=15.0,
                        yaw_deg=10.0)
        assert_equal(f"x={x}", sr.render(cam), plain.render(cam))
        assert isinstance(sr.inner._wa.win, torch.Tensor)
        corners.append(sr._window_key[:2])
        variants.append({s: id(v)
                         for s, v in sr.inner._graph.variants.items()})
    assert len(set(corners)) == len(corners), corners
    assert variants[1] == variants[2] == variants[3] == variants[4]
    assert all(len(s[2]) > 1 for s in variants[-1]) == compact
