"""The shards' device program (``parallel/mesh.py::sharded_march_graphs``,
``parallel/batch.py::blocks_on_streams``): each ray shard and each camera
block marches in a staged ``MarchGraph`` of its own
(``Renderer.shard_graph``), on a stream of its own on the card.

On the CPU the graph route is forced by monkeypatching
``Renderer.graph_route`` (its plain version: the same buffers, stages and
packs, the host reading each condition), at a test quantum of stage widths
so that several stages run on a shard's 128 rays.  Held bit for bit
(integers and f32 as bits, tolerance 0): the ray-sharded frame against the
unsharded Renderer and the sharded host loop (``sharded_march``), dense and
gated, index and ARGB, with the counters equal to the shards' sum; the
camera-sharded batch against the unsharded batch; the composed mode across
window moves; and once, over ``["cpu"] * 8``, the JAX package's Renderer
(``tests/test_multichip.py`` holds JAX's own sharded frame equal to it).
The ``cuda`` cases run a warm sharded frame with no host read, and the
kernels against the plain versions.
"""
import dataclasses

import numpy as np
import pytest
import torch

import scenes
from cpuvox_tpu_torch.config import RenderConfig
from cpuvox_tpu_torch.ops import march_loop
from cpuvox_tpu_torch.parallel import RenderMesh, ShardedRenderer
from cpuvox_tpu_torch.parallel.batch import render_camera_batch
from cpuvox_tpu_torch.parallel.mesh import (render_frame_sharded,
                                            render_frame_sharded_device,
                                            sharded_frame_rays, sharded_march,
                                            sharded_march_graphs)
from cpuvox_tpu_torch.render import camera as cm
from cpuvox_tpu_torch.render import raymarch as trm
from cpuvox_tpu_torch.render.frame import Renderer

from test_torch_frame import cuda  # noqa: F401

torch.set_num_threads(1)

QUANTUM = 32  # a test quantum: a shard's 128 rays in stages of 128, 64, 32
BASE = dict(width=64, height=48, chunk_steps=8, max_march_chunks=48)
CAM = cm.Camera(position=(8, 9, 8), pitch_deg=25.0, yaw_deg=70.0)
CPU4 = ["cpu"] * 4


def lods():
    """``tests/test_multichip.py``'s world."""
    return [scenes.random_world(n=250, seed=4)] * 6


@pytest.fixture
def graph_route(monkeypatch):
    """Every march takes the graph route (on the CPU its plain version),
    staged at the test quantum."""
    widths = trm.stage_widths
    monkeypatch.setattr(trm, "stage_widths",
                        lambda R, quantum=QUANTUM: widths(R, QUANTUM))
    monkeypatch.setattr(Renderer, "graph_route",
                        lambda self, device=None: True)


def on_host_loop(r):
    """``r`` with its marches on the host loop (an instance attribute over
    the patched class method)."""
    r.graph_route = lambda device=None: False
    return r


def graphs_of(r) -> dict:
    """The Renderer's shard graphs and each one's variants, by identity."""
    return {k: (id(g), {s: id(v) for s, v in g.variants.items()})
            for k, g in r._shard_graphs.items()}


def assert_equal(name, got, want):
    got, want = (x.cpu().numpy() if isinstance(x, torch.Tensor) else x
                 for x in (got, want))
    assert got.shape == want.shape, (name, got.shape, want.shape)
    diff = got != want
    assert not diff.any(), f"{name}: {int(diff.sum())} elements differ"


def reset_counts():
    march_loop.reset_launches()
    trm.gated_stats.update(iterations=0, rewinds=0)
    trm.compact_stats.update(rebuilds=0, chunks=0, ray_slots=0)


# the dense march in ARGB mode, the gated one in index mode (the dense
# march in index mode: the two tests below)
@pytest.mark.parametrize("gate,argb", [("off", True), ("on", False)])
def test_ray_sharded_graphs_match_unsharded_and_host_loop(graph_route, gate,
                                                          argb):
    """One camera's 512 rays over 4 shards, each staged (128, 64, 32) in
    its own graph: the raybuffer == the sharded host loop's on the same
    rays, its screen == the unsharded Renderer's (on the host loop); the
    stage counters, and on the gated march the gated iterations, equal the
    sum of the shards' graphs' and the host loop's iterations."""
    r = Renderer.create(lods(), RenderConfig(
        **BASE, occupancy_gate=gate, argb_records=argb), device="cpu")
    rmesh = RenderMesh.create(CPU4)
    assert r.occupancy_on == (gate == "on") and r.argb_on == argb
    f = r.frame_setup(CAM, R=sharded_frame_rays(r, rmesh))
    assert f.alive0.shape[0] == 512
    reset_counts()
    got = sharded_march_graphs(r, rmesh, f)
    by_width = march_loop.stage_stats.read()
    n_graph = sum(by_width.values())
    gated = dict(trm.gated_stats)
    shards = [(k, g) for k, g in r._shard_graphs.items() if k[0] == "ray"]
    assert sorted(k[1] for k, _g in shards) == [0, 1, 2, 3]
    exits = [v.exits for _k, g in shards for v in g.variants.values()]
    assert len(exits) == 4 and all(len(e) == 3 for e in exits)
    assert n_graph == sum(int(e[-1]) for e in exits) > 0
    assert set(by_width) == {128, 64, 32} and by_width[32] > 0
    if gate == "on":
        assert gated["iterations"] == n_graph
    reset_counts()
    host = sharded_march(
        rmesh, r._wa, f.static, f.dda, f.alive0, f.cam_data.lod_distances,
        f.cam_data.far_clip, r.device_world.dims[1], f.cam_data.position[1],
        iteration_direction=f.iteration_direction, **r.march_kwargs())
    assert_equal("raybuffer", got, host)
    assert trm.compact_stats["chunks"] == n_graph  # an iteration each
    if gate == "on":
        assert trm.gated_stats["iterations"] == n_graph
    want = on_host_loop(Renderer.create(lods(), r.config, device="cpu"))
    assert_equal("screen", r.phase2(f, got).numpy().view(np.uint32),
                 want.render(CAM))


def test_each_shard_marches_in_a_graph_of_its_own(graph_route):
    """A ray shard a graph, keyed by its slot: four distinct graphs of 128
    rays on one device; a second frame makes no graph and no variant. Two
    camera blocks of one bucket on one device: a graph each, equal to the
    unsharded batch."""
    r = Renderer.create(lods(), RenderConfig(**BASE), device="cpu")
    rmesh = RenderMesh.create(CPU4)
    first = render_frame_sharded(r, CAM, rmesh)
    before = graphs_of(r)
    assert sorted(before) == [("ray", k, 128, 64, torch.device("cpu"))
                              for k in range(4)]
    assert len({gid for gid, _v in before.values()}) == 4
    cam2 = dataclasses.replace(CAM, yaw_deg=100.0)
    assert render_frame_sharded(r, cam2, rmesh).shape == first.shape
    assert graphs_of(r) == before
    cams = [cm.Camera(position=(8, 9, 8), pitch_deg=20.0 + 3 * i,
                      yaw_deg=45.0 * i) for i in range(4)]
    got = render_camera_batch(r, cams, rmesh=RenderMesh.create(["cpu"] * 2))
    R2 = 2 * r.ray_capacity
    blocks = {k: g for k, g in r._shard_graphs.items() if k[0] == "cam"}
    assert sorted(blocks) == [("cam", k, R2, 64, torch.device("cpu"))
                              for k in (0, 1)]
    assert blocks[("cam", 0, R2, 64, torch.device("cpu"))] is not \
        blocks[("cam", 1, R2, 64, torch.device("cpu"))]
    assert_equal("camera blocks", got, render_camera_batch(r, cams))


def test_composed_window_moves_keep_every_shard_graph(graph_route):
    """LOD0 striped over 8 CPU shards, one camera's rays over 4: a window
    move copies the new window into each shard graph's own world; after
    the first move (the graphs' own copy) no graph and no variant is made
    anew, and the frame == the unsharded Renderer's."""
    from test_torch_shard import CPU8, SMALL, cfg, force_lod0, world

    lods_ = world()
    plain = Renderer.create(lods_, cfg(SMALL), device="cpu")
    sr = ShardedRenderer(lods_, CPU8, cfg(SMALL), tile_cols=16,
                         ray_mesh=RenderMesh.create(CPU4))
    cams = [cm.Camera(position=(x, 40.0, 30.0 + 4.0 * k), pitch_deg=15.0,
                      yaw_deg=10.0) for k, x in enumerate((30.0, 34.0, 50.0))]
    force_lod0([plain, sr], cams[0], 20.0)
    seen, corners = [], []
    for cam in cams:
        got = sr.render(cam)
        seen.append(graphs_of(sr.inner))
        corners.append(sr._window_key)
    assert_equal("composed", got, plain.render(cams[-1]))
    assert len(set(corners)) == 3 and corners[0][2] < sr.sw.nt_x
    assert len(seen[0]) == 4 and seen[1] == seen[2]
    assert {k: g for k, (g, _v) in seen[0].items()} == \
        {k: g for k, (g, _v) in seen[2].items()}
    for g in sr.inner._shard_graphs.values():
        assert g.world(sr.inner._wa).win is not sr.inner._wa.win


def test_stage_counts_add_up_over_streams(monkeypatch):
    """Four marches on four streams of a device each add to an
    accumulator of their own (no two in-place adds on one tensor at once);
    a read sums them."""
    class Stream:
        def __init__(self, n):
            self.cuda_stream = n

        def synchronize(self):
            pass

    now = [None]
    monkeypatch.setattr(trm, "current_stream", lambda device: now[0])
    st = march_loop.StageStats()
    stats = trm.MarchStats(iterations=0)
    for k in range(4):
        now[0] = Stream(k)
        st.add((8, 4), torch.tensor([k + 1, 2 * k + 3], dtype=torch.int32))
        stats.add(iterations=torch.tensor(k + 10, dtype=torch.int32))
    assert len(st._acc) == 4 and len(stats._device) == 4
    assert st.read() == {8: 1 + 2 + 3 + 4, 4: sum(k + 2 for k in range(4))}
    assert stats["iterations"] == 10 + 11 + 12 + 13


def test_ray_sharded_graphs_match_jax_over_8_shards(graph_route):
    """The slice as a whole, once: the frame over ``["cpu"] * 8`` on the
    graph route == the JAX package's Renderer (backend "xla")."""
    from cpuvox_tpu.config import RenderConfig as JaxConfig
    from cpuvox_tpu.render import camera as jcm
    from cpuvox_tpu.render.frame import Renderer as JaxRenderer

    w = scenes.random_world(n=250, seed=4)
    want = JaxRenderer.create([w] * 6, JaxConfig(**BASE, backend="xla")).render(
        jcm.Camera(position=(8, 9, 8), pitch_deg=25.0, yaw_deg=70.0,
                   screen=(64, 48)))
    r = Renderer.create([w] * 6, RenderConfig(**BASE), device="cpu")
    got = render_frame_sharded(r, CAM, RenderMesh.create(["cpu"] * 8))
    assert len(r._shard_graphs) == 8
    assert_equal("8 shards against JAX", got, np.asarray(want))


# ------------------------------------------------------------ the card


@pytest.mark.cuda
@pytest.mark.parametrize("gate", ["off", "on"])
def test_warm_sharded_frame_reads_nothing_on_cuda(cuda, gate):
    """4 shards of the card: a warm ray-sharded frame under
    ``set_sync_debug_mode("error")`` up to the screen's copy, no new
    capture; its screen == the unsharded frame == the sharded host loop;
    the shards' graphs launched once each."""
    cfg = RenderConfig(**BASE, occupancy_gate=gate)
    r = Renderer.create(lods(), cfg, device=cuda)
    rmesh = RenderMesh.create([cuda] * 4)
    render_frame_sharded(r, CAM, rmesh)
    torch.cuda.synchronize()
    before = graphs_of(r)
    march_loop.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        screen = render_frame_sharded_device(r, CAM, rmesh)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert graphs_of(r) == before and len(before) == 4
    assert march_loop.graph_stats["launches"] == 4
    want = r.render(CAM)
    assert_equal("graph route", screen.cpu().numpy().view(np.uint32), want)
    assert_equal("host loop", render_frame_sharded(
        on_host_loop(r), CAM, rmesh), want)


@pytest.mark.cuda
def test_shard_graph_kernels_match_plain_on_cuda(cuda):
    """The shards' graphs through the kernels == the plain versions on the
    card: the ray-sharded frame (dense and gated) and the camera-sharded
    batch over 4 shards of the card."""
    rmesh = RenderMesh.create([cuda] * 4)
    cams = [cm.Camera(position=(8, 9, 8), pitch_deg=(20.0 + 3 * i) * (
        -1 if i % 3 == 2 else 1), yaw_deg=45.0 * i) for i in range(7)]
    for gate in ("off", "on"):
        cfg = RenderConfig(**BASE, occupancy_gate=gate)
        r = Renderer.create(lods(), cfg, device=cuda)
        plain = Renderer.create(lods(), dataclasses.replace(
            cfg, backend="xla"), device=cuda)
        assert_equal(f"ray-sharded {gate}", render_frame_sharded(
            r, CAM, rmesh), render_frame_sharded(plain, CAM, rmesh))
        assert_equal(f"camera-sharded {gate}",
                     render_camera_batch(r, cams, rmesh=rmesh),
                     render_camera_batch(plain, cams, rmesh=rmesh))
        assert any(k[0] == "cam" for k in r._shard_graphs)
