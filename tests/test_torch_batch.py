"""The port's camera batch (``parallel/batch.py``) against the JAX
``render_camera_batch`` (backend "xla") and against the port's own
single-camera frames: bit-exact screens, in both iteration directions.

JAX's batch runs index mode only (its ``_batch_frame_fn`` passes no
``max_col_colors``), so ARGB batches are held against the port's
single-camera ARGB frames, which ``test_torch_argb.py`` holds to JAX; the
gated batch likewise against the single-camera gated frames of
``test_torch_gated.py``.  JAX's gated batch runs only through Pallas
interpret mode, too slow for this suite.  The ``cuda`` tests hold the batch
through the kernels against the plain path on the card.

The batch's device program: ``device_init.init_rays_batch`` against
``init_rays_device`` and ``ray_init.init_rays_np`` camera by camera, every
field and lane (padded cameras included, f32 as bits); the batch through
the batch march graph (``graph_route``: on the CPU the graph's plain
version, the host reading the condition) against the JAX batch, the host
loop and single frames; its graphs kept across pitch splits at one bucket
and across single frames; the camera-sharded batch through it.  On the
card: the graph batch == the plain batch, and a warm step reads nothing
from the device.
"""
import dataclasses

import numpy as np
import pytest
import torch

import scenes
from cpuvox_tpu.render import camera as cm
from cpuvox_tpu_torch.config import RenderConfig
from cpuvox_tpu_torch.parallel.batch import render_camera_batch
from cpuvox_tpu_torch.render import device_init, ray_init
from cpuvox_tpu_torch.render import raymarch as trm
from cpuvox_tpu_torch.render.frame import Renderer

from test_torch_device_init import assert_same_init, fields
from test_torch_frame import cuda  # noqa: F401

torch.set_num_threads(1)

# tests/test_batch.py's world, configuration and cameras (one looks up)
BASE = dict(width=64, height=48, chunk_steps=8, max_march_chunks=48)
CAMS = [
    cm.Camera(position=(8, 10, 8), pitch_deg=25.0, yaw_deg=70.0),
    cm.Camera(position=(4, 6, 3), pitch_deg=10.0, yaw_deg=200.0),
    cm.Camera(position=(8, 6, 8), pitch_deg=-15.0, yaw_deg=30.0),
    cm.Camera(position=(12, 9, 12), pitch_deg=45.0, yaw_deg=310.0),
]


def lods():
    return [scenes.random_world(n=300, seed=5)] * 6


@pytest.fixture(scope="module")
def jax_batch():
    from cpuvox_tpu.config import RenderConfig as JaxRenderConfig
    from cpuvox_tpu.parallel.batch import render_camera_batch as jax_rcb
    from cpuvox_tpu.render.frame import Renderer as JaxRenderer

    r = JaxRenderer.create(lods(), JaxRenderConfig(**BASE, backend="xla"))
    return np.asarray(jax_rcb(r, CAMS))


def as_uint32(screens):
    return screens.cpu().numpy().view(np.uint32)


def batch_init(frames, dims, R1, bucket, device="cpu"):
    """``init_rays_batch`` of ``frames`` padded to ``bucket``: its fields
    as numpy (``test_torch_device_init.fields``) and the two per-ray
    camera constants."""
    p = device_init.stack_frame_params(
        [device_init.build_frame_params(f.cam_data, f.segs, f.ctxs)
         for f in frames], bucket)
    static, dda, alive, cam_y, cam_y_norm = device_init.init_rays_batch(
        p, dims, R1, device)
    out = fields(static, dda, alive)
    out["cam_y"], out["cam_y_norm"] = cam_y.cpu().numpy(), \
        cam_y_norm.cpu().numpy()
    return out


@pytest.fixture
def graph_route(monkeypatch):
    """Every march takes the march graph's route: on the CPU its plain
    version, the same buffers and in-place iteration with the host reading
    the condition."""
    monkeypatch.setattr(Renderer, "graph_route",
                        lambda self, device=None, compact=None: True)


def graphs_of(r):
    """The Renderer's batch graphs and each one's variants, by identity."""
    return {k: (id(g), {s: id(v) for s, v in g.variants.items()})
            for k, g in r._batch_graphs.items()}


@pytest.mark.parametrize("gate", ["off", "on"])
def test_batch_matches_jax_batch(jax_batch, gate):
    """The JAX batch marches densely; the port's gated march gives the same
    raybuffer."""
    r = Renderer.create(lods(), RenderConfig(**BASE, backend="xla",
                                             occupancy_gate=gate),
                        device="cpu")
    assert r.occupancy_on == (gate == "on")
    got = as_uint32(render_camera_batch(r, CAMS))
    assert got.shape == jax_batch.shape == (4, 48, 64)
    for i in range(len(CAMS)):
        diff = got[i] != jax_batch[i]
        assert not diff.any(), f"camera {i}: {int(diff.sum())} pixels differ"


# (ARGB records, gate, compaction): each mode of the single-camera path
MODES = [(False, "off", False), (False, "on", True), (True, "off", True),
         (True, "on", False)]


@pytest.mark.parametrize("argb,gate,compact", MODES)
def test_batch_matches_single_frames(argb, gate, compact):
    cfg = RenderConfig(**BASE, backend="xla", argb_records=argb,
                       occupancy_gate=gate)
    r = Renderer.create(lods(), cfg, device="cpu", compact=compact)
    assert r.argb_on == argb
    got = as_uint32(render_camera_batch(r, CAMS))
    for i, cam in enumerate(CAMS):
        single = r.render(cam)
        diff = got[i] != single
        assert not diff.any(), f"camera {i}: {int(diff.sum())} pixels differ"
        assert not (single == np.uint32(0xFFFF1493)).any()


def test_batch_with_device_ray_init_matches_host_init():
    """A direction group's rays from ``init_rays_batch`` (every route's)
    == each camera's ``init_rays_np``, joined, in every field and lane; and
    ``host_init``, a single frame's setting, leaves the batch unchanged."""
    from cpuvox_tpu_torch.parallel import batch

    r = Renderer.create(lods(), RenderConfig(**BASE, backend="xla"),
                        device="cpu")
    frames = [r.frame_geometry(cam) for cam in CAMS]
    dims, R1 = r.device_world.dims, r.ray_capacity
    for direction in (1, -1):
        group = [f for f in frames if f.iteration_direction == direction]
        got = batch_init(group, dims, R1, len(group))
        parts = [ray_init.init_rays_np(f.cam_data, f.segs, f.ctxs, dims,
                                       fixed_size=R1)[:3] for f in group]
        want = {f"static.{k}": np.concatenate([p[0][k] for p in parts])
                for k in trm.RayStatic._fields}
        want.update({f"dda.{k}": np.concatenate([p[1][k] for p in parts])
                     for k in trm.DDAState._fields})
        want["alive"] = np.concatenate([p[2] for p in parts])
        assert_same_init(got, want, f"direction {direction}")
    want = as_uint32(render_camera_batch(r, CAMS))
    r.config = dataclasses.replace(r.config, host_init=False)
    np.testing.assert_array_equal(as_uint32(render_camera_batch(r, CAMS)),
                                  want)


def test_tables_words_hold_each_cameras_struct():
    """The batched phase 2's (B, 36) table words are, row by row, the bytes
    of the single-camera kernel's by-value ``SegmentTables``."""
    from cpuvox_tpu_torch.ops import reproject_kernel as rk

    r = Renderer.create(lods(), RenderConfig(**BASE), device="cpu")
    tables = [r.frame_geometry(cam).tables for cam in CAMS]
    want = np.stack([np.frombuffer(bytes(rk.segment_tables(t)), np.int32)
                     for t in tables])
    np.testing.assert_array_equal(rk.segment_tables_words(tables), want)


def test_batch_wrappers_take_plain_versions_on_cpu():
    from cpuvox_tpu_torch.ops import reproject_kernel as rk
    from cpuvox_tpu_torch.parallel import batch

    r = Renderer.create(lods(), RenderConfig(**BASE), device="cpu")
    frames = [r.frame_setup(cam) for cam in CAMS[:2]]
    raybuf = torch.cat([r.march(f) for f in frames])
    args = batch.phase2_group_args(r, raybuf, frames)
    before = (rk.launches, rk.screens_launches)
    want = rk.reproject_screens_ref(*args)
    for fn in (rk.reproject_screens, rk.reproject_screens_per_camera):
        np.testing.assert_array_equal(fn(*args).numpy(), want.numpy())
    assert (rk.launches, rk.screens_launches) == before


# groups for the vectorised init: a camera outside the world among inside
# ones, looking down and up, and a group of 3 padded to a bucket of 4
OUTSIDE_DOWN = cm.Camera(position=(-6, 9, -6), pitch_deg=30.0, yaw_deg=45.0)
OUTSIDE_UP = cm.Camera(position=(20, 9, -5), pitch_deg=-20.0, yaw_deg=270.0)
INIT_GROUPS = {
    "down_padded": ([CAMS[0], CAMS[1], CAMS[3]], 4),
    "up_outside": ([CAMS[2], OUTSIDE_UP,
                    cm.Camera(position=(8, 13, 8), pitch_deg=-60.0,
                              yaw_deg=200.0)], 3),
    "down_outside": ([OUTSIDE_DOWN, CAMS[0]], 2),
}


@pytest.mark.parametrize("name", sorted(INIT_GROUPS))
def test_init_rays_batch_matches_each_camera(name):
    """Each camera's block of ``init_rays_batch`` == ``init_rays_device`` on
    the camera alone == its ``init_rays_np``, every field and lane; the
    camera height and its quotient a ray == ``raster_consts``'; a padded
    camera's block == the init of a zero camera, no ray alive."""
    cams, bucket = INIT_GROUPS[name]
    r = Renderer.create(lods(), RenderConfig(**BASE), device="cpu")
    # LOD distances short enough that the rays entering the world from
    # outside fast-forward past LOD 0
    r.lod_distances = np.arange(3, 21, 3, dtype=np.float32)
    r.far_clip = 64.0
    frames = [r.frame_geometry(cam) for cam in cams]
    dims, R1 = r.device_world.dims, r.ray_capacity
    got = batch_init(frames, dims, R1, bucket)
    assert got["alive"].shape == (bucket * R1,)
    for b in range(bucket):
        block = {k: v[b * R1:(b + 1) * R1] for k, v in got.items()}
        cy, cyn = block.pop("cam_y"), block.pop("cam_y_norm")
        if b >= len(frames):  # padding: a zero camera, no ray alive
            p = device_init.build_frame_params(frames[0].cam_data,
                                               frames[0].segs, frames[0].ctxs)
            p = device_init.FrameParams(*(np.zeros_like(x) for x in p))
            assert_same_init(block, fields(*device_init.init_rays_device(
                p, dims, R1, "cpu")), f"{name} padded camera {b}")
            assert not block["alive"].any() and not cy.any()
            continue
        f = frames[b]
        single = fields(*r.init_rays_device(f))
        assert_same_init(block, single, f"{name} camera {b}: single")
        host = fields(*ray_init.init_rays(f.cam_data, f.segs, f.ctxs, dims,
                                          fixed_size=R1, device="cpu")[:3])
        assert_same_init(block, host, f"{name} camera {b}: host")
        consts = trm.raster_consts(dims[1], np.full(R1, f.cam_data.position[1],
                                                    np.float32))
        np.testing.assert_array_equal(cy.view(np.int32),
                                      consts["cam_y"].numpy().view(np.int32))
        np.testing.assert_array_equal(
            cyn.view(np.int32), consts["cam_y_norm"].numpy().view(np.int32))
    if "outside" in name:  # the world entry and the fast-forward did run
        assert (got["dda.lod"] > 0).any() and got["alive"].any()


@pytest.mark.parametrize("gate", ["off", "on"])
def test_graph_batch_matches_jax_batch(jax_batch, graph_route, gate):
    """The batch through the batch march graphs (one a bucket: 4 cameras
    looking down, 1 up) == the JAX batch."""
    r = Renderer.create(lods(), RenderConfig(**BASE, occupancy_gate=gate),
                        device="cpu")
    got = as_uint32(render_camera_batch(r, CAMS))
    R1 = r.ray_capacity
    assert sorted(k[0] for k in r._batch_graphs) == [R1, 4 * R1]
    for i in range(len(CAMS)):
        diff = got[i] != jax_batch[i]
        assert not diff.any(), f"camera {i}: {int(diff.sum())} pixels differ"


@pytest.mark.parametrize("argb,gate", [(False, "on"), (True, "off")])
def test_graph_batch_matches_host_loop_and_singles(monkeypatch, argb, gate):
    r = Renderer.create(lods(), RenderConfig(**BASE, argb_records=argb,
                                             occupancy_gate=gate),
                        device="cpu")
    assert r.argb_on == argb
    host = as_uint32(render_camera_batch(r, CAMS))
    assert not r._batch_graphs
    singles = [r.render(cam) for cam in CAMS]
    monkeypatch.setattr(Renderer, "graph_route",
                        lambda self, device=None, compact=None: True)
    got = as_uint32(render_camera_batch(r, CAMS))
    assert r._batch_graphs
    np.testing.assert_array_equal(got, host)
    for i, single in enumerate(singles):
        np.testing.assert_array_equal(got[i], single)
        assert not (single == np.uint32(0xFFFF1493)).any()


def split_cams(n_down, n_up, seed):
    """Cameras looking down, then up, around the random world."""
    rng = np.random.default_rng(seed)
    return [cm.Camera(position=tuple(rng.uniform(3, 13, 3)),
                      pitch_deg=float(rng.uniform(10, 50)) * (1 if i < n_down
                                                              else -1),
                      yaw_deg=float(rng.uniform(0, 360)))
            for i in range(n_down + n_up)]


def test_pitch_splits_at_one_bucket_keep_the_graphs(graph_route):
    """Two steps of 7 cameras, split 3 down / 4 up then 4 / 3: both groups
    of both steps pad to 4, so the second step finds one batch graph with
    both directions' variants (a variant's slot: direction, gated group,
    stage widths, the Renderer's schedule at the bucket's ray count) and
    makes nothing new."""
    r = Renderer.create(lods(), RenderConfig(**BASE), device="cpu")
    render_camera_batch(r, split_cams(3, 4, 1))
    before = graphs_of(r)
    R = 4 * r.ray_capacity
    w = r.stage_widths(R)
    assert list(before) == [(R, 64, torch.device("cpu"))]
    assert sorted(next(iter(before.values()))[1]) == [(-1, 0, w), (1, 0, w)]
    render_camera_batch(r, split_cams(4, 3, 2))
    assert graphs_of(r) == before


def test_single_frame_between_batches_keeps_both_graphs(graph_route):
    """batch, single frame, batch: the single frame marches in the
    Renderer's own graph and the batches in theirs; neither replaces the
    other, and the second batch == the first."""
    r = Renderer.create(lods(), RenderConfig(**BASE), device="cpu")
    first = render_camera_batch(r, CAMS)
    batch_graphs = graphs_of(r)
    single = r.render(CAMS[0])
    g = r._graph
    assert g is not None and g.shape == (r.ray_capacity, 64)
    assert graphs_of(r) == batch_graphs
    np.testing.assert_array_equal(render_camera_batch(r, CAMS), first)
    assert r._graph is g and graphs_of(r) == batch_graphs
    np.testing.assert_array_equal(single, as_uint32(first)[0])


def test_camera_sharded_graph_batch_matches_unsharded(graph_route):
    """7 cameras (4 down, 3 up) over 3 CPU shards in uneven blocks, each
    block bucketed and marched through its graph (the shard graph of its
    slot and bucket, ``Renderer.shard_graph``) == the unsharded batch."""
    from cpuvox_tpu_torch.parallel import RenderMesh

    r = Renderer.create(lods(), RenderConfig(**BASE), device="cpu")
    cams = split_cams(4, 3, 3)
    got = render_camera_batch(r, cams, rmesh=RenderMesh.create(["cpu"] * 3))
    # blocks of 1, 1, 2 down and 1, 1, 1 up
    R1 = r.ray_capacity
    assert not r._batch_graphs
    assert sorted((k[0], k[1], k[2]) for k in r._shard_graphs) == [
        ("cam", 0, R1), ("cam", 1, R1), ("cam", 2, R1), ("cam", 2, 2 * R1)]
    want = render_camera_batch(r, cams)
    assert got.shape == (7, 48, 64)
    np.testing.assert_array_equal(as_uint32(got), as_uint32(want))


@pytest.mark.cuda
@pytest.mark.parametrize("argb,gate,compact", MODES)
def test_batch_kernels_match_plain_on_cuda(cuda, argb, gate, compact):
    """Through the kernels (the batch march graphs, one launch a
    direction, staged with compaction on) == the plain versions == single
    frames; the kernels' launches counted by their wrappers and, inside the
    graphs, by the device counter."""
    from cpuvox_tpu_torch.ops import march_loop

    cfg = RenderConfig(**BASE, argb_records=argb, occupancy_gate=gate)
    want = as_uint32(render_camera_batch(Renderer.create(
        lods(), dataclasses.replace(cfg, backend="xla"), device=cuda), CAMS))
    r = Renderer.create(lods(), cfg, device=cuda, compact=compact)
    march_loop.reset_launches()
    got = as_uint32(render_camera_batch(r, CAMS))
    counts = march_loop.kernel_launches()
    assert counts["roll_chunk"] > 0 and counts["rasterize_visits"] > 0
    assert counts["reproject_screens"] == 2  # one phase-2 launch a direction
    assert march_loop.graph_stats["launches"] == 2
    assert r._batch_graphs and all(
        (len(v.widths) > 1) == compact
        for g in r._batch_graphs.values() for v in g.variants.values())
    np.testing.assert_array_equal(got, want)
    for i, cam in enumerate(CAMS):
        np.testing.assert_array_equal(got[i], r.render(cam))


@pytest.mark.cuda
@pytest.mark.parametrize("argb", [False, True])
def test_batched_phase2_matches_plain_per_camera_on_cuda(cuda, argb):
    from cpuvox_tpu_torch.ops import reproject_kernel as rk
    from cpuvox_tpu_torch.parallel import batch

    r = Renderer.create(lods(), RenderConfig(**BASE, argb_records=argb),
                        device=cuda)
    frames = [r.frame_setup(cam) for cam in CAMS[:2] + CAMS[3:]]
    raybuf = torch.cat([r.march(f) for f in frames])
    _rb, _t, rw, rh, W, H, colors, skybox = r.phase2_args(frames[0], raybuf)
    args = (raybuf, [f.tables for f in frames], r.ray_capacity, rw, rh, W, H,
            colors, skybox)
    want = rk.reproject_screens_ref(*args)
    for fn in (rk.reproject_screens, rk.reproject_screens_per_camera):
        torch.testing.assert_close(fn(*args), want, rtol=0, atol=0)
    for j, f in enumerate(frames):
        np.testing.assert_array_equal(
            as_uint32(batch.phase2_group(r, raybuf, frames))[j],
            as_uint32(r.phase2(f, raybuf[j * r.ray_capacity:
                                         (j + 1) * r.ray_capacity])))


@pytest.mark.cuda
@pytest.mark.parametrize("gate", ["off", "on"])
def test_batch_step_reads_nothing_from_the_card(cuda, gate):
    """A warm step through the batch march graphs under
    ``set_sync_debug_mode("error")``: no host read; its screens == the
    plain batch's, and it captured nothing new."""
    cfg = RenderConfig(**BASE, occupancy_gate=gate)
    r = Renderer.create(lods(), cfg, device=cuda)
    render_camera_batch(r, CAMS)
    torch.cuda.synchronize()
    before = graphs_of(r)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = render_camera_batch(r, CAMS)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert graphs_of(r) == before
    want = render_camera_batch(Renderer.create(
        lods(), dataclasses.replace(cfg, backend="xla"), device=cuda), CAMS)
    np.testing.assert_array_equal(as_uint32(got), as_uint32(want))
