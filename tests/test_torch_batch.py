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
"""
import dataclasses

import numpy as np
import pytest
import torch

import scenes
from cpuvox_tpu.render import camera as cm
from cpuvox_tpu_torch.config import RenderConfig
from cpuvox_tpu_torch.parallel.batch import render_camera_batch
from cpuvox_tpu_torch.render.frame import Renderer

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
    r = Renderer.create(lods(), RenderConfig(**BASE, backend="xla"),
                        device="cpu")
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


@pytest.mark.cuda
@pytest.mark.parametrize("argb,gate,compact", MODES)
def test_batch_kernels_match_plain_on_cuda(cuda, argb, gate, compact):
    from cpuvox_tpu_torch.ops import (phase1_kernel, reproject_kernel,
                                      roll_kernel)

    cfg = RenderConfig(**BASE, argb_records=argb, occupancy_gate=gate)
    want = as_uint32(render_camera_batch(Renderer.create(
        lods(), dataclasses.replace(cfg, backend="xla"), device=cuda), CAMS))
    counts = (roll_kernel.launches, phase1_kernel.launches,
              reproject_kernel.screens_launches)
    r = Renderer.create(lods(), cfg, device=cuda, compact=compact)
    got = as_uint32(render_camera_batch(r, CAMS))
    after = (roll_kernel.launches, phase1_kernel.launches,
             reproject_kernel.screens_launches)
    assert all(a > b for a, b in zip(after, counts)), (counts, after)
    assert after[2] - counts[2] == 2  # one phase-2 launch a direction
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
