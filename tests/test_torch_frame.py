"""The port's Renderer against the JAX Renderer (backend "xla") and against
the golden fixtures; bit-exact screens and raybuffers.  Worlds whose LOD0 is
mostly empty (the random world) take the port's occupancy-gated march on the
default gate, the others its dense march.  Also: the port imports neither
jax nor the JAX package, and it refuses the settings it does not carry.  JAX
is imported inside the tests that compare with it, so the ``cuda`` tests also
run on the card's machine, which has no jax."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import scenes
from cpuvox_tpu.models.procedural import heightmap_world
from cpuvox_tpu.render import camera as cm
from cpuvox_tpu.world import rle
from cpuvox_tpu_torch.config import RenderConfig
from cpuvox_tpu_torch.render.frame import Renderer

from make_golden import CASES as GOLDEN_CASES, GOLDEN_DIR, build

# the tests' tensors are tiny: more threads only contend with the other
# test workers
torch.set_num_threads(1)

SCREEN = (64, 48)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m cuda")
    return torch.device("cuda")


BASE = dict(width=SCREEN[0], height=SCREEN[1], chunk_steps=8,
            max_march_chunks=64)


def config(**kw):
    """The port's RenderConfig for the tests' frames."""
    return RenderConfig(**{**BASE, **kw})


def lods_for(scene):
    if scene == "floor":
        return [scenes.flat_floor_world()] * 6
    if scene == "tower":
        return [scenes.tower_world(x=8, z=12, height=10)] * 6
    if scene == "random":
        return [scenes.random_world(n=300, seed=5)] * 6
    if scene == "lod_chain":  # 6-level LOD chain floor (64, 16, 64)
        return rle.build_lod_chain(scenes.flat_floor_world(dims=(64, 16, 64)), 6)
    assert scene == "terrain"  # the slice's own content class, small
    return heightmap_world(dims=(128, 32, 128), seed=3, shell_depth=6,
                           lod_levels=6)


# subset of tests/test_pallas_kernel.py CASES (floor_gentle and floor_up are
# held by the golden fixtures below) and the rolled cameras, ordered so that
# cases sharing a world and an iteration direction share one JAX compile.
# The LOD chain floor and the heightmap terrain are in test_torch_frame_lod.py
FRAME_CASES = [
    ("tower_horizon", "tower", (8.5, 5, 2), 0.0, 0.0, 0.0),
    ("roll359", "tower", (8.5, 5, 2), 5.0, 0.0, 359.0),
    ("outside_world", "random", (-6, 9, -6), 30.0, 45.0, 0.0),
    ("roll180", "random", (8, 10, 8), 25.0, 70.0, 180.0),
    ("floor_zenith", "random", (8, 2, 8), -89.0, 60.0, 0.0),
    ("random_up", "random", (8, 13, 8), -60.0, 200.0, 0.0),
]


def jax_reference(lods, cam, **kw):
    """The JAX Renderer on its XLA twin with host ray init: the init the port
    runs, so both start from the same bits (the device init is held equal to
    it by the JAX package's own tests)."""
    from cpuvox_tpu.config import RenderConfig as JaxRenderConfig
    from cpuvox_tpu.render.frame import Renderer as JaxRenderer

    cfg = JaxRenderConfig(**{**BASE, "backend": "xla", "host_init": True,
                             **kw})
    return JaxRenderer.create(lods, cfg).render(cam, return_raybuffers=True)


def assert_frames_equal(name, got, want):
    gs, (gtd, glr, *_) = got
    ws, (wtd, wlr, *_) = want
    for what, a, b in (("td", gtd, wtd), ("lr", glr, wlr), ("screen", gs, ws)):
        assert a.shape == b.shape, (name, what, a.shape, b.shape)
        diff = a != b
        assert not diff.any(), (
            f"{name}: {int(diff.sum())} {what} texels differ, first: "
            f"{np.argwhere(diff)[:5].tolist()}")
    assert not (gs == np.uint32(0xFFFF1493)).any(), f"{name}: magenta pixels"


@pytest.mark.parametrize("name,scene,pos,pitch,yaw,roll", FRAME_CASES)
def test_renderer_matches_jax_xla(name, scene, pos, pitch, yaw, roll):
    lods = lods_for(scene)
    cam = cm.Camera(position=pos, pitch_deg=pitch, yaw_deg=yaw, roll_deg=roll,
                    screen=SCREEN)
    want = jax_reference(lods, cam)
    got = Renderer.create(lods, config(), device="cpu").render(
        cam, return_raybuffers=True)
    assert_frames_equal(name, got, want)


def test_render_scale_upscale_matches_jax():
    lods = lods_for("random")
    cam = cm.Camera(position=(8, 10, 8), pitch_deg=25.0, yaw_deg=70.0,
                    screen=SCREEN)
    want, _ = jax_reference(lods, cam, render_scale=0.5)
    got = Renderer.create(lods, config(render_scale=0.5),
                          device="cpu").render(cam)
    assert got.shape == (SCREEN[1], SCREEN[0])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,scene,pos,pitch,yaw,roll", GOLDEN_CASES)
def test_renderer_matches_golden(name, scene, pos, pitch, yaw, roll):
    g = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))
    r = Renderer.create([build(scene)] * 6, config(), device="cpu")
    cam = cm.Camera(position=pos, pitch_deg=pitch, yaw_deg=yaw, roll_deg=roll,
                    screen=SCREEN)
    screen, (td, lr, *_rest) = r.render(cam, return_raybuffers=True)
    np.testing.assert_array_equal(td, g["td"][:td.shape[0], :td.shape[1]])
    np.testing.assert_array_equal(lr, g["lr"][:lr.shape[0], :lr.shape[1]])
    np.testing.assert_array_equal(screen, g["screen"])


def test_port_never_imports_jax():
    """Importing every module of the port and chip_smoke loads neither jax
    nor any module of the JAX package ``cpuvox_tpu``."""
    code = (
        "import sys, pkgutil, importlib\n"
        "import cpuvox_tpu_torch\n"
        "for m in pkgutil.walk_packages(cpuvox_tpu_torch.__path__,"
        " 'cpuvox_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import cpuvox_tpu_torch.render.frame, cpuvox_tpu_torch.bench.harness\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or"
        " k.startswith('jax.') or k.startswith('jaxlib'))\n"
        "assert not bad, bad\n"
        "ref = sorted(k for k in sys.modules if k == 'cpuvox_tpu' or"
        " k.startswith('cpuvox_tpu.'))\n"
        "assert not ref, ref\n"
        "print('ok', len([k for k in sys.modules"
        " if k.startswith('cpuvox_tpu_torch')]))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok"), r.stdout


@pytest.mark.parametrize("kw", [{"argb_records": True},
                                {"block_fetch": "on"},
                                {"lite_records": "auto"},
                                {"drain_groups": 4}])
def test_unported_settings_raise(kw):
    with pytest.raises(NotImplementedError):
        Renderer.create(lods_for("random"), config(**kw), device="cpu")


def test_split_record_layout_raises():
    """Columns with more than 60 runs use the split record layout."""
    dims = (16, 256, 16)
    ys = np.arange(0, 256, 2)  # alternating voxel/air: ~128 runs
    xz = np.full(ys.shape[0], 5 * dims[2] + 7)
    rgb = tuple(np.full(xz.shape[0], v, np.uint8) for v in (200, 90, 30))
    w = rle.build_lod_from_voxels(dims, 0, xz, ys, rgb)
    with pytest.raises(NotImplementedError):
        Renderer.create([w] * 6, config(), device="cpu")


def test_flythrough_refuses_cpu():
    from cpuvox_tpu_torch.bench.harness import run_flythrough

    with pytest.raises(RuntimeError):
        run_flythrough(Renderer.create(lods_for("floor"), config(),
                                       device="cpu"), n_frames=2)


@pytest.mark.cuda
@pytest.mark.parametrize("name,scene,pos,pitch,yaw,roll",
                         FRAME_CASES[1:5])
def test_renderer_on_cuda_matches_cpu(cuda, name, scene, pos, pitch, yaw,
                                      roll):
    from cpuvox_tpu_torch.ops import phase1_kernel, reproject_kernel, roll_kernel

    lods = lods_for(scene)
    cam = cm.Camera(position=pos, pitch_deg=pitch, yaw_deg=yaw, roll_deg=roll,
                    screen=SCREEN)
    want = Renderer.create(lods, config(), device="cpu").render(
        cam, return_raybuffers=True)
    counts = (roll_kernel.launches, phase1_kernel.launches,
              reproject_kernel.launches)
    got = Renderer.create(lods, config(), device=cuda).render(
        cam, return_raybuffers=True)
    after = (roll_kernel.launches, phase1_kernel.launches,
             reproject_kernel.launches)
    assert all(a > b for a, b in zip(after, counts)), (counts, after)
    assert_frames_equal(name, got, want)


@pytest.mark.cuda
def test_flythrough_on_cuda(cuda):
    from cpuvox_tpu_torch.bench.harness import run_flythrough

    r = Renderer.create(lods_for("terrain"), config(), device=cuda)
    m = run_flythrough(r, n_frames=3, log=lambda *a: None)
    assert m["n_frames"] == 3 and m["fps"] > 0 and m["frame_ms_p50"] > 0
    assert m["ray_columns_per_sec"] > 0
