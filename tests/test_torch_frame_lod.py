"""The port's Renderer against the JAX Renderer on worlds with a real LOD
chain: the 6-level floor (64, 16, 64) and a small procedural heightmap, the
content class of the benchmark scene (terrain2048), in both iteration
directions.  Bit-exact screens and raybuffers."""
import pytest

from cpuvox_tpu.render import camera as cm
from cpuvox_tpu_torch.render.frame import Renderer

from test_torch_frame import (SCREEN, assert_frames_equal, config,  # noqa: F401
                              cuda, jax_reference, lods_for)

LOD_CASES = [
    ("lod_chain", "lod_chain", (32, 4, 32), 12.0, 30.0, 0.0),
    ("terrain", "terrain", (-10, 40, -10), 20.0, 45.0, 0.0),
    ("terrain_rolled", "terrain", (30, 36, 20), 35.0, 200.0, 190.0),
    ("terrain_up", "terrain", (64, 12, 64), -15.0, 130.0, 0.0),
]


@pytest.mark.parametrize("name,scene,pos,pitch,yaw,roll", LOD_CASES)
def test_renderer_matches_jax_xla_with_lods(name, scene, pos, pitch, yaw,
                                            roll):
    lods = lods_for(scene)
    assert len({w.lod for w in lods}) == len(lods) == 6
    cam = cm.Camera(position=pos, pitch_deg=pitch, yaw_deg=yaw, roll_deg=roll,
                    screen=SCREEN)
    want = jax_reference(lods, cam)
    r = Renderer.create(lods, config(), device="cpu")
    got = r.render(cam, return_raybuffers=True)
    assert_frames_equal(name, got, want)
    # the camera's LOD distances make rays switch LODs inside the world
    assert r.lod_distances[0] < max(r.device_world.dims)


# lod_levels past the roll kernel's 8 register-held distances on the 6-level
# terrain: lod_error 256 puts the distances a few cells apart, so rays walk
# up to LOD 8 (lod_levels 9) and 9 (lod_levels 10), where the column tables
# (8 entries) clamp the LOD to 7 as JAX's gather does
DEEP_LOD_CASES = [(9, (-10, 40, -10), 20.0, 45.0),
                  (10, (64, 12, 64), -15.0, 130.0)]


@pytest.mark.parametrize("lod_levels,pos,pitch,yaw", DEEP_LOD_CASES)
def test_renderer_past_8_lods_matches_jax(lod_levels, pos, pitch, yaw):
    lods = lods_for("terrain")
    kw = dict(lod_levels=lod_levels, lod_error=256.0)
    cam = cm.Camera(position=pos, pitch_deg=pitch, yaw_deg=yaw, screen=SCREEN)
    want = jax_reference(lods, cam, **kw)
    r = Renderer.create(lods, config(**kw), device="cpu")
    got = r.render(cam, return_raybuffers=True)
    assert len(r.lod_distances) == lod_levels
    assert r.lod_distances[7] < max(r.device_world.dims)  # LOD 8 is reached
    assert_frames_equal(f"lod_levels {lod_levels}", got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("lod_levels,pos,pitch,yaw", DEEP_LOD_CASES)
@pytest.mark.parametrize("gate", ["off", "on"])
def test_renderer_past_8_lods_on_cuda_matches_plain(cuda, lod_levels, pos,
                                                    pitch, yaw, gate):
    from cpuvox_tpu_torch.ops import roll_kernel

    lods = lods_for("terrain")
    cfg = config(lod_levels=lod_levels, lod_error=256.0, occupancy_gate=gate)
    cam = cm.Camera(position=pos, pitch_deg=pitch, yaw_deg=yaw, screen=SCREEN)
    want = Renderer.create(lods, cfg, device="cpu").render(
        cam, return_raybuffers=True)
    before = roll_kernel.launches
    got = Renderer.create(lods, cfg, device=cuda).render(
        cam, return_raybuffers=True)
    assert roll_kernel.launches > before
    assert_frames_equal(f"lod_levels {lod_levels}, gate {gate}", got, want)
