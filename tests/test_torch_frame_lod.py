"""The port's Renderer against the JAX Renderer on worlds with a real LOD
chain: the 6-level floor (64, 16, 64) and a small procedural heightmap, the
content class of the benchmark scene (terrain2048), in both iteration
directions.  Bit-exact screens and raybuffers."""
import pytest

from cpuvox_tpu.render import camera as cm
from cpuvox_tpu_torch.render.frame import Renderer

from test_torch_frame import (SCREEN, assert_frames_equal, config,
                              jax_reference, lods_for)

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
