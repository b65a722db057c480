"""The port's phase 1 against JAX ``raymarch.phase1`` on deep 16-bit-packed
column records (``tests/scenes.py::deep_tower_world``: max_runs > 4, a
4-level LOD chain), in both iteration directions.  Bit-exact raybuffers."""
import pytest

from cpuvox_tpu.render.device import build_device_world, packed_run_words

from test_torch_raster import check_phase1_matches_jax, world

DEEP_CASES = [
    ("deep_tower", "deep", (-4, 40, 20), 20.0, 60.0),
    ("deep_tower_up", "deep", (30, 6, 30), -30.0, 120.0),
]


def test_deep_tower_uses_packed_inline_records():
    dw = build_device_world(world("deep"))
    assert dw.max_runs > 4 and dw.rec_fwd is not None
    assert packed_run_words(dw.max_runs) != dw.max_runs


@pytest.mark.parametrize("name,scene,pos,pitch,yaw", DEEP_CASES)
def test_phase1_matches_jax_on_packed_records(name, scene, pos, pitch, yaw):
    check_phase1_matches_jax(name, scene, pos, pitch, yaw)
