"""The rest of a run, without the look for a card, with the timed path broken
underneath: ``correct`` has to come out false for each fault a cell can have
(one card: no exchange between cards to leave out)."""
import time

import pytest

from voxbench import harness, spec
from voxbench.faults import half_rays as _half_rays
from voxbench.faults import pixel as _pixel
from voxbench.faults import stale as _stale


def _run(tiny_dir, workload, fault, seed=987654321987):
    b = spec.load(str(tiny_dir))
    cell = spec.cell(b, workload, root=str(tiny_dir),
                     traffic_dir=str(tiny_dir / "traffic"))
    return harness.run_cell(cell, seed, 0.01, False, time.perf_counter(),
                            device="cpu", cache_dir=str(tiny_dir / "cache"),
                            fault=fault)


@pytest.mark.parametrize("workload", ["tiny-ahead", "tiny-waited"])
def test_a_sound_run_is_correct(tiny_dir, workload):
    res = _run(tiny_dir, workload, None)
    assert res["correct"] and res["failed"] == 0, res["check"]
    assert res["check"]["rays_checked"]["value"] == 12


@pytest.mark.parametrize("fault,number", [
    (_stale, "texels_off"), (_half_rays, "texels_off"), (_pixel, "pixels_off")])
@pytest.mark.parametrize("workload", ["tiny-ahead", "tiny-waited"])
def test_a_fault_is_not_correct(tiny_dir, workload, fault, number):
    res = _run(tiny_dir, workload, fault)
    assert not res["correct"] and res["failed"] >= 1
    assert res["check"][number]["value"] > 0, res["check"]
