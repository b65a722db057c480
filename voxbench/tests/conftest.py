"""A small cell for the benchmark's CPU tests: a 64 x 32 x 64 terrain at
96 x 64, its files in a directory of its own, as a later change would add
them."""
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_CONFIG = {
    "name": "tiny", "generator": "heightmap_world",
    "params": {"dims": [64, 32, 64], "seed": 5, "shell_depth": 4, "lod_levels": 4},
    "render": {"fov_y_deg": 85.0, "near_clip": 0.05, "lod_levels": 4,
               "lod_error": 1.0, "render_scale": 1.0, "skybox_rgb": [25, 25, 25],
               "occupancy_gate": "auto"},
    "gate_resolves": False}


def tiny_traffic(entry="render_device"):
    with open(os.path.join(ROOT, "voxbench", "traffic", "fly1080-ahead.json")) as f:
        t = json.load(f)
    t.update(name=f"tiny-{entry}", entry=entry, width=96, height=64,
             cameras_per_pass=12, warmup_stride=6, check_frames=2,
             check_rays=12)
    return t


@pytest.fixture
def tiny_dir(tmp_path):
    """A benchmark directory with the tiny configuration and both traffic
    mixes, and a BENCHMARK.json naming a cell of each."""
    (tmp_path / "configs").mkdir()
    (tmp_path / "traffic").mkdir()
    (tmp_path / "configs" / "tiny.json").write_text(json.dumps(TINY_CONFIG))
    for entry in ("render_device", "render"):
        t = tiny_traffic(entry)
        (tmp_path / "traffic" / f"{t['name']}.json").write_text(json.dumps(t))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"] = [{"name": "tiny", "file": "configs/tiny.json"}]
    bench["workloads"] = [
        {"name": "tiny-ahead", "config": "tiny", "traffic": "tiny-render_device", "chips": 1},
        {"name": "tiny-waited", "config": "tiny", "traffic": "tiny-render", "chips": 1}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path
