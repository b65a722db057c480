"""Small cells for the benchmark's CPU tests: a 64 x 32 x 64 terrain at
96 x 64 (one viewer) and at 48 x 32 (a camera batch of 8 agents), its files
in a directory of its own, as a later change would add them."""
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


def tiny_batch_traffic(dispatch="waited"):
    """A camera-batch mix: 8 agents a step at 48 x 32, looking both up and
    down."""
    return {"name": f"tiny-batch-{dispatch}", "entry": "render_camera_batch",
            "dispatch": dispatch, "width": 48, "height": 32, "path": "agents",
            "cameras_per_step": 8, "eye_height": 3.0, "speed": 1.5,
            "turn_deg": 20.0, "pitch_deg": [-20.0, 30.0], "check_steps": 2,
            "check_cameras": 2, "check_rays": 12}


@pytest.fixture
def tiny_dir(tmp_path):
    """A benchmark directory with the tiny configuration, both single-frame
    traffic mixes and both camera-batch mixes, and a BENCHMARK.json naming
    a cell of each."""
    (tmp_path / "configs").mkdir()
    (tmp_path / "traffic").mkdir()
    (tmp_path / "configs" / "tiny.json").write_text(json.dumps(TINY_CONFIG))
    mixes = [tiny_traffic(e) for e in ("render_device", "render")]
    mixes += [tiny_batch_traffic(d) for d in ("waited", "ahead")]
    for t in mixes:
        (tmp_path / "traffic" / f"{t['name']}.json").write_text(json.dumps(t))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"] = [{"name": "tiny", "file": "configs/tiny.json"}]
    bench["workloads"] = [
        {"name": "tiny-ahead", "config": "tiny", "traffic": "tiny-render_device", "chips": 1},
        {"name": "tiny-waited", "config": "tiny", "traffic": "tiny-render", "chips": 1},
        {"name": "tiny-batch-waited", "config": "tiny", "traffic": "tiny-batch-waited",
         "chips": 1},
        {"name": "tiny-batch-ahead", "config": "tiny", "traffic": "tiny-batch-ahead",
         "chips": 1}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path
