"""A configuration, a traffic mix and a per-layer metric are added as new
files and found by name; no file of the benchmark is edited."""
import hashlib
import json
import os
import time

from conftest import ROOT
from voxbench import harness, spec


def _tree_hash():
    h = hashlib.sha256()
    for d, dirs, files in sorted(os.walk(os.path.join(ROOT, "voxbench"))):
        dirs[:] = sorted(x for x in dirs if x != "__pycache__")
        for f in sorted(files):
            with open(os.path.join(d, f), "rb") as fh:
                h.update(f.encode() + fh.read())
    return h.hexdigest()


def test_added_files_are_found_and_run(tiny_dir):
    before = _tree_hash()
    (tiny_dir / "metrics").mkdir()
    (tiny_dir / "metrics" / "frames_per_window.py").write_text(
        '"""Frames in the traced window."""\n\nMOVES = "fps"\n\n\n'
        'def read(t):\n    return float(t.frames) if t.frames else None\n')
    bench = json.loads((tiny_dir / "BENCHMARK.json").read_text())
    bench["per_layer"].append(
        {"name": "frames_per_window", "unit": "frames", "better": "higher",
         "source": "host_clock", "layer": "device (one H100)", "moves": "fps",
         "workloads": ["tiny-waited"]})
    (tiny_dir / "BENCHMARK.json").write_text(json.dumps(bench))

    b = spec.load(str(tiny_dir))
    cell = spec.cell(b, "tiny-waited", root=str(tiny_dir),
                     traffic_dir=str(tiny_dir / "traffic"))
    assert cell.config["generator"] == "heightmap_world"
    assert cell.traffic["entry"] == "render"
    assert [m["name"] for m in cell.per_layer][-1] == "frames_per_window"
    assert spec.reader("frames_per_window", str(tiny_dir / "metrics")).MOVES == "fps"
    # the other cell does not list it
    other = spec.cell(b, "tiny-ahead", root=str(tiny_dir),
                      traffic_dir=str(tiny_dir / "traffic"))
    assert "frames_per_window" not in [m["name"] for m in other.per_layer]

    res = harness.run_cell(cell, 2**31 + 12345, 0.01, True, time.perf_counter(),
                           device="cpu", metrics_dir=str(tiny_dir / "metrics"),
                           cache_dir=str(tiny_dir / "cache"))
    assert res["correct"], res["check"]
    assert res["metrics"]["frames_per_window"]["value"] >= 1
    # the device metrics have nothing to read on the CPU and are left out
    assert "march_ms" not in res["metrics"]
    assert list(res)[-1] == "check"
    assert os.listdir(tiny_dir / "cache")
    assert _tree_hash() == before


def test_every_metric_has_a_reader_that_agrees():
    bench = spec.load()
    e2e = {e["name"]: e for e in bench["end_to_end"]}
    for m in bench["per_layer"]:
        mod = spec.reader(m["name"])
        assert mod.MOVES == m["moves"], m["name"]
        moved = e2e[m["moves"]]
        # every cell that reads the metric reports what it moves
        for w in m.get("workloads", [x["name"] for x in bench["workloads"]]):
            assert w in moved.get("workloads", [w]), (m["name"], w)
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
    for w in bench["workloads"]:
        cell = spec.cell(bench, w["name"])
        assert cell.traffic["name"] == w["traffic"]
        names = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in names and len(names) >= 2 and cell.per_layer
