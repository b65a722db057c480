"""The port's benchmark entry (``cpuvox_tpu_torch/bench/entry.py``, run as
``python -m cpuvox_tpu_torch.bench``) against ``bench.py``: the scene table,
the deadline guard, the verify gate, the metric names and the failure
record with no card; and ``render/frame.py::render_frame`` against the JAX
``render_frame``.  Exact; nothing here builds a full-size world.  The
``cuda`` case runs the rollout mode end to end on the card."""
import json
import os
import signal
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import scenes
from cpuvox_tpu_torch.bench import entry, harness
from cpuvox_tpu_torch.config import RenderConfig
from cpuvox_tpu_torch.render import camera as cm
from cpuvox_tpu_torch.render.frame import Renderer, render_frame

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(width=64, height=48, chunk_steps=8, max_march_chunks=64)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m cuda")
    return torch.device("cuda")


def run_entry(scene, timeout=600, **env):
    """``python -m cpuvox_tpu_torch.bench`` in a child; (rc, stdout lines,
    stderr, seconds)."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "cpuvox_tpu_torch.bench"],
                       cwd=REPO, env={**os.environ, "BENCH_SCENE": scene,
                                      **env},
                       capture_output=True, text=True, timeout=timeout)
    return (r.returncode, r.stdout.splitlines(), r.stderr,
            time.perf_counter() - t0)


# ---------------------------------------------------------------- scenes


@pytest.mark.parametrize("scene", ["terrain2048", "terrain1024",
                                   "layered2048", "layered1024", "layered"])
def test_scene_table_equals_bench_py(scene, monkeypatch):
    """The port's builder calls the procedural function ``bench.build_world``
    calls, with the same keyword arguments, under the same cache name."""
    import bench
    from cpuvox_tpu.models import procedural as jax_procedural
    from cpuvox_tpu.world import save as jax_save
    from cpuvox_tpu_torch.models import procedural as port_procedural

    calls = []

    def recorder(package, fn):
        def build(**kwargs):
            calls.append((package, fn, kwargs))
            return [SimpleNamespace(voxel_count=0)]
        return build

    for package, mod in (("jax", jax_procedural), ("port", port_procedural)):
        for fn in ("heightmap_world", "layered_world"):
            monkeypatch.setattr(mod, fn, recorder(package, fn))

    def no_cache(path):
        raise FileNotFoundError(path)

    monkeypatch.setattr(jax_save, "load_world", no_cache)
    monkeypatch.setattr(jax_save, "save_world", lambda path, lods: None)
    monkeypatch.setattr(os, "makedirs", lambda *a, **k: None)
    names = []

    def cached(name, build, log):
        names.append(name)
        return build()

    monkeypatch.setattr(harness, "_cached", cached)
    bench.build_world(scene)
    harness.scene_world(scene)
    assert [c[0] for c in calls] == ["jax", "port"]
    assert calls[0][1:] == calls[1][1:]
    assert names == [scene]
    assert harness.CACHE_DIR == os.path.join(
        os.path.dirname(os.path.abspath(bench.__file__)), ".bench_cache")


def test_mill_needs_its_obj(monkeypatch):
    """mill<N> converts the reference's mill.obj and nothing in its place."""
    monkeypatch.setattr(entry, "MILL_OBJ", os.path.join(REPO, "no_such.obj"))
    with pytest.raises(FileNotFoundError, match="not in the repository"):
        entry.mesh_obj("mill")


# ----------------------------------------------- the deadline guard


def test_stage_budget_raises():
    with pytest.raises(entry.StageTimeout, match="probe"):
        with entry.stage_budget(1, "probe"):
            time.sleep(2.5)


def test_stage_budget_clears_alarm():
    with entry.stage_budget(60, "noop"):
        pass
    assert signal.alarm(0) == 0  # no pending alarm left


def test_remaining_counts_down():
    assert entry.remaining() < float(
        os.environ.get("BENCH_DEADLINE_S", "1500")) + 1


# ------------------------------------------------------- the verify gate


@pytest.fixture
def stub_renderer():
    """A stand-in for a Renderer whose kernel and plain paths give set
    outputs: ``outputs[backend] = (screen, raybuffer)``."""
    import dataclasses

    @dataclasses.dataclass
    class Stub:
        config: RenderConfig
        device_world: SimpleNamespace
        outputs: dict

        def render_device(self, cam):
            screen, raybuf = self.outputs[self.config.backend]
            return screen.clone(), raybuf.clone(), None

    screen = torch.arange(48 * 64, dtype=torch.int32).reshape(48, 64)
    raybuf = torch.arange(200 * 48, dtype=torch.int32).reshape(200, 48)
    return Stub(RenderConfig(**SMALL), SimpleNamespace(dims=(64, 32, 64)),
                {"pallas": (screen, raybuf), "xla": (screen, raybuf)})


@pytest.mark.parametrize("where", ["equal", "screen", "raybuffer"])
def test_verify_gate(stub_renderer, where, capsys):
    screen, raybuf = (t.clone() for t in stub_renderer.outputs["xla"])
    if where == "screen":
        screen[17, 5] += 1
    elif where == "raybuffer":
        raybuf[123, 7] -= 1
    stub_renderer.outputs["pallas"] = (screen, raybuf)
    if where == "equal":
        entry.verify_backends(stub_renderer)
        assert capsys.readouterr().out == ""
        return
    with pytest.raises(SystemExit) as e:
        entry.verify_backends(stub_renderer)
    assert e.value.code == 1
    rec = json.loads(capsys.readouterr().out)
    assert rec["metric"] == "BACKEND_DIVERGENCE" and rec["value"] == 1
    assert rec["unit"] == "pixels" and rec["vs_baseline"] == 0.0
    assert (rec["screen_pixels"], rec["raybuffer_texels"]) == (
        (1, 0) if where == "screen" else (0, 1))


def test_verify_gate_on_a_renderer(capsys):
    """The gate on a real Renderer (on the CPU both paths are the plain
    versions): the plain Renderer it makes shares the device world."""
    r = Renderer.create([scenes.tower_world(x=8, z=12, height=10)] * 6,
                        RenderConfig(**SMALL), device="cpu")
    entry.verify_backends(r)
    assert capsys.readouterr().out == ""


# ----------------------------------------------------------- the records


@pytest.mark.parametrize("scene,wh,names,failed,unit", [
    # bench.py:409: f"fps_{scene}_{w}x{h}"
    ("terrain2048", (1920, 1080), ["fps_terrain2048_1920x1080"],
     "fps_terrain2048_failed", "fps"),
    ("terrain1024", (1280, 720), ["fps_terrain1024_1280x720"],
     "fps_terrain1024_failed", "fps"),
    ("layered2048", (320, 180), ["fps_layered2048_320x180"],
     "fps_layered2048_failed", "fps"),
    ("layered", (1920, 1080), ["fps_layered_1920x1080"],
     "fps_layered_failed", "fps"),
    ("mill1024", (1920, 1080), ["fps_mill1024_1920x1080"],
     "fps_mill1024_failed", "fps"),
    ("town2048", (1920, 1080), ["fps_town2048_1920x1080"],
     "fps_town2048_failed", "fps"),
    # bench.py:246: f"rollout{n_cams}_cams_per_sec_{wh[0]}x{wh[1]}"
    ("rollout64", (1920, 1080), ["rollout64_cams_per_sec_256x256"],
     "rollout64_cams_per_sec_failed", "cams/s"),
    ("rollout", (1920, 1080), ["rollout64_cams_per_sec_256x256"],
     "rollout64_cams_per_sec_failed", "cams/s"),
    # bench.py:279: f"fps_dynamic{size}_{wh[0]}x{wh[1]}_rebuild_per_frame"
    ("dynamic512", (1920, 1080), ["fps_dynamic512_1280x720_rebuild_per_frame"],
     "fps_dynamic512_failed", "fps"),
    # bench.py:312: f"interactive_step_ms_p50_{scene}_{w}x{h}", scene
    # mill1024 by default
    ("interactive", (1920, 1080),
     ["interactive_step_ms_p50_mill1024_320x180",
      "interactive_step_ms_p50_mill1024_1920x1080"],
     "interactive_step_ms_p50_mill1024_failed", "ms"),
    ("interactive_town2048", (1920, 1080),
     ["interactive_step_ms_p50_town2048_320x180",
      "interactive_step_ms_p50_town2048_1920x1080"],
     "interactive_step_ms_p50_town2048_failed", "ms"),
    # harness.run_convert's key for the town at 2048
    ("convert_town2048", (1920, 1080),
     ["convert_town2048_seconds_steady_state"],
     "convert_town2048_seconds_steady_state_failed", "s"),
])
def test_metric_names(scene, wh, names, failed, unit):
    mode = entry.parse_mode(scene, wh)
    assert list(mode.metrics) == names
    assert (mode.failed, mode.unit) == (failed, unit)


@pytest.mark.parametrize("scene", ["nowhere", "convert_terrain2048",
                                   "interactive_nowhere"])
def test_unknown_scenes_refused(scene):
    with pytest.raises(ValueError):
        entry.parse_mode(scene)


@pytest.mark.parametrize("magenta", [0, 3])
def test_flythrough_record(monkeypatch, capsys, magenta):
    """The flythrough mode's record on a CPU Renderer, the world and the
    timed run stubbed: bench.py's keys and the port's, no ``verify`` key
    when the gate passed; a magenta pixel fails the mode."""
    lods = [scenes.tower_world(x=8, z=12, height=10)] * 6
    monkeypatch.setattr(entry, "world_lods", lambda scene: lods)
    create = Renderer.create.__func__
    monkeypatch.setattr(Renderer, "create", classmethod(
        lambda cls, lods, cfg, **kw: create(cls, lods, cfg, device="cpu",
                                            **kw)))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    metrics = dict(fps=40.0, fps_seq=40.0, fps_pipe=50.0, frame_ms_p50=25.0,
                   ray_columns_per_sec=1e5,
                   world_voxels_lod0=10, world_voxels=60, n_frames=3,
                   frame_gpu_ms_p50=24.0, magenta_pixels=magenta)
    monkeypatch.setattr(harness, "run_flythrough",
                        lambda r, n_frames, log: metrics)
    mode = entry.parse_mode("terrain2048", (64, 48))
    knobs = entry.Knobs(wh=(64, 48), frames=3, chunk=8, max_chunks=64)
    if magenta:
        with pytest.raises(RuntimeError, match="3 magenta"):
            entry.run_flythrough_mode(mode, knobs)
        return
    (rec,) = entry.run_flythrough_mode(mode, knobs)
    assert capsys.readouterr().out == ""  # the gate passed silently
    # the sequential and the pipelined pass, as bench.py:406-413 records them
    assert isinstance(rec["fps_seq"], float)
    assert isinstance(rec["fps_pipe"], float)
    assert rec == {
        "metric": "fps_terrain2048_64x48", "value": 40.0, "unit": "fps",
        "vs_baseline": 0.6667, "fps_seq": 40.0, "fps_pipe": 50.0,
        "frame_ms_p50": 25.0,
        "ray_columns_per_sec": 100000, "world_voxels_lod0": 10,
        "world_voxels_all_lods": 60, "n_frames": 3, "frame_gpu_ms_p50": 24.0,
        "magenta_pixels": 0}


@pytest.mark.parametrize("scene,failed,unit", [
    ("terrain2048", "fps_terrain2048_failed", "fps"),
    ("rollout64", "rollout64_cams_per_sec_failed", "cams/s")])
def test_no_card_prints_the_failure_record(scene, failed, unit):
    """With no card the entry exits 1 and its last line is the labeled
    failure record that names the missing device, within seconds: it builds
    no world first."""
    rc, out, err, seconds = run_entry(scene, timeout=120,
                                      CUDA_VISIBLE_DEVICES="")
    assert rc == 1, err
    assert "[world]" not in err
    rec = json.loads(out[-1])
    assert rec["metric"] == failed and rec["unit"] == unit
    assert rec["value"] == 0.0 and rec["vs_baseline"] == 0.0
    assert "no CUDA device" in rec["error"]
    assert all(json.loads(line) for line in out)
    assert seconds < 30, seconds


# ----------------------------------------------------------- render_frame


def test_render_frame_matches_jax():
    from cpuvox_tpu.config import RenderConfig as JaxRenderConfig
    from cpuvox_tpu.render import camera as jax_cm
    from cpuvox_tpu.render.frame import render_frame as jax_render_frame

    lods = [scenes.tower_world(x=8, z=12, height=10)] * 6
    pose = dict(position=(8.5, 5, 2), pitch_deg=5.0, yaw_deg=0.0,
                screen=(SMALL["width"], SMALL["height"]))
    want = jax_render_frame(lods, jax_cm.Camera(**pose), JaxRenderConfig(
        **SMALL, backend="xla", host_init=True))
    got = render_frame(lods, cm.Camera(**pose), RenderConfig(**SMALL),
                       device="cpu")
    assert got.dtype == np.uint32 and got.shape == (48, 64)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert (got != got[0, 0]).any(), "nothing was drawn"


# ------------------------------------------------------------- the card


@pytest.mark.cuda
def test_rollout_mode_on_cuda(cuda):
    rc, out, err, _ = run_entry("rollout64")
    assert rc == 0, err[-3000:]
    (rec,) = [json.loads(line) for line in out]
    assert rec["metric"] == "rollout64_cams_per_sec_256x256"
    assert rec["unit"] == "cams/s" and rec["value"] > 0
    assert rec["magenta_pixels"] == 0 and rec["card"]
