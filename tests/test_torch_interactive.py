"""The port's interactive frontend: ``InteractiveSession`` against the JAX
package's (the same inputs give the same cameras, over a stub renderer, so
no JAX compile is needed), its frames in render modes 1/2/3 against the
port's oracle copy, ``FrameProfiler``, the demo on the CPU and the harness's
scripted inputs.  Exact comparisons throughout."""
import dataclasses
import types

import numpy as np
import pytest
import torch

import scenes
from cpuvox_tpu_torch.bench import harness
from cpuvox_tpu_torch.config import RenderConfig
from cpuvox_tpu_torch.frontend.interactive import InteractiveSession
from cpuvox_tpu_torch.render import oracle
from cpuvox_tpu_torch.utils.profiling import FrameProfiler

torch.set_num_threads(1)

SCREEN = (64, 48)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m cuda")
    return torch.device("cuda")


class StubRenderer:
    """What a session reads of a renderer: ``render``, the world's dims and
    the config's screen size.  Records the cameras it is asked to render."""

    def __init__(self, dims=(64, 32, 64), wh=SCREEN):
        self.device_world = types.SimpleNamespace(dims=dims)
        self.config = types.SimpleNamespace(width=wh[0], height=wh[1])
        self.cams = []

    def render(self, cam, return_raybuffers=False):
        self.cams.append(cam)
        frame = np.zeros((self.config.height, self.config.width), np.uint32)
        return (frame, (frame, frame)) if return_raybuffers else frame


def session_inputs():
    """``bench.py``'s warmup and timed inputs, then a scroll each way, the
    render modes and a strafe."""
    steps = [(1 / 30, kw) for kw in harness.WARMUP_INPUTS
             + harness.interactive_inputs(24)]
    steps += [(1 / 60, dict(scroll=1.0, forward=-1.0)),
              (1 / 60, dict(scroll=-1.0, strafe=1.0, mode=2)),
              (0.1, dict(strafe=-1.0, mouse_dy=-300.0, mode=3)),
              (0.05, dict(mouse_dx=-12.5, mode=1))]
    return steps


def test_inputs_are_bench_pys():
    """``bench.py:302-309``: two warmup steps, then forward flight while
    turning, the pitch rocking every 4 steps."""
    assert harness.WARMUP_INPUTS == [dict(forward=0.0), dict(mouse_dy=40.0)]
    ins = harness.interactive_inputs(24)
    assert len(ins) == 24
    assert [d["mouse_dy"] for d in ins[:8]] == [2.0] * 4 + [-2.0] * 4
    assert all(d["forward"] == 1.0 and d["mouse_dx"] == 6.0 for d in ins)


def test_session_cameras_match_jax():
    from cpuvox_tpu.frontend.interactive import InteractiveSession as Jax

    jr, tr = StubRenderer(), StubRenderer()
    js, ts = Jax.create(None, renderer=jr), InteractiveSession.create(
        None, renderer=tr)
    for dt, kw in session_inputs():
        js.step(dt, **kw)
        ts.step(dt, **kw)
        assert dataclasses.asdict(ts.cam) == dataclasses.asdict(js.cam), kw
        assert ts.mode == js.mode
        assert ts.fly.move_speed == js.fly.move_speed
        assert (ts.look._smooth_x, ts.look._smooth_y) == (
            js.look._smooth_x, js.look._smooth_y)
    assert len(tr.cams) == len(jr.cams) == len(session_inputs())
    for a, b in zip(tr.cams, jr.cams):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert ts.fps > 0


def test_session_frames_match_oracle():
    """Modes 1/2/3 of the port's session (CPU, plain path) against the port's
    oracle on the frame geometry the session's renderer used."""
    lods = [scenes.random_world(dims=(32, 16, 32), n=400, seed=3)] * 6
    cfg = RenderConfig(width=SCREEN[0], height=SCREEN[1], chunk_steps=8,
                       max_march_chunks=64, backend="xla")
    s = InteractiveSession.create(lods, cfg, device="cpu")
    seen = []
    render = s.renderer.render

    def spy(cam, return_raybuffers=False):
        out = render(cam, return_raybuffers=True)
        seen.append(out[1][2:])
        return out if return_raybuffers else out[0]

    s.renderer.render = spy
    for dt, kw in ((0.1, dict(forward=1.0, mode=1)),
                   (0.1, dict(mouse_dx=3.0, mode=2)),
                   (0.1, dict(mouse_dy=-20.0, strafe=1.0, mode=3))):
        frame = s.step(dt, **kw)
        segs, ctxs, vps, cam_data, cam = seen[-1]
        td, lr = oracle.render_raybuffers_oracle(lods, cam, cam_data, segs,
                                                 ctxs)
        want = {1: oracle.reproject_oracle(cam, segs, ctxs, vps, td, lr),
                2: td[:frame.shape[0], :frame.shape[1]],
                3: lr[:frame.shape[0], :frame.shape[1]]}[s.mode]
        np.testing.assert_array_equal(frame, want)
    assert not (s.step(0.0, mode=1) == np.uint32(0xFFFF1493)).any()


def test_frame_profiler_counts_and_formats():
    p = FrameProfiler()
    for _ in range(3):
        with p.scope("render"):
            pass
    with p.scope("write"):
        sum(range(20000))
    assert dict(p.counts) == {"render": 3, "write": 1}
    lines = p.report().splitlines()
    assert len(lines) == 2 and lines[0].startswith("write")
    assert lines[1].split()[0] == "render" and lines[1].endswith("x3")
    assert "ms total" in lines[0] and "ms/call" in lines[0]
    p.reset()
    assert p.report() == "" and not p.counts


def test_frame_profiler_trace(tmp_path, monkeypatch):
    """The recorder's Chrome trace from ``start_device_trace`` to
    ``stop_device_trace``: the frames rendered in between with their host
    spans and the profiler's scopes, and nothing from before."""
    import json

    from cpuvox_tpu_torch.render import camera as cm
    from cpuvox_tpu_torch.render.frame import Renderer
    from cpuvox_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "PROFILER", profiling.Recorder())
    monkeypatch.setattr(profiling, "ENABLED", True)
    r = Renderer.create([scenes.tower_world()] * 6,
                        RenderConfig(width=32, height=24), device="cpu")
    cam = cm.Camera(position=(8.0, 9.0, -6.0), pitch_deg=10.0, yaw_deg=0.0,
                    screen=(32, 24))
    r.render_device(cam)
    p = FrameProfiler("cpu")
    p.start_device_trace(str(tmp_path))
    with p.scope("render"):
        r.render_device(cam)
    path = p.stop_device_trace()
    assert path == str(tmp_path / "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e["name"] for e in events}
    assert {"frame 1", "render", "frame_setup", "geometry", "tables", "rays",
            "march", "phase2"} <= names
    assert not names & {"frame 0", "world_pack", "world_upload"}
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in events)
    frame = next(e for e in events if e["name"] == "frame 1")
    setup = next(e for e in events if e["name"] == "frame_setup")
    assert frame["ts"] <= setup["ts"] and frame["tid"] == setup["tid"]


@pytest.mark.cuda
def test_frame_profiler_events(cuda):
    p = FrameProfiler(cuda)
    for _ in range(2):
        with p.scope("matmul"):
            x = torch.ones((512, 512), device=cuda)
            (x @ x).sum()
    assert p.counts["matmul"] == 2 and len(p._pending) == 2
    assert p.report().split()[0] == "matmul" and not p._pending
    assert p.totals["matmul"] > 0


def test_demo_converts_and_renders_on_cpu(tmp_path):
    from cpuvox_tpu_torch import demo

    obj = tmp_path / "tri.obj"
    obj.write_text("v 0 0 0 1 0 0\nv 9 0 0 0 1 0\nv 9 6 4 0 0 1\n"
                   "v 0 5 8 1 1 1\nf 1 2 3 4\nf -4 -2 -1\n")
    out = tmp_path / "frames"
    demo.main(["--obj", str(obj), "--max-dim", "32", "--width", "32",
               "--height", "24", "--frames", "1", "--device", "cpu",
               "--backend", "xla", "--save", str(tmp_path / "tri.world"),
               "--out", str(out), "--profile"])
    assert (out / "frame_000.ppm").stat().st_size > 0
    assert (tmp_path / "tri.world").stat().st_size > 0
    assert (out / "trace.json").stat().st_size > 0


@pytest.mark.parametrize("argv,error", [
    (["--world-shard", "--interactive"], NotImplementedError),
    (["--world-shard", "--tile-cols", "128", "--interactive"],
     NotImplementedError),
    (["--scene", "mill"], FileNotFoundError)])
def test_demo_refuses(argv, error, tmp_path):
    from cpuvox_tpu_torch import demo

    with pytest.raises(error, match="mill.obj|not ported"):
        demo.main(argv + ["--device", "cpu", "--out", str(tmp_path)])
