"""The program's recorder (``utils/profiling.py``): frames and their host
spans, process spans, the ring, turning it off, the device timers' split
(``csrc/timer.cuh``) and, on the card (``cuda``), the march graph's
sampled timers.

- the set-up's spans nest under the frame's ``frame_setup`` span and sum
  to within 5 % of it; ``march`` and ``phase2`` sit beside it;
- the ring gives the last n frames and drops the oldest;
- the recorder turned off records nothing, and a frame's raybuffer and
  screen are the same with it on and off;
- the timer words' split partitions a frame's graph time, on launches
  folded as the kernels fold them;
- on the card: sampled and unsampled warm frames make no host read
  (``set_sync_debug_mode("error")``); the raybuffers are bit-equal with the
  timers on and off; a sampled frame's four device spans lie within 5 % of
  CUDA events around the graph launch, its launches and slots agree with
  the graph's own counters, and ``%globaltimer`` steps forward.
"""
import itertools

import pytest
import torch

from cpuvox_tpu_torch.config import RenderConfig
from cpuvox_tpu_torch.models.procedural import heightmap_world, layered_world
from cpuvox_tpu_torch.render import camera as cm
from cpuvox_tpu_torch.render.frame import Renderer
from cpuvox_tpu_torch.utils import profiling

# the tests' tensors are tiny: more threads only contend with the other
# test workers
torch.set_num_threads(1)

SCREEN = (96, 64)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m cuda")
    return torch.device("cuda")


@pytest.fixture
def rec(monkeypatch):
    """A recorder of its own in ``PROFILER``'s place, turned on."""
    r = profiling.Recorder()
    monkeypatch.setattr(profiling, "PROFILER", r)
    monkeypatch.setattr(profiling, "ENABLED", True)
    return r


def small_renderer(device="cpu", screen=SCREEN, gate="off"):
    lods = heightmap_world(dims=(64, 32, 64), seed=5, shell_depth=4,
                           lod_levels=4)
    return Renderer.create(lods, RenderConfig(width=screen[0],
                                              height=screen[1],
                                              occupancy_gate=gate),
                           device=device)


def cameras(n, screen=SCREEN, dims=(64, 32, 64)):
    return [cm.Camera(position=(dims[0] / 2 + 3 * k, dims[1] * 0.9,
                                -0.2 * dims[2]),
                      pitch_deg=14.0 + 5 * k, yaw_deg=10.0 * k, screen=screen)
            for k in range(n)]


def test_setup_spans_nest_under_the_frame_and_sum_to_it(rec):
    r = small_renderer()
    for cam in cameras(3):
        r.render_device(cam)
    assert [f.seq for f in rec.frames] == [0, 1, 2]
    assert rec.process_totals().keys() == {"world_pack", "world_upload"}
    for f in rec.frames:
        names = [s[0] for s in f.spans]
        assert names == ["frame_setup", "geometry", "tables", "rays", "march",
                         "phase2"]
        by = {s[0]: s for s in f.spans}
        setup = by["frame_setup"]
        assert setup[3] == -1 and by["march"][3] == by["phase2"][3] == -1
        parts = 0
        for name in ("geometry", "tables", "rays"):
            _n, t0, t1, parent = by[name]
            assert parent == 0 and setup[1] <= t0 <= t1 <= setup[2]
            parts += t1 - t0
        total = setup[2] - setup[1]
        assert abs(parts - total) <= 0.05 * total, (parts, total)
        assert f.t0 <= setup[1] and by["phase2"][2] <= f.t1
    s = rec.summary(3)
    assert s["frames"] == 3 and s["sampled"] == 0 and not s["device_ms"]
    assert set(s["host_ms"]) == {"frame", "frame_setup", "geometry", "tables",
                                 "rays", "march", "phase2"}


def test_ring_keeps_the_last_frames(monkeypatch):
    monkeypatch.setattr(profiling, "ENABLED", True)
    r = profiling.Recorder(frames=4, process=2)
    for k in range(6):
        with r.frame():
            with r.span("work"):
                with r.frame():  # a frame inside a frame is part of it
                    with r.span("inner"):
                        pass
        with r.process_span(f"p{k}") as numbers:
            numbers["k"] = k
    assert [f.seq for f in r.frames] == [2, 3, 4, 5]
    assert [f.seq for f in r.last(2)] == [4, 5]
    assert r.last(5) is None and r.last(0) is None
    assert r.summary(5) is None and r.summary(4)["frames"] == 4
    assert [s[0] for s in r.frames[-1].spans] == ["work", "inner"]
    assert r.frames[-1].spans[1][3] == 0  # inside "work"
    assert [(p[0], p[3]) for p in r.process] == [("p4", {"k": 4}),
                                                 ("p5", {"k": 5})]
    with r.span("outside"):  # no frame open: not recorded
        pass
    assert r.seq == 6 and len(r.frames) == 4


def test_recorder_off_records_nothing(rec, monkeypatch):
    monkeypatch.setattr(profiling, "ENABLED", False)
    r = small_renderer()
    for cam in cameras(2):
        r.render_device(cam)
    assert not rec.frames and not rec.process and rec.seq == 0
    assert rec.summary(1) is None and rec.process_totals() == {}


def test_frame_is_the_same_with_the_recorder_on_and_off(rec, monkeypatch):
    r = small_renderer()
    cams = cameras(2)
    on = [r.render_device(c)[:2] for c in cams]
    monkeypatch.setattr(profiling, "ENABLED", False)
    off = [r.render_device(c)[:2] for c in cams]
    assert len(rec.frames) == 2
    for (sa, ra), (sb, rb) in zip(on, off):
        assert torch.equal(sa, sb) and torch.equal(ra, rb)


def fold(words, kind, start, end):
    """``timer.cuh``'s ``fold_launch`` on a list of words."""
    k = len(profiling.KERNELS)
    if words[profiling.LAST_END]:
        words[profiling.GAP + k * words[profiling.LAST_KIND] + kind] += \
            start - words[profiling.LAST_END]
    else:
        words[profiling.FIRST_START] = start
    words[profiling.SPAN + kind] += end - start
    words[profiling.LAUNCHES + kind] += 1
    words[profiling.LAST_END] = end
    words[profiling.LAST_KIND] = kind


@pytest.mark.parametrize("stages", [(3,), (4, 2, 0, 1)])
def test_timer_split_partitions_the_graph_time(stages):
    """Launches as a staged graph makes them (a check, then per iteration
    roll, rasterizer, control; a stage may run none): the four parts are
    the spans, the gaps after a roll or rasterizer and the gaps after a
    control, and sum to the first start to the last end."""
    ROLL, RAST, CTRL = range(3)
    words = [0] * profiling.TIMER_WORDS
    t, starts = 1000, []
    want = dict.fromkeys(("roll", "rasterizer", "gate_glue",
                          "march_control"), 0)
    lengths = itertools.count(7)

    def launch(kind, name):
        nonlocal t
        gap, span = next(lengths) % 5 + 1, next(lengths)
        if words[profiling.LAST_END]:
            prev = words[profiling.LAST_KIND]
            want["march_control" if prev == CTRL else "gate_glue"] += gap
        fold(words, kind, t + gap, t + gap + span)
        starts.append(t + gap)
        want[name] += span
        t += gap + span

    for iterations in stages:
        launch(CTRL, "march_control")
        for _ in range(iterations):
            launch(ROLL, "roll")
            launch(RAST, "rasterizer")
            launch(CTRL, "march_control")
    split = profiling.device_split(words)
    assert {k: split[k] for k in want} == want
    assert sum(want.values()) == split["timed"] == t - starts[0]
    n = sum(stages)
    assert words[profiling.LAUNCHES:profiling.LAUNCHES + 3] == [
        n, n, n + len(stages)]


# ------------------------------------------------------------- on the card

def card_scene(kind):
    if kind == "terrain":
        return heightmap_world(dims=(512, 128, 512), seed=3, shell_depth=6,
                               lod_levels=6), "off"
    return layered_world(dims=(256, 512, 256), seed=99, shell_depth=8,
                         n_layers=13, lod_levels=6, footprint=0.55), "on"


def card_renderer(kind, device, screen=(640, 360)):
    lods, gate = card_scene(kind)
    return Renderer.create(lods, RenderConfig(width=screen[0],
                                              height=screen[1],
                                              occupancy_gate=gate),
                           device=device)


def card_cameras(r, n=3, screen=(640, 360)):
    from cpuvox_tpu_torch.bench import path as bench_path

    return [bench_path.benchmark_camera(
        t * bench_path.BENCH_CLIP_LENGTH, r.device_world.dims, screen)
        for t in (0.35, 0.6, 0.9)[:n]]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["terrain", "layered"])
def test_sampled_and_unsampled_frames_read_nothing(cuda, rec, monkeypatch,
                                                   kind):
    monkeypatch.setattr(profiling, "SAMPLE_PERIOD", 2)
    r = card_renderer(kind, cuda)
    cams = card_cameras(r)
    for cam in cams:  # warm: every variant captured
        r.render_device(cam)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for cam in cams + cams[:1]:
            r.render_device(cam)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sampled = [f.row is not None for f in rec.last(4)]
    assert sampled == [f.seq % 2 == 0 for f in rec.last(4)]
    assert any(sampled) and not all(sampled)
    s = rec.summary(4)
    assert s["sampled"] == 2 and s["device_ms"]["timed"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["terrain", "layered"])
def test_timers_leave_the_raybuffer_as_it_was(cuda, rec, monkeypatch, kind):
    monkeypatch.setattr(profiling, "SAMPLE_PERIOD", 1)
    r = card_renderer(kind, cuda)
    cams = card_cameras(r)
    timed = [r.render_device(c)[:2] for c in cams]
    assert all(f.row is not None for f in rec.frames)
    monkeypatch.setattr(profiling, "ENABLED", False)
    untimed = [r.render_device(c)[:2] for c in cams]
    for (sa, ra), (sb, rb) in zip(timed, untimed):
        assert torch.equal(ra, rb) and torch.equal(sa, sb)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["terrain", "layered"])
def test_device_spans_match_events_around_the_graph(cuda, rec, monkeypatch,
                                                    kind):
    from cpuvox_tpu_torch.ops import march_loop

    monkeypatch.setattr(profiling, "SAMPLE_PERIOD", 1)
    r = card_renderer(kind, cuda, screen=(1920, 1080))
    cams = card_cameras(r, screen=(1920, 1080))
    for cam in cams:
        r.render_device(cam)
    events = []
    launch = march_loop.MarchGraphExec.launch

    def timed_launch(self, stream):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record(stream)
        launch(self, stream)
        e1.record(stream)
        events.append((e0, e1))

    monkeypatch.setattr(march_loop.MarchGraphExec, "launch", timed_launch)

    def events_ns():
        e0, e1 = events[-1]
        return e0.elapsed_time(e1) * 1e6

    # the events also hold what the timers leave out: the graph's launch,
    # its prologue and whatever follows the last control kernel.  That is
    # measured on frames of the same variant whose rays are all dead (the
    # stages' checks and packs alone run, and are timed) and taken off
    setup = Renderer.frame_setup

    def dead_setup(self, *a, **kw):
        f = setup(self, *a, **kw)
        return f._replace(alive0=torch.zeros_like(f.alive0))

    outside = []
    for cam in cams:
        monkeypatch.setattr(Renderer, "frame_setup", dead_setup)
        runs = []
        for _ in range(3):
            r.render_device(cam)
            torch.cuda.synchronize()
            (_f, row), = rec.rows(rec.last(1))
            assert row[profiling.LAUNCHES] == 0, "a dead frame rolled"
            runs.append(events_ns() - profiling.device_split(row)["timed"])
        outside.append(sorted(runs)[1])
        monkeypatch.setattr(Renderer, "frame_setup", setup)
    torch.cuda.synchronize()
    for cam, out_ns in zip(cams, outside):
        n0 = march_loop.graph_stats["iterations"]
        c0 = march_loop.graph_stats["checks"]
        s0 = march_loop.stage_stats.read()
        r.render_device(cam)
        torch.cuda.synchronize()
        its = march_loop.graph_stats["iterations"] - n0
        checks = march_loop.graph_stats["checks"] - c0
        s1 = march_loop.stage_stats.read()
        slots = sum(w * (n - s0.get(w, 0)) for w, n in s1.items())
        (f, row), = rec.rows(rec.last(1))
        split = profiling.device_split(row)
        parts = sum(split[k] for k in ("roll", "rasterizer", "gate_glue",
                                       "march_control"))
        assert parts == split["timed"]
        ev_ns = events_ns() - out_ns
        assert abs(parts - ev_ns) <= 0.05 * ev_ns, (parts, ev_ns, out_ns)
        assert row[profiling.LAUNCHES:profiling.LAUNCHES + 3] == [
            its, its, its + checks]
        assert row[profiling.SLOTS] == slots
        assert 0 < row[profiling.LIVE] <= slots
        assert min(split[k] for k in ("roll", "rasterizer")) > 0
        host = rec.frames[-1]
        start = row[profiling.FIRST_START] + f.clock_offset
        assert host.t0 <= start, "the graph starts after the frame opens"
    steps = march_loop.globaltimer_steps(cuda, 64)
    assert min(steps) > 0
