"""The readers of the program's own spans and counters
(``voxbench/metrics/<name>.py``), on a fake recorder in the program's
``PROFILER`` place: each reads its number from the recorder's summary of
the window's last ``t.frames`` frames or its process spans, and gives None
where the program has no such recorder (the program before it had one),
where the recorder kept fewer frames than the window's, and, for the
device's numbers, where no frame was sampled.  A traced run of the small
cell on the CPU reads the host spans, within the program's span around
the set-up, and leaves the device's numbers out."""
import time
import types

import pytest

from voxbench import harness, spec
from voxbench.trace import Trace

SUMMARY = {"frames": 40, "sampled": 5,
           "host_ms": {"frame": 9.0, "frame_setup": 6.5, "geometry": 1.25,
                       "tables": 0.5, "rays": 4.5, "march": 0.2,
                       "phase2": 0.1},
           "device_ms": {"roll": 0.5, "rasterizer": 12.0, "gate_glue": 4.0,
                         "march_control": 0.75, "timed": 17.25},
           "live_rays": 300.0, "slots": 1200.0}
PROCESS = {"world_pack": 11.5, "world_upload": 0.5, "graph_capture": 2.25}
EXPECTED = {"setup_geometry_ms": 1.25, "setup_tables_ms": 0.5,
            "setup_rays_ms": 4.5, "roll_ms": 0.5, "rasterizer_ms": 12.0,
            "gate_glue_ms": 4.0, "march_control_ms": 0.75,
            "live_slot_pct": 25.0, "world_pack_s": 11.5,
            "graph_capture_s": 2.25}
DEVICE = ("roll_ms", "rasterizer_ms", "gate_glue_ms", "march_control_ms",
          "live_slot_pct")


def fake(monkeypatch, summary=SUMMARY, process=PROCESS):
    from cpuvox_tpu_torch.utils import profiling

    asked = []

    def summarize(n):
        asked.append(n)
        return summary

    monkeypatch.setattr(profiling, "PROFILER", types.SimpleNamespace(
        summary=summarize, process_totals=lambda: dict(process)))
    return asked


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_the_recorder(monkeypatch, name):
    asked = fake(monkeypatch)
    assert spec.reader(name).read(Trace(frames=40)) == EXPECTED[name]
    assert asked in ([], [40])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_is_silent_without_a_recorder(monkeypatch, name):
    """The program before the recorder: its ``PROFILER`` has neither
    ``summary`` nor ``process_totals``."""
    from cpuvox_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "PROFILER", object())
    assert spec.reader(name).read(Trace(frames=40)) is None


@pytest.mark.parametrize("name", sorted(set(EXPECTED) - {"world_pack_s",
                                                          "graph_capture_s"}))
def test_reader_is_silent_on_a_window_longer_than_the_ring(monkeypatch, name):
    fake(monkeypatch, summary=None)
    assert spec.reader(name).read(Trace(frames=10 ** 6)) is None


@pytest.mark.parametrize("name", DEVICE)
def test_device_reader_is_silent_without_sampled_frames(monkeypatch, name):
    unsampled = {k: v for k, v in SUMMARY.items()
                 if k not in ("live_rays", "slots")}
    fake(monkeypatch, summary={**unsampled, "sampled": 0, "device_ms": {}})
    assert spec.reader(name).read(Trace(frames=40)) is None


def test_process_readers_are_silent_without_their_spans(monkeypatch):
    fake(monkeypatch, process={})
    for name in ("world_pack_s", "graph_capture_s"):
        assert spec.reader(name).read(Trace(frames=40)) is None


def test_traced_cpu_run_reads_the_host_spans(tiny_dir):
    b = spec.load(str(tiny_dir))
    cell = spec.cell(b, "tiny-waited", root=str(tiny_dir),
                     traffic_dir=str(tiny_dir / "traffic"))
    res = harness.run_cell(cell, 2**31 + 777, 0.01, True, time.perf_counter(),
                           device="cpu", cache_dir=str(tiny_dir / "cache"))
    assert res["correct"], res["check"]
    from cpuvox_tpu_torch.utils import profiling

    m = {k: v["value"] for k, v in res["metrics"].items()}
    parts = m["setup_geometry_ms"] + m["setup_tables_ms"] + m["setup_rays_ms"]
    whole = profiling.PROFILER.summary(res["attempted"])["host_ms"]
    assert 0 < parts <= whole["frame_setup"] <= whole["frame"]
    assert m["world_pack_s"] > 0
    assert not set(DEVICE) & set(m) and "graph_capture_s" not in m
