"""Spans around the program's layers, taken from the benchmark's side.

``Spans`` wraps the Renderer instance's ``frame_setup``, ``march`` and
``phase2`` (the body of ``render_device``, which the window still drives):
a host clock around the set-up, CUDA events around the march and around
phase 2, and the host's own activity (set-up, enqueueing, waiting,
read-back) for labelling the device's idle gaps.  ``Keep`` is the one hook
an untraced run installs, on the frames the check keeps, to hold the
raybuffer that ``render`` does not return.

The device's times come from these events, not from ``torch.profiler``: on
the H100 the profiler's trace holds few of the kernels that run inside the
march graph's conditional nodes (terrain2048: 0.091 s busy of a 1.003 s
stretch that the events read about 98 % busy).
"""
from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class Trace:
    """What a traced window recorded; the per-layer readers
    (``voxbench/metrics/<name>.py``) take their numbers from it."""

    frames: int = 0
    window_s: float = 0.0
    setup_host_s: list = dataclasses.field(default_factory=list)
    march_ms: list = dataclasses.field(default_factory=list)
    phase2_ms: list = dataclasses.field(default_factory=list)
    busy_ms: list = dataclasses.field(default_factory=list)
    iterations: int | None = None
    # the bytes phase 2 needs in each frame the check kept
    phase2_bytes: list = dataclasses.field(default_factory=list)


class Keep:
    """Holds the raybuffer of the frame ``render`` makes while installed on a
    Renderer: ``render`` returns only the screen, and takes it from
    ``render_device``, which returns the raybuffer beside it."""

    def __init__(self, r):
        self.r, self.raybuf = r, None

    def __enter__(self):
        inner = self.r.render_device

        def render_device(cam):
            out = inner(cam)
            self.raybuf = out[1]
            return out

        self._had = "render_device" in vars(self.r)
        self._inner = inner
        self.r.render_device = render_device
        return self

    def __exit__(self, *exc):
        if self._had:
            self.r.render_device = self._inner
        else:
            del self.r.render_device


class Spans:
    """Instruments one Renderer instance for a traced window."""

    def __init__(self, r):
        import torch

        self.r = r
        self.host = []  # (label, t0, t1) on the host clock
        self.events = []  # a frame's (march start, march end, p2 start, p2 end)
        self._cur = {}
        self.window_t0 = 0.0
        self._ev = lambda: torch.cuda.Event(enable_timing=True)
        cls = type(r)

        def frame_setup(cam, *a, **k):
            t0 = time.perf_counter()
            f = cls.frame_setup(r, cam, *a, **k)
            self.host.append(("frame_setup", t0, time.perf_counter()))
            return f

        def march(f, *a, **k):
            t0 = time.perf_counter()
            e0, e1 = self._ev(), self._ev()
            e0.record()
            rb = cls.march(r, f, *a, **k)
            e1.record()
            self._cur = {"march": (e0, e1)}
            self.host.append(("march", t0, time.perf_counter()))
            return rb

        def phase2(f, rb):
            t0 = time.perf_counter()
            e2, e3 = self._ev(), self._ev()
            e2.record()
            out = cls.phase2(r, f, rb)
            e3.record()
            self.events.append((*self._cur.pop("march"), e2, e3))
            self.host.append(("phase2", t0, time.perf_counter()))
            return out

        r.frame_setup, r.march, r.phase2 = frame_setup, march, phase2

    def mark(self, label: str, t0: float, t1: float) -> None:
        self.host.append((label, t0, t1))

    def anchor(self):
        """An event on the device at a known host time: call after a sync,
        before the window."""
        import torch

        self._ref = self._ev()
        self._ref.record()
        torch.cuda.synchronize()
        self._ref_host = time.perf_counter()

    def device_s(self, ev) -> float:
        """An event's time on the host clock (seconds)."""
        return self._ref_host + self._ref.elapsed_time(ev) / 1e3

    def remove(self) -> None:
        for name in ("frame_setup", "march", "phase2"):
            vars(self.r).pop(name, None)

    def fill(self, t: Trace, first: int) -> None:
        """The window's spans into ``t``, from frame ``first`` (a frame's
        index in ``events``) on; the device must be synced."""
        ev = self.events[first:]
        t.march_ms = [a.elapsed_time(b) for a, b, _, _ in ev]
        t.phase2_ms = [c.elapsed_time(d) for _, _, c, d in ev]
        t.busy_ms = [a.elapsed_time(d) for a, _, _, d in ev]
        t.setup_host_s = [t1 - t0 for lab, t0, t1 in self.host
                          if lab == "frame_setup" and t0 >= self.window_t0]

    def device_ops(self, first: int) -> list:
        """The device's seconds in each layer over the window, by events:
        [[layer, seconds], ...], the larger first."""
        ev = self.events[first:]
        ops = [["march graph (Renderer.march: roll, rasterizer, gate, loop "
                "control)", sum(a.elapsed_time(b) for a, b, _, _ in ev) / 1e3],
               ["phase 2 (Renderer.phase2: reproject_screen)",
                sum(c.elapsed_time(d) for _, _, c, d in ev) / 1e3]]
        return sorted(ops, key=lambda kv: -kv[1])

    def idle_gaps(self, first: int, top: int = 10) -> list:
        """The device's idle time between frames, summed by what the host
        was doing over most of each gap: [[activity, seconds], ...]."""
        ev = self.events[first:]
        spans = [(self.device_s(a), self.device_s(d)) for a, _, _, d in ev]
        host = sorted(self.host, key=lambda s: s[1])
        by = {}
        for (_, end), (start, _) in zip(spans, spans[1:]):
            if start <= end:
                continue
            cover = {}
            for lab, h0, h1 in host:
                if h1 <= end or h0 >= start:
                    continue
                cover[lab] = cover.get(lab, 0.0) + min(h1, start) - max(h0, end)
            lab = max(cover, key=cover.get) if cover else "other"
            if cover.get(lab, 0.0) < 0.5 * (start - end):
                lab = "other"
            by[f"host {lab}"] = by.get(f"host {lab}", 0.0) + (start - end)
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:top]
