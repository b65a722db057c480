"""Spans around the program's layers, taken from the benchmark's side.

``Spans`` wraps the Renderer instance's ``frame_setup``, ``march`` and
``phase2`` (the body of ``render_device``, which the window still drives):
a host clock around the set-up, CUDA events around the march and around
phase 2, and the host's own activity (set-up, enqueueing, waiting,
read-back) for labelling the device's idle gaps.  ``Keep`` is the one hook
an untraced run installs, on the frames the check keeps, to hold the
raybuffer that ``render`` does not return.

``BatchSpans`` and ``KeepBatch`` do the same for a camera batch
(``render_camera_batch``), whose step is a frame of the ``Trace``: a host
clock from the call's start to its first march launch (the cameras'
``frame_geometry``, the first group's ray build), CUDA events around each
direction group's march (``Renderer.march_batch_graph``, or
``march_rays`` off the graph route) and phase 2 (``phase2_group``), and
the raybuffer blocks of the steps the check keeps.

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


class _Clock:
    """The host's spans and the anchor that puts the device's events on the
    host clock, for one Renderer instance's traced window."""

    def __init__(self, r, event=None):
        import torch

        self.r = r
        self.host = []  # (label, t0, t1) on the host clock
        self._ev = event or (lambda: torch.cuda.Event(enable_timing=True))

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

    def _idle_gaps(self, spans, top: int) -> list:
        """The device's idle time between the (start, end) host-clock
        ``spans`` of its work, summed by what the host was doing over most
        of each gap: [[activity, seconds], ...]."""
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


class Spans(_Clock):
    """Instruments one Renderer instance for a traced window."""

    def __init__(self, r):
        super().__init__(r)
        self.events = []  # a frame's (march start, march end, p2 start, p2 end)
        self._cur = {}
        self.window_t0 = 0.0
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
        return self._idle_gaps(
            [(self.device_s(a), self.device_s(d)) for a, _, _, d in ev], top)


def _override(r, name: str, make):
    """Sets the Renderer instance's ``name`` to ``make(current)`` and returns
    the callable that undoes it."""
    had = name in vars(r)
    inner = getattr(r, name)
    setattr(r, name, make(inner))

    def undo():
        if had:
            setattr(r, name, inner)
        else:
            delattr(r, name)

    return undo


class KeepBatch:
    """Holds the raybuffer blocks of the camera batch's step made while
    installed on a Renderer: ``render_camera_batch`` returns only the
    screens.  It records the cameras' frames in order (``frame_geometry``)
    and each direction group's raybuffer as ``phase2_group`` gets it, so that
    camera i's block is found by its frame, whatever group it marched in."""

    def __init__(self, r):
        self.r, self.frames, self.groups = r, [], []

    def __enter__(self):
        from voxbench import program

        def frame_geometry(inner):
            def call(cam):
                f = inner(cam)
                self.frames.append(f)
                return f
            return call

        def phase2_group(inner):
            def call(renderer, raybuf, frames, *a, **k):
                self.groups.append((raybuf, list(frames)))
                return inner(renderer, raybuf, frames, *a, **k)
            return call

        self._undo = [_override(self.r, "frame_geometry", frame_geometry),
                      program.hook_batch("phase2_group", phase2_group)]
        return self

    def __exit__(self, *exc):
        for undo in reversed(self._undo):
            undo()

    def blocks(self, n: int) -> list:
        """The ``n`` cameras' raybuffer blocks, (R1, P) each, a view of its
        group's raybuffer; None for a camera whose block never reached phase
        2."""
        R1 = self.r.ray_capacity
        where = {id(f): i for i, f in enumerate(self.frames)}
        out = [None] * n
        for raybuf, frames in self.groups:
            for j, f in enumerate(frames):
                i = where.get(id(f))
                if i is not None and i < n:
                    out[i] = raybuf[j * R1:(j + 1) * R1]
        return out


class BatchSpans(_Clock):
    """Instruments one Renderer instance's camera batch for a traced window;
    the window calls ``render`` in place of ``program.camera_batch``.
    ``event`` makes the timing events (CUDA's by default)."""

    def __init__(self, r, event=None):
        from voxbench import program

        super().__init__(r, event)
        # a step's host start, first march launch and (start, end) event
        # pairs of its groups' marches and phase 2s
        self.steps = []
        self._cur = None

        def timed(kind, label):
            def make(inner):
                def call(*a, **k):
                    t0 = time.perf_counter()
                    cur = self._cur
                    if cur is not None and kind == "march" and cur["first"] is None:
                        cur["first"] = t0
                    e0, e1 = self._ev(), self._ev()
                    e0.record()
                    out = inner(*a, **k)
                    e1.record()
                    if cur is not None:
                        cur[kind].append((e0, e1))
                    self.host.append((label, t0, time.perf_counter()))
                    return out
                return call
            return make

        self._undo = [
            _override(r, "march_batch_graph", timed("march", "march")),
            _override(r, "march_rays", timed("march", "march")),
            program.hook_batch("phase2_group", timed("phase2", "phase2"))]

    def render(self, r, cams):
        """One step through ``program.camera_batch``, its spans recorded."""
        from voxbench import program

        t0 = time.perf_counter()
        self._cur = cur = {"t0": t0, "first": None, "march": [], "phase2": []}
        screens = program.camera_batch(r, cams)
        self._cur = None
        self.steps.append(cur)
        self.host.append(("batch set-up", t0, cur["first"]))
        return screens

    def remove(self) -> None:
        for undo in reversed(self._undo):
            undo()
        self._undo = []

    def fill(self, t: Trace, first: int) -> None:
        """The window's spans into ``t``, a step a frame, from step ``first``
        (a step's index in ``steps``) on; the device must be synced.  A
        step's march and phase 2 are the sums over its direction groups,
        its busy span runs from its first march's start to its last phase
        2's end, its host set-up from the call to its first march launch."""
        steps = self.steps[first:]
        t.march_ms = [sum(a.elapsed_time(b) for a, b in s["march"])
                      for s in steps]
        t.phase2_ms = [sum(a.elapsed_time(b) for a, b in s["phase2"])
                       for s in steps]
        t.busy_ms = [s["march"][0][0].elapsed_time(s["phase2"][-1][1])
                     for s in steps]
        t.setup_host_s = [s["first"] - s["t0"] for s in steps]

    def device_ops(self, first: int) -> list:
        """The device's seconds in each layer of the batch over the window,
        by events: [[layer, seconds], ...], the larger first."""
        t = Trace()
        self.fill(t, first)
        march, p2 = sum(t.march_ms) / 1e3, sum(t.phase2_ms) / 1e3
        ops = [["batch march graphs (Renderer.march_batch_graph, a direction "
                "group each: roll, rasterizer, gate, loop control)", march],
               ["batch phase 2 (parallel/batch.py phase2_group: "
                "reproject_screens, a launch a group)", p2],
               ["inside a step between its groups (the next group's ray "
                "build, waits)", sum(t.busy_ms) / 1e3 - march - p2]]
        return sorted(ops, key=lambda kv: -kv[1])

    def idle_gaps(self, first: int, top: int = 10) -> list:
        """The device's idle time between steps, summed by what the host was
        doing over most of each gap: [[activity, seconds], ...]."""
        return self._idle_gaps(
            [(self.device_s(s["march"][0][0]), self.device_s(s["phase2"][-1][1]))
             for s in self.steps[first:]], top)
