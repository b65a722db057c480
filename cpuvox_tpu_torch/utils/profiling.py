"""The program's recorder of spans and counters, and frame-phase scopes.

The reference brackets every frame phase with Unity Profiler samples
(RenderManager.cs:119-190, SURVEY.md §5 "Tracing / profiling").  Here one
recorder a process, ``PROFILER``, records where the work happens, always
on and cheap:

- a frame is one ``Renderer.render_device`` call (``frame``), numbered in
  order; its host spans (``span``: name, start, end, parent, on
  ``time.perf_counter_ns``) are the set-up's ``frame_setup`` with
  ``geometry``, ``tables`` and ``rays`` (and ``staging_wait`` inside it),
  then the ``march`` and ``phase2`` enqueues.  The last ``RING_FRAMES``
  frames are kept, the oldest dropped; a span outside a frame is not
  recorded;
- process spans (``process_span``), kept apart from the frames: the
  Renderer's ``world_pack`` and ``world_upload``, each march-graph
  ``graph_capture`` with the numbers its capture took;
- device timers: a Renderer's frame graph (``render/march_graph.py``)
  times its roll, rasterizer and control kernels inside the graph on the
  frames ``device_row`` samples (one in ``SAMPLE_PERIOD``,
  ``csrc/timer.cuh``) and copies its timer buffer, in stream order, into
  the frame's row of a ring on the device.  Nothing is read from the
  device until ``summary`` or ``export_chrome_trace`` asks, as
  ``raymarch.MarchStats`` reads its sums.  A sampled frame's graph time,
  from the first control kernel's start to the last one's end, splits
  into four (``device_split``): ``roll`` and ``rasterizer``, their
  launches' spans; ``gate_glue``, the gaps after a roll or a rasterizer
  launch (the gated march's gate and rewind kernels, ``ops/gate_kernel``,
  and the node latencies); ``march_control``, the
  control kernel's launches and the gaps after them (the WHILE node's
  turn to the next iteration, the packs between stages).  The counters
  are the live rays before each iteration and the slots the iteration
  marched.

``summary(n)`` gives the means a frame over the last ``n`` frames, and
the counts that higher layers register (``register_counts``; the gated
march's, ``raymarch.gated_stats``) as they stand;
``export_chrome_trace`` writes frames, process spans and the sampled
device spans, put on the host's clock, as one Chrome trace.  Setting the
module's ``ENABLED`` to False records nothing from the next frame on.

``FrameProfiler`` keeps named scopes' totals for a report: on a CUDA
device it times each scope on the card, by a pair of ``torch.cuda.Event``
recorded on its stream around the scope, resolved when ``report`` is
called (one synchronize for all of them); made for the CPU, or for no
device, it times scopes by the host clock.  The device is the caller's
choice, never detected.  Each scope is also a span of the recorder.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import time
from collections import defaultdict

import torch

ENABLED = True  # False: the recorder records nothing
RING_FRAMES = 16384  # frames kept: a 20-s window at several hundred fps
PROCESS_SPANS = 4096  # process spans kept
# a frame in this many has its march graph timed: on an H100 at 1080p a
# timed frame's graph takes 0.16 ms (0.8 %) longer on terrain2048, 0.11 ms
# (0.3 %) on layered2048, an untimed one no longer (PERF.md §6)
SAMPLE_PERIOD = 4

# csrc/timer.cuh's buffer: its kernels in order, and its words
KERNELS = ("roll", "rasterizer", "march_control")
SAMPLED, LAST_END, LAST_KIND, FIRST_START, PENDING = range(5)
SPAN = PENDING + 4
LAUNCHES = SPAN + len(KERNELS)
GAP = LAUNCHES + len(KERNELS)
LIVE = GAP + len(KERNELS) ** 2
SLOTS = LIVE + 1
TIMER_WORDS = SLOTS + 1


# name -> counts (a ``raymarch.MarchStats``: ``dict(stats)`` reads them) that
# ``Recorder.summary`` reports
COUNTS: dict = {}


def register_counts(name: str, stats) -> None:
    """Report ``stats`` (``dict(stats)`` gives its counts) under ``name`` in
    every ``Recorder.summary``."""
    COUNTS[name] = stats


def timer_init(device) -> torch.Tensor:
    """(2, TIMER_WORDS) int64 on ``device``: a timer buffer as an unsampled
    frame (row 0) and a sampled one (row 1) starts."""
    t = torch.zeros((2, TIMER_WORDS), dtype=torch.int64)
    t[:, PENDING:SPAN:2] = -1  # all ones: no pending launch
    t[1, SAMPLED] = 1
    return t.to(device)


def device_split(row) -> dict:
    """A sampled frame's timer words (a list) as ns: the four parts of its
    graph time and the whole (``timed``)."""
    k = len(KERNELS)
    after = [sum(row[GAP + k * a:GAP + k * (a + 1)]) for a in range(k)]
    return {"roll": row[SPAN], "rasterizer": row[SPAN + 1],
            "gate_glue": after[0] + after[1],
            "march_control": row[SPAN + 2] + after[2],
            "timed": row[LAST_END] - row[FIRST_START]}


class Frame:
    """One recorded frame: its number, host start and end (ns), its spans
    ([name, start, end, parent]: the index of the enclosing span, -1 for
    the frame) and, if sampled, its ring row ((device, slot)) and the
    offset from the card's clock to the host's."""

    __slots__ = ("seq", "t0", "t1", "spans", "row", "clock_offset")

    def __init__(self, seq: int, t0: int):
        self.seq, self.t0, self.t1 = seq, t0, t0
        self.spans: list = []
        self.row = None
        self.clock_offset = 0


class Recorder:
    """Frames with their host spans and device rows, and process spans."""

    def __init__(self, frames: int = RING_FRAMES,
                 process: int = PROCESS_SPANS):
        self.capacity = frames
        self.frames: collections.deque = collections.deque(maxlen=frames)
        self.process: collections.deque = collections.deque(maxlen=process)
        self.seq = 0  # the next frame's number
        self._frame: Frame | None = None
        self._open: list[int] = []  # the frame's open spans
        self._rings: dict = {}  # device -> (frames, TIMER_WORDS) int64

    @property
    def in_frame(self) -> bool:
        return self._frame is not None

    @contextlib.contextmanager
    def frame(self):
        """A frame around the body; inside another frame, part of it."""
        if not ENABLED or self._frame is not None:
            yield self._frame
            return
        f = self._frame = Frame(self.seq, time.perf_counter_ns())
        self.seq += 1
        self._open = []
        try:
            yield f
        finally:
            f.t1 = time.perf_counter_ns()
            self._frame = None
            self.frames.append(f)

    @contextlib.contextmanager
    def span(self, name: str):
        """A host span of the open frame, inside the innermost open one."""
        f = self._frame
        if f is None:
            yield
            return
        i = len(f.spans)
        s = [name, time.perf_counter_ns(), 0, self._open[-1] if self._open
             else -1]
        f.spans.append(s)
        self._open.append(i)
        try:
            yield
        finally:
            s[2] = time.perf_counter_ns()
            self._open.pop()

    @contextlib.contextmanager
    def process_span(self, name: str):
        """A process span; yields a dict of numbers to keep with it."""
        args: dict = {}
        if not ENABLED:
            yield args
            return
        t0 = time.perf_counter_ns()
        try:
            yield args
        finally:
            self.process.append((name, t0, time.perf_counter_ns(), args))

    def device_row(self, device, clock_offset_ns: int):
        """The open frame's row ((TIMER_WORDS,) int64) of the device ring,
        for its timer buffer, if the frame is sampled (one a frame, on one
        device); else None."""
        f = self._frame
        if f is None or f.row is not None or f.seq % SAMPLE_PERIOD:
            return None
        device = torch.device(device)
        ring = self._rings.get(device)
        if ring is None:
            ring = self._rings[device] = torch.zeros(
                (self.capacity, TIMER_WORDS), dtype=torch.int64, device=device)
        f.row = (device, f.seq % self.capacity)
        f.clock_offset = int(clock_offset_ns)
        return ring[f.row[1]]

    def last(self, n: int) -> list:
        """The last ``n`` frames, or None if fewer were kept (or n < 1)."""
        if n < 1 or n > len(self.frames):
            return None
        return list(itertools.islice(self.frames, len(self.frames) - n, None))

    def rows(self, frames) -> list:
        """(frame, its timer words as a list) for the sampled ``frames``:
        one read of each device's ring, after a sync."""
        by_dev = defaultdict(list)
        for f in frames:
            if f.row is not None:
                by_dev[f.row[0]].append(f)
        out = []
        for dev, fs in by_dev.items():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            idx = torch.tensor([f.row[1] for f in fs], device=dev)
            out += zip(fs, self._rings[dev].index_select(0, idx).tolist())
        return sorted(out, key=lambda fr: fr[0].seq)

    def summary(self, last_n_frames: int) -> dict | None:
        """The means a frame over the last ``last_n_frames`` frames, or None
        if fewer were kept: ``host_ms`` (each span's time summed in a frame,
        and the whole ``frame``, over every frame), and over the sampled
        frames ``device_ms`` (``device_split``), ``gaps_ms`` (by kernel
        pair, "roll>rasterizer"), ``launches`` (by kernel) and the
        counters ``live_rays`` and ``slots``; and under its name each set
        of ``register_counts``, as it stands: its counts run since their
        own last reset, not over the last ``last_n_frames`` frames, and
        reading a device count syncs (``gated``: the gated march's
        iterations, rewinds, the gate kernel's launches and steps past its
        tile budget, the rewind kernel's launches)."""
        frames = self.last(int(last_n_frames))
        if frames is None:
            return None
        n = len(frames)
        host = defaultdict(int)
        for f in frames:
            host["frame"] += f.t1 - f.t0
            for name, t0, t1, _parent in f.spans:
                host[name] += t1 - t0
        rows = [r for _f, r in self.rows(frames)]
        out = {"frames": n, "sampled": len(rows),
               "host_ms": {k: v / n / 1e6 for k, v in host.items()},
               "device_ms": {}, "gaps_ms": {}, "launches": {},
               **{k: dict(v) for k, v in COUNTS.items()}}
        if not rows:
            return out
        m = len(rows)
        dev = defaultdict(int)
        for r in rows:
            for k, v in device_split(r).items():
                dev[k] += v
        out["device_ms"] = {k: v / m / 1e6 for k, v in dev.items()}
        k = len(KERNELS)
        for a, b in itertools.product(range(k), range(k)):
            out["gaps_ms"][f"{KERNELS[a]}>{KERNELS[b]}"] = sum(
                r[GAP + k * a + b] for r in rows) / m / 1e6
        for a in range(k):
            out["launches"][KERNELS[a]] = sum(r[LAUNCHES + a]
                                              for r in rows) / m
        out["live_rays"] = sum(r[LIVE] for r in rows) / m
        out["slots"] = sum(r[SLOTS] for r in rows) / m
        return out

    def process_totals(self) -> dict:
        """Each process span's seconds, summed over the kept ones."""
        out = defaultdict(float)
        for name, t0, t1, _args in self.process:
            out[name] += (t1 - t0) / 1e9
        return dict(out)

    def export_chrome_trace(self, path: str, since_seq: int = 0,
                            since_ns: int = 0) -> str:
        """The frames from ``since_seq`` on and the process spans from
        ``since_ns`` on, as a Chrome trace (chrome://tracing, Perfetto) at
        ``path``: host spans on one track, process spans on another, and
        each sampled frame's march graph, put on the host's clock, on a
        third with its split (ms) and counters."""
        pid = os.getpid()
        events = []

        def add(name, tid, t0, t1, args=None):
            ev = {"name": name, "ph": "X", "pid": pid, "tid": tid,
                  "ts": t0 / 1e3, "dur": (t1 - t0) / 1e3}
            if args:
                ev["args"] = args
            events.append(ev)

        for name, t0, t1, args in self.process:
            if t0 >= since_ns:
                add(name, "process", t0, t1, args)
        frames = [f for f in self.frames if f.seq >= since_seq]
        for f in frames:
            add(f"frame {f.seq}", "host", f.t0, f.t1)
            for name, t0, t1, _parent in f.spans:
                add(name, "host", t0, t1)
        for f, r in self.rows(frames):
            args = {f"{k}_ms": v / 1e6 for k, v in device_split(r).items()}
            args.update(live_rays=r[LIVE], slots=r[SLOTS], **{
                f"{k}_launches": r[LAUNCHES + a]
                for a, k in enumerate(KERNELS)})
            add(f"march graph, frame {f.seq}", "device (sampled)",
                r[FIRST_START] + f.clock_offset, r[LAST_END] + f.clock_offset,
                args)
        with open(path, "w") as fh:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, fh)
        return path


PROFILER = Recorder()


class FrameProfiler:
    def __init__(self, device=None):
        self.device = torch.device("cpu" if device is None else device)
        self.totals = defaultdict(float)  # seconds
        self.counts = defaultdict(int)
        self._pending: list = []  # (name, start event, end event)
        self._trace = None

    @contextlib.contextmanager
    def scope(self, name: str):
        rec = PROFILER
        with rec.span(name) if rec.in_frame else rec.process_span(name):
            if self.device.type == "cuda":
                stream = torch.cuda.current_stream(self.device)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record(stream)
                try:
                    yield
                finally:
                    end.record(stream)
                    self._pending.append((name, start, end))
                    self.counts[name] += 1
                return
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.totals[name] += time.perf_counter() - t0
                self.counts[name] += 1

    def _resolve(self):
        """Add the recorded event pairs' device times to the totals."""
        if not self._pending:
            return
        torch.cuda.synchronize(self.device)
        for name, start, end in self._pending:
            self.totals[name] += start.elapsed_time(end) / 1e3
        self._pending.clear()

    def report(self) -> str:
        self._resolve()
        lines = []
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            n = self.counts[name]
            tot = self.totals[name]
            lines.append(f"{name:<28} {tot * 1e3:9.1f} ms total "
                         f"{tot / max(n, 1) * 1e3:8.2f} ms/call x{n}")
        return "\n".join(lines)

    def reset(self):
        self.totals.clear()
        self.counts.clear()
        self._pending.clear()

    def start_device_trace(self, log_dir: str):
        """Begin a trace of the recorder's frames and process spans;
        ``stop_device_trace`` writes it to ``log_dir/trace.json``
        (``Recorder.export_chrome_trace``)."""
        os.makedirs(log_dir, exist_ok=True)
        self._trace = (log_dir, PROFILER.seq, time.perf_counter_ns())

    def stop_device_trace(self) -> str:
        log_dir, seq, t0 = self._trace
        self._trace = None
        return PROFILER.export_chrome_trace(
            os.path.join(log_dir, "trace.json"), since_seq=seq, since_ns=t0)
