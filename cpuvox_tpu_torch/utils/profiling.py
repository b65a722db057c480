"""Frame-phase profiling scopes.

The reference brackets every frame phase with Unity Profiler samples
(RenderManager.cs:119-190, SURVEY.md §5 "Tracing / profiling").  The
counterpart of ``cpuvox_tpu/utils/profiling.py``: named scopes accumulated
per phase, and ``torch.profiler`` traces for device timelines.

A profiler made for a CUDA device times each scope on the card, by a pair of
``torch.cuda.Event`` recorded on its stream around the scope, and resolves
the pairs when ``report`` is called (one synchronize for all of them), so a
scope adds no wait of its own.  Made for the CPU, or for no device, it times
scopes by the host clock.  The device is the caller's choice, never detected.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


class FrameProfiler:
    def __init__(self, device=None):
        self.device = torch.device("cpu" if device is None else device)
        self.totals = defaultdict(float)  # seconds
        self.counts = defaultdict(int)
        self._pending: list = []  # (name, start event, end event)
        self._trace = None

    @contextlib.contextmanager
    def scope(self, name: str):
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
        """Begin a ``torch.profiler`` trace of the host and, on a CUDA
        device, the card; ``stop_device_trace`` writes it to
        ``log_dir/trace.json`` (chrome://tracing, Perfetto)."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(log_dir, exist_ok=True)
        self._trace = (torch.profiler.profile(activities=acts), log_dir)
        self._trace[0].start()

    def stop_device_trace(self):
        prof, log_dir = self._trace
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
        self._trace = None
        return prof


PROFILER = FrameProfiler()
