"""The general generator of a traffic mix: a viewer's cameras along a path,
read from the mix's data file (``voxbench/traffic/<name>.json``).

The upstream benchmark path (``path.py``) is sampled at
``cameras_per_pass`` evenly spaced clip times and cycled.  The seed draws
where on the pass the window starts and each camera's jitter (uniform in
+-``jitter_position`` world units on each axis, +-``jitter_deg`` on pitch
and yaw), so every seed flies the same passes over the same world from
another phase and another few voxels off the path.
"""
from __future__ import annotations

import numpy as np

from voxbench import path as bench_path


class Flythrough:
    def __init__(self, traffic: dict, world_dims, seed: int):
        if traffic["path"] != "benchmark":
            raise ValueError(f"unknown path {traffic['path']!r}")
        n = int(traffic["cameras_per_pass"])
        clip = bench_path.BENCH_CLIP_LENGTH
        self.passes = [bench_path.benchmark_pose(clip * k / n, world_dims)
                       for k in range(n)]
        self._rng = np.random.default_rng([int(seed), 0])
        self.phase = int(self._rng.integers(n))
        self._jp = float(traffic["jitter_position"])
        self._jd = float(traffic["jitter_deg"])
        self._jitter = np.zeros((0, 5))
        self.stride = int(traffic["warmup_stride"])

    def warmup(self) -> list[dict]:
        """The poses set-up renders: every ``warmup_stride``-th camera of
        the pass, without jitter, from the pass's start (so the first, which
        fixes the LOD distances, is the same for every seed)."""
        return self.passes[::self.stride]

    def pose(self, j: int) -> dict:
        """The window's ``j``-th camera."""
        while j >= self._jitter.shape[0]:
            more = self._rng.uniform(-1.0, 1.0, (4096, 5))
            self._jitter = np.concatenate([self._jitter, more])
        base = self.passes[(self.phase + j) % len(self.passes)]
        d = self._jitter[j]
        x, y, z = base["position"]
        return dict(position=(x + self._jp * float(d[0]),
                              y + self._jp * float(d[1]),
                              z + self._jp * float(d[2])),
                    pitch_deg=base["pitch_deg"] + self._jd * float(d[3]),
                    yaw_deg=base["yaw_deg"] + self._jd * float(d[4]),
                    roll_deg=base["roll_deg"])
