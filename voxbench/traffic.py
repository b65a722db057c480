"""The general generators of a traffic mix, read from the mix's data file
(``voxbench/traffic/<name>.json``) and chosen by its ``path``.

``"benchmark"`` (``Flythrough``): one viewer on the upstream benchmark path
(``path.py``), sampled at ``cameras_per_pass`` evenly spaced clip times and
cycled.  The seed draws where on the pass the window starts and each
camera's jitter (uniform in +-``jitter_position`` world units on each axis,
+-``jitter_deg`` on pitch and yaw), so every seed flies the same passes over
the same world from another phase and another few voxels off the path.

``"agents"`` (``Agents``, for a camera-batch mix): ``cameras_per_step``
agents of a batched simulator, each walking over the world's surface and
rendering one camera a step (the camera batch of an RL rollout).
"""
from __future__ import annotations

import numpy as np

from voxbench import path as bench_path

# the keys of a camera-batch mix (``"entry": "render_camera_batch"``)
BATCH_KEYS = ("entry", "dispatch", "width", "height", "path",
              "cameras_per_step", "eye_height", "speed", "turn_deg",
              "pitch_deg", "check_steps", "check_cameras", "check_rays")
DISPATCH = ("waited", "ahead")
# the least |pitch| of a warm-up camera, so that its sign sets its
# iteration direction (pitch > 0 looks down: the forward direction)
WARMUP_PITCH_DEG = 1.0


def require(traffic: dict, keys) -> None:
    """Raises unless the mix has every one of ``keys``."""
    missing = [k for k in keys if k not in traffic]
    if missing:
        raise ValueError(f"traffic {traffic.get('name', '?')!r} lacks "
                         f"{', '.join(missing)}")


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


class Agents:
    """``cameras_per_step`` agents, each a camera a step (``pose`` keywords).

    Each agent starts at a position drawn from the seed in the world's inner
    80 % in x and z, with a heading drawn, and stands ``eye_height`` voxels
    above the top face of the LOD0 column under it (the floor, 0, over an
    empty column), read from the benchmark's own world.  Each step it turns
    by a yaw drawn uniform in +-``turn_deg``, walks ``speed`` voxels along
    its heading, bouncing off the edges of that region, and looks at a pitch
    drawn uniform in ``pitch_deg`` = [lo, hi] (positive looks down; a range
    across 0 gives both iteration directions in one step).  Step k's cameras
    depend only on the seed and k: the steps are made in order, each from
    the one before and its own draws.
    """

    def __init__(self, traffic: dict, lod0, seed: int):
        require(traffic, BATCH_KEYS)
        if traffic["path"] != "agents":
            raise ValueError(f"unknown path {traffic['path']!r}")
        if traffic["dispatch"] not in DISPATCH:
            raise ValueError(f"unknown dispatch {traffic['dispatch']!r}")
        self.n = int(traffic["cameras_per_step"])
        self.eye = float(traffic["eye_height"])
        self.speed = float(traffic["speed"])
        self.turn = float(traffic["turn_deg"])
        self.pitch = tuple(float(p) for p in traffic["pitch_deg"])
        if self.n < 1 or len(self.pitch) != 2 or self.pitch[0] > self.pitch[1]:
            raise ValueError(f"cameras_per_step {self.n}, pitch_deg "
                             f"{traffic['pitch_deg']}")
        X, _Y, Z = lod0.dims
        # LOD0 column (x, z) is x * Z + z; col_max is its top solid face
        self._top = np.asarray(lod0.col_max).reshape(X, Z)
        self._lo = np.array([0.1 * X, 0.1 * Z])
        self._hi = np.array([0.9 * X, 0.9 * Z])
        self._rng = np.random.default_rng([int(seed), 0])
        xz = self._rng.uniform(self._lo, self._hi, (self.n, 2))
        yaw = self._rng.uniform(-180.0, 180.0, self.n)
        self._steps = [self._with_pitch(xz, yaw)]

    def _with_pitch(self, xz, yaw):
        return xz, yaw, self._rng.uniform(*self.pitch, self.n)

    def _advance(self):
        xz, yaw, _ = self._steps[-1]
        yaw = yaw + self._rng.uniform(-self.turn, self.turn, self.n)
        rad = np.deg2rad(yaw)
        xz = xz + self.speed * np.stack([np.sin(rad), np.cos(rad)], axis=1)
        for a, flip in ((0, lambda y: -y), (1, lambda y: 180.0 - y)):
            lo, hi = self._lo[a], self._hi[a]
            out = (xz[:, a] < lo) | (xz[:, a] > hi)
            xz[:, a] = np.where(xz[:, a] < lo, 2 * lo - xz[:, a], xz[:, a])
            xz[:, a] = np.where(xz[:, a] > hi, 2 * hi - xz[:, a], xz[:, a])
            xz[:, a] = np.clip(xz[:, a], lo, hi)
            yaw = np.where(out, flip(yaw), yaw)
        yaw = (yaw + 180.0) % 360.0 - 180.0
        self._steps.append(self._with_pitch(xz, yaw))

    def _pose(self, x, z, yaw, pitch) -> dict:
        y = float(self._top[int(x), int(z)]) + self.eye
        return dict(position=(float(x), y, float(z)), pitch_deg=float(pitch),
                    yaw_deg=float(yaw), roll_deg=0.0)

    def step(self, k: int) -> list[dict]:
        """Step ``k``'s cameras, one an agent."""
        while len(self._steps) <= k:
            self._advance()
        xz, yaw, pitch = self._steps[k]
        return [self._pose(x, z, w, p)
                for (x, z), w, p in zip(xz, yaw, pitch)]

    def first_pose(self) -> dict:
        """The camera the warm-up shows first, which fixes the LOD distances:
        the same for every seed (the world's centre, heading +z, looking
        down at the steepest pitch of the range)."""
        X, Z = self._top.shape
        pitch = max(abs(self.pitch[0]), abs(self.pitch[1]), WARMUP_PITCH_DEG)
        return self._pose(X / 2, Z / 2, 0.0, pitch)

    def warmup(self, bucket_size) -> list[list[dict]]:
        """The steps set-up renders: enough splits of step 0's agents by
        iteration direction that every (direction, bucket) pair the window
        can reach is rendered, ``bucket_size(n, cap)`` giving the cameras a
        group of ``n`` is padded to.  A split's first ``plus`` agents look
        down (forward), the rest up, each at its own |pitch| (at least
        ``WARMUP_PITCH_DEG``); the first camera is ``first_pose``."""
        n = self.n
        buckets = sorted({bucket_size(k, n) for k in range(1, n + 1)})

        def pairs(plus):
            out = {(1, bucket_size(plus, n))} if plus else set()
            return out | ({(-1, bucket_size(n - plus, n))} if plus < n else set())

        need = {(d, b) for d in (1, -1) for b in buckets}
        splits = []
        for d in (1, -1):
            for b in buckets:
                if (d, b) in need:
                    plus = b if d == 1 else n - b
                    splits.append(plus)
                    need -= pairs(plus)
        base = self.step(0)
        steps = []
        for plus in splits:
            poses = []
            for i, p in enumerate(base):
                mag = max(abs(p["pitch_deg"]), WARMUP_PITCH_DEG)
                poses.append(dict(p, pitch_deg=mag if i < plus else -mag))
            steps.append(poses)
        steps[0][0] = self.first_pose()  # the first split's camera 0 looks down
        return steps
