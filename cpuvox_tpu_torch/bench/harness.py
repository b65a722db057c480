"""Flythrough timing harness (``cpuvox_tpu/bench/harness.py``) on a CUDA card.

Renders frames evenly spaced along the benchmark path and reports the JAX
harness's metric names: ``fps``, ``frame_ms_p50`` and ``ray_columns_per_sec``.
A frame's time is the host clock around ``render_device`` up to a
``torch.cuda.synchronize()``; the device span of the same frame, from CUDA
events, is reported beside it (``frame_gpu_ms_p50``).  The march checks ray
liveness once per chunk on the host, so frames cannot be pipelined: ``fps``
is the sequential pass only.  Each frame's debug-magenta pixels (unwritten
texels; always a bug) are counted after its timing.  There is no CPU
fallback: a renderer that is not on a CUDA device is refused.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from cpuvox_tpu_torch.render.raymarch import MAGENTA_I32
from cpuvox_tpu_torch.shared import bench_path

# bench.py's default scene, as bench.py:165-168 builds it
TERRAIN = dict(dims=(2048, 256, 2048), seed=1234, shell_depth=9, lod_levels=6)
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".bench_cache")


def terrain2048(log=lambda *a: print(*a, file=sys.stderr)):
    """The terrain2048 LOD chain, cached in .bench_cache/terrain2048.world."""
    from cpuvox_tpu_torch.shared import procedural, save

    cache = os.path.join(CACHE_DIR, "terrain2048.world")
    t0 = time.perf_counter()
    if os.path.exists(cache):
        lods = save.load_world(cache)
        log(f"[world] loaded {cache} in {time.perf_counter() - t0:.1f} s")
        return lods
    lods = procedural.heightmap_world(**TERRAIN)
    log(f"[world] built terrain2048 ({lods[0].voxel_count} LOD0 voxels) in "
        f"{time.perf_counter() - t0:.1f} s (numpy, host)")
    os.makedirs(CACHE_DIR, exist_ok=True)
    save.save_world(cache, lods)
    return lods


def run_flythrough(renderer, n_frames: int = 24,
                   log=lambda *a: print(*a, file=sys.stderr)):
    """Render n_frames along the benchmark path; returns the metrics dict."""
    if renderer.device.type != "cuda":
        raise RuntimeError("run_flythrough times a CUDA device; the renderer "
                           f"is on {renderer.device}")
    dims = renderer.device_world.dims
    w, h = renderer.config.width, renderer.config.height
    ts = np.linspace(0.0, bench_path.BENCH_CLIP_LENGTH, n_frames)

    # warmup: kernel build and first launches; both iteration directions
    # appear along the path
    for t in (0.0, bench_path.BENCH_CLIP_LENGTH * 0.6):
        t0 = time.perf_counter()
        renderer.render_device(bench_path.benchmark_camera(t, dims, (w, h)))
        torch.cuda.synchronize()
        log(f"warmup t={t:.2f}: {time.perf_counter() - t0:.2f}s")

    ray_columns = magenta = 0
    frame_s, gpu_ms = [], []
    for t in ts:
        cam = bench_path.benchmark_camera(float(t), dims, (w, h))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        f0 = time.perf_counter()
        start.record()
        screen, _rb, (segs, *_rest) = renderer.render_device(cam)
        end.record()
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - f0)
        gpu_ms.append(start.elapsed_time(end))
        ray_columns += sum(s.ray_count for s in segs)
        magenta += int((screen == MAGENTA_I32).sum())
    total = float(np.sum(frame_s))
    return {
        "fps": n_frames / total,
        "frame_ms_mean": float(np.mean(frame_s)) * 1e3,
        "frame_ms_p50": float(np.median(frame_s)) * 1e3,
        "frame_ms_max": float(np.max(frame_s)) * 1e3,
        "frame_gpu_ms_p50": float(np.median(gpu_ms)),
        "ray_columns_per_sec": ray_columns / total,
        "n_frames": n_frames,
        "magenta_pixels": magenta,
        "resolution": [w, h],
        "world_dims": list(dims),
        "world_voxels": int(renderer.device_world.colors.shape[0] - 1),
        "world_voxels_lod0": int(renderer.device_world.lod0_voxels),
        "device": torch.cuda.get_device_name(renderer.device),
    }
