"""Timing harness (``cpuvox_tpu/bench/harness.py`` and ``bench.py``'s
rollout and dynamic modes) on a CUDA card.

    python -m cpuvox_tpu_torch.bench.harness rollout [--compact]
    python -m cpuvox_tpu_torch.bench.harness dynamic [--exact-lod1]

``run_flythrough`` renders frames evenly spaced along the benchmark path and
reports the JAX harness's metric names: ``fps``, ``frame_ms_p50`` and
``ray_columns_per_sec``.  ``run_rollout`` renders batches of cameras
(``parallel/batch.py``, ``bench.py:203-251``) and reports
``rollout64_cams_per_sec_256x256``; ``run_dynamic`` rebuilds and renders a
dynamic terrain a frame (``models/dynamic_demo.py``, ``bench.py:254-282``)
and reports ``fps_dynamic512_1280x720_rebuild_per_frame``.
A frame's time is the host clock around ``render_device`` up to a
``torch.cuda.synchronize()``; the device span of the same frame, from CUDA
events, is reported beside it (``frame_gpu_ms_p50``).  The march checks ray
liveness once per chunk on the host, so frames cannot be pipelined: ``fps``
is the sequential pass only.  Each frame's debug-magenta pixels (unwritten
texels; always a bug) are counted after its timing.  There is no CPU
fallback: a renderer that is not on a CUDA device is refused.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from cpuvox_tpu_torch.bench import path as bench_path
from cpuvox_tpu_torch.render.raymarch import MAGENTA_I32

# bench.py's scenes, as bench.py:145-168 builds them: its default dense
# terrain, and its deep, mostly-empty headline scene
TERRAIN = dict(dims=(2048, 256, 2048), seed=1234, shell_depth=9, lod_levels=6)
LAYERED = dict(dims=(2048, 512, 2048), seed=99, shell_depth=8, n_layers=13,
               lod_levels=6, footprint=0.55)
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".bench_cache")


def _cached(name, build, log):
    """The LOD chain ``build()`` makes, cached in .bench_cache/<name>.world."""
    from cpuvox_tpu_torch.world import save

    cache = os.path.join(CACHE_DIR, f"{name}.world")
    t0 = time.perf_counter()
    if os.path.exists(cache):
        lods = save.load_world(cache)
        log(f"[world] loaded {cache} in {time.perf_counter() - t0:.1f} s")
        return lods
    lods = build()
    log(f"[world] built {name} ({lods[0].voxel_count} LOD0 voxels) in "
        f"{time.perf_counter() - t0:.1f} s (numpy, host)")
    os.makedirs(CACHE_DIR, exist_ok=True)
    save.save_world(cache, lods)
    return lods


def terrain2048(log=lambda *a: print(*a, file=sys.stderr)):
    """The terrain2048 LOD chain (dense: the occupancy gate stays off)."""
    from cpuvox_tpu_torch.models import procedural

    return _cached("terrain2048",
                   lambda: procedural.heightmap_world(**TERRAIN), log)


def layered2048(log=lambda *a: print(*a, file=sys.stderr)):
    """The layered2048 LOD chain: deep RLE and most LOD0 columns empty, so
    the occupancy gate resolves on."""
    from cpuvox_tpu_torch.models import procedural

    return _cached("layered2048",
                   lambda: procedural.layered_world(**LAYERED), log)


SCENES = {"terrain2048": terrain2048, "layered2048": layered2048}


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


# bench.py:217: the rollout's world (a heightmap, dense march, max_runs 3)
ROLLOUT = dict(dims=(512, 128, 512), seed=7, shell_depth=6)


def rollout_cameras(step: int, n_cams: int = 64, wh=(256, 256),
                    dims=ROLLOUT["dims"]):
    """``bench.py:219-234``'s cameras of one rollout step: around the world,
    every other one looking up (pitch -20..-5), the rest down (5..60)."""
    from cpuvox_tpu_torch.render import camera as cm

    out = []
    rng = np.random.default_rng(1000 + step)
    for i in range(n_cams):
        ang = 360.0 * i / n_cams + step * 7.0
        pitch = float(rng.uniform(5, 60)) if i % 2 else float(
            rng.uniform(-20, -5))
        out.append(cm.Camera(
            position=(dims[0] * (0.2 + 0.6 * rng.random()),
                      dims[1] * (0.4 + 0.4 * rng.random()),
                      dims[2] * (0.2 + 0.6 * rng.random())),
            pitch_deg=pitch, yaw_deg=ang, screen=wh))
    return out


def rollout_renderer(wh=(256, 256), device="cuda", compact: bool = False,
                     **config):
    """A Renderer over the rollout's world at ``wh`` (``bench.py:217-219``)."""
    from cpuvox_tpu_torch.config import RenderConfig
    from cpuvox_tpu_torch.models import procedural
    from cpuvox_tpu_torch.render.frame import Renderer

    lods = procedural.heightmap_world(**ROLLOUT)
    return Renderer.create(lods, RenderConfig(width=wh[0], height=wh[1],
                                              **config),
                           device=device, compact=compact)


def _require_cuda(renderer, what):
    if renderer.device.type != "cuda":
        raise RuntimeError(f"{what} times a CUDA device; the renderer is on "
                           f"{renderer.device}")


def _launch_counts():
    from cpuvox_tpu_torch.ops import phase1_kernel, reproject_kernel, roll_kernel

    return {"roll_chunk": roll_kernel.launches,
            "rasterize_visits": phase1_kernel.launches,
            "reproject_screen": reproject_kernel.launches,
            "reproject_screens": reproject_kernel.screens_launches}


def run_rollout(renderer, n_cams: int = 64, n_steps: int = 4,
                log=lambda *a: print(*a, file=sys.stderr)):
    """``n_steps`` rollout steps of ``n_cams`` cameras after a warmup step,
    synced once at the end (``bench.py:236-251``); returns the metrics."""
    from cpuvox_tpu_torch.parallel.batch import render_camera_batch

    _require_cuda(renderer, "run_rollout")
    wh = (renderer.config.width, renderer.config.height)
    dims = renderer.device_world.dims
    t0 = time.perf_counter()
    render_camera_batch(renderer, rollout_cameras(0, n_cams, wh, dims))
    torch.cuda.synchronize()
    log(f"rollout warmup {time.perf_counter() - t0:.2f}s")
    cams = [rollout_cameras(s + 1, n_cams, wh, dims) for s in range(n_steps)]
    before = _launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    screens = [render_camera_batch(renderer, c) for c in cams]
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    after = _launch_counts()
    cps = n_cams * n_steps / total
    magenta = sum(int((s == MAGENTA_I32).sum()) for s in screens)
    return {
        f"rollout{n_cams}_cams_per_sec_{wh[0]}x{wh[1]}": cps,
        "cams_per_sec": cps, "step_ms_mean": total / n_steps * 1e3,
        "n_cams": n_cams, "n_steps": n_steps, "magenta_pixels": magenta,
        "launches_per_step": {k: (after[k] - before[k]) / n_steps
                              for k in after},
        "device": torch.cuda.get_device_name(renderer.device),
    }


def dynamic_camera(dims, wh=(1280, 720)):
    """``bench.py:265-266``'s camera over the dynamic terrain."""
    from cpuvox_tpu_torch.render import camera as cm

    return cm.Camera(position=(dims[0] * 0.5, dims[1] * 0.9, dims[2] * 0.22),
                     pitch_deg=22.0, yaw_deg=15.0, screen=wh)


def dynamic_terrain(size: int = 512, wh=(1280, 720), device="cuda",
                    exact_lod1: bool = False, compact: bool = False):
    """``bench.py:262-263``'s DynamicTerrain (512 x 128 x 512, depth 6)."""
    from cpuvox_tpu_torch.config import RenderConfig
    from cpuvox_tpu_torch.models.dynamic_demo import DynamicTerrain

    return DynamicTerrain.create(
        dims=(size, 128, size), config=RenderConfig(width=wh[0], height=wh[1]),
        device=device, exact_lod1=exact_lod1, compact=compact)


def run_dynamic(terrain, n_frames: int = 12,
                log=lambda *a: print(*a, file=sys.stderr)):
    """A warmup frame, then ``n_frames`` frames each rebuilding the world
    from the animated heights and rendering it, synced once at the end
    (``bench.py:267-282``): ``fps``.  Then the same frames again with a sync
    after the rebuild and after the render, for each one's median ms."""
    _require_cuda(terrain.renderer, "run_dynamic")
    r = terrain.renderer
    wh = (r.config.width, r.config.height)
    dims = terrain.spec.dims
    cam = dynamic_camera(dims, wh)
    t0 = time.perf_counter()
    terrain.render_frame(0.0, cam)
    torch.cuda.synchronize()
    log(f"dynamic warmup {time.perf_counter() - t0:.2f}s")
    before = _launch_counts()
    t0 = time.perf_counter()
    screens = [terrain.render_frame(0.1 * (i + 1), cam)
               for i in range(n_frames)]
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    after = _launch_counts()
    magenta = sum(int((s == MAGENTA_I32).sum()) for s in screens)
    rebuild_s, render_s = [], []
    for i in range(n_frames):
        t0 = time.perf_counter()
        terrain.rebuild(0.1 * (i + 1))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        r.render_device(cam)
        torch.cuda.synchronize()
        rebuild_s.append(t1 - t0)
        render_s.append(time.perf_counter() - t1)
    fps = n_frames / total
    return {
        f"fps_dynamic{dims[0]}_{wh[0]}x{wh[1]}_rebuild_per_frame": fps,
        "fps": fps, "n_frames": n_frames,
        "frame_ms_mean": total / n_frames * 1e3,
        "rebuild_ms_p50": float(np.median(rebuild_s)) * 1e3,
        "render_ms_p50": float(np.median(render_s)) * 1e3,
        "exact_lod1": terrain.spec.exact_lod1,
        "max_runs": r._wa.max_runs, "magenta_pixels": magenta,
        "launches_per_frame": {k: (after[k] - before[k]) / n_frames
                               for k in after},
        "device": torch.cuda.get_device_name(r.device),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=["rollout", "dynamic"])
    ap.add_argument("--compact", action="store_true",
                    help="march on a live-ray index")
    ap.add_argument("--exact-lod1", action="store_true",
                    help="dynamic: the voxel-exact LOD1 (max_runs 9)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("harness: no CUDA device", file=sys.stderr)
        return 2
    if args.mode == "rollout":
        m = run_rollout(rollout_renderer(compact=args.compact))
    else:
        m = run_dynamic(dynamic_terrain(exact_lod1=args.exact_lod1,
                                        compact=args.compact))
    print(json.dumps(m))
    return 0


if __name__ == "__main__":
    sys.exit(main())
