"""Timing harness (``cpuvox_tpu/bench/harness.py`` and ``bench.py``'s
rollout, dynamic and interactive modes) on a CUDA card: the runners that
``python -m cpuvox_tpu_torch.bench`` (``bench/entry.py``) drives.

``run_flythrough`` renders frames evenly spaced along the benchmark path and
reports the JAX harness's metric names: ``fps``, ``frame_ms_p50`` and
``ray_columns_per_sec``.  ``run_rollout`` renders batches of cameras
(``parallel/batch.py``, ``bench.py:203-251``) and reports
``rollout64_cams_per_sec_256x256``; ``run_dynamic`` rebuilds and renders a
dynamic terrain a frame (``models/dynamic_demo.py``, ``bench.py:254-282``)
and reports ``fps_dynamic512_1280x720_rebuild_per_frame``.
``run_convert`` converts an .obj to a world on the card twice (the cold and
the steady-state seconds, each stage synced; ``bench.py``'s
``convert_<scene>_seconds_steady_state``), and ``run_interactive`` drives an
``InteractiveSession`` with ``bench.py:285-316``'s scripted inputs and
reports its step p50 (the entry names it
``interactive_step_ms_p50_<scene>_<W>x<H>``).
A frame's time is the host clock around ``render_device`` up to a
``torch.cuda.synchronize()``; the device span of the same frame, from CUDA
events, is reported beside it (``frame_gpu_ms_p50``).  ``run_flythrough``
then makes the JAX harness's second, pipelined pass
(``cpuvox_tpu/bench/harness.py:46-71``): it dispatches frame i and only then
waits for frame i-1, which a frame that reads nothing from the device
allows (the march graph, ``render/march_graph.py``).  ``fps`` and
``fps_seq`` are the sequential pass's, ``fps_pipe`` the pipelined one's.
Each frame's debug-magenta pixels (unwritten texels; always a bug) are
counted after the timing.  There is no CPU fallback: a renderer that is not
on a CUDA device is refused.
"""
from __future__ import annotations

import functools
import os
import sys
import time

import numpy as np
import torch

from cpuvox_tpu_torch.bench import path as bench_path
from cpuvox_tpu_torch.render.raymarch import MAGENTA_I32

# bench.py's scenes, as bench.py:145-168 builds them (its ``build_world``):
# the procedural builder and its keyword arguments.  terrain2048 is its
# default dense terrain, layered2048 its deep, mostly-empty headline scene;
# ``layered`` is layered1024 under bench.py's other cache name
SCENE_BUILDS = {
    "terrain2048": ("heightmap_world", dict(
        dims=(2048, 256, 2048), seed=1234, shell_depth=9, lod_levels=6)),
    "terrain1024": ("heightmap_world", dict(
        dims=(1024, 256, 1024), seed=1234, shell_depth=9, lod_levels=6)),
    "layered2048": ("layered_world", dict(
        dims=(2048, 512, 2048), seed=99, shell_depth=8, n_layers=13,
        lod_levels=6, footprint=0.55)),
    "layered1024": ("layered_world", dict(
        dims=(1024, 256, 1024), seed=99, shell_depth=8, n_layers=12,
        lod_levels=6)),
}
SCENE_BUILDS["layered"] = SCENE_BUILDS["layered1024"]
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
        f"{time.perf_counter() - t0:.1f} s")
    os.makedirs(CACHE_DIR, exist_ok=True)
    save.save_world(cache, lods)
    return lods


def scene_world(scene: str, log=lambda *a: print(*a, file=sys.stderr)):
    """The LOD chain of one of bench.py's procedural scenes
    (``SCENE_BUILDS``), cached in .bench_cache/<scene>.world as bench.py
    caches it."""
    from cpuvox_tpu_torch.models import procedural

    fn, kwargs = SCENE_BUILDS[scene]
    return _cached(scene, lambda: getattr(procedural, fn)(**kwargs), log)


def terrain2048(log=lambda *a: print(*a, file=sys.stderr)):
    """The terrain2048 LOD chain (dense: the occupancy gate stays off)."""
    return scene_world("terrain2048", log)


def layered2048(log=lambda *a: print(*a, file=sys.stderr)):
    """The layered2048 LOD chain: deep RLE and most LOD0 columns empty, so
    the occupancy gate resolves on."""
    return scene_world("layered2048", log)


SCENES = {s: functools.partial(scene_world, s) for s in SCENE_BUILDS}


def run_flythrough(renderer, n_frames: int = 24,
                   log=lambda *a: print(*a, file=sys.stderr),
                   keep_screens: bool = False):
    """Render n_frames along the benchmark path, sequentially (a sync after
    each frame), then pipelined (frame i dispatched before frame i-1 is
    waited for); returns the metrics dict, and with ``keep_screens`` each
    pass's screens (device tensors) under ``screens_seq`` and
    ``screens_pipe``."""
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

    cams = [bench_path.benchmark_camera(float(t), dims, (w, h)) for t in ts]
    ray_columns = 0
    frame_s, gpu_ms, screens = [], [], []
    for cam in cams:
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
        screens.append(screen)
    total = float(np.sum(frame_s))

    # the pipelined pass: dispatch frame i, then wait for frame i-1; a
    # frame's time is the span from one wait's end to the next
    pipe = []
    torch.cuda.synchronize()
    t_pipe = time.perf_counter()
    done = [t_pipe]
    previous = None
    for cam in cams:
        screen, _rb, _geometry = renderer.render_device(cam)
        ready = torch.cuda.Event()
        ready.record()
        pipe.append(screen)
        if previous is not None:
            previous.synchronize()
            done.append(time.perf_counter())
        previous = ready
    previous.synchronize()
    done.append(time.perf_counter())
    total_pipe = done[-1] - t_pipe
    magenta = sum(int((s == MAGENTA_I32).sum()) for s in screens + pipe)
    out = {
        "fps": n_frames / total,
        "fps_seq": n_frames / total,
        "fps_pipe": n_frames / total_pipe,
        "frame_ms_p50_pipe": float(np.median(np.diff(done[1:]))) * 1e3,
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
    if keep_screens:
        out.update(screens_seq=screens, screens_pipe=pipe)
    return out


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


def rollout_renderer(wh=(256, 256), device="cuda", compact: bool | None = None,
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
    from cpuvox_tpu_torch.ops import march_loop

    return march_loop.kernel_launches()


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
                    exact_lod1: bool = False, compact: bool | None = None):
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


def town_obj(log=lambda *a: print(*a, file=sys.stderr)) -> str:
    """The procedural town's .obj (``bench/meshes.py``, seed 0), written to
    .bench_cache/town.obj."""
    from cpuvox_tpu_torch.bench import meshes

    os.makedirs(CACHE_DIR, exist_ok=True)
    path = os.path.join(CACHE_DIR, "town.obj")
    counts = meshes.write_town_obj(path, seed=0)
    log(f"[town] {path}: {counts}")
    return path


def run_convert(obj_path: str, max_dim: int = 2048, lod_levels: int = 6,
                device="cuda", log=lambda *a: print(*a, file=sys.stderr)):
    """Convert ``obj_path`` to a world on the card twice, each stage synced
    (``assets/pipeline.py``): the first conversion pays the process's first
    launches (cold), the second is the steady state (``bench.py``'s
    ``convert_*_seconds_steady_state``).  Returns the metrics and the
    second conversion's LODs."""
    from cpuvox_tpu_torch.assets import voxelizer
    from cpuvox_tpu_torch.assets.pipeline import convert_obj_to_world

    if torch.device(device).type != "cuda":
        raise RuntimeError(f"run_convert times a CUDA device, not {device}")
    runs = []
    for label in ("cold", "steady"):
        timings: dict = {}
        calls = voxelizer.device_calls
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lods = convert_obj_to_world(obj_path, max_dimension=max_dim,
                                    lod_levels=lod_levels, device=device,
                                    timings=timings)
        total = time.perf_counter() - t0
        if voxelizer.device_calls != calls + 1:
            raise AssertionError("the conversion did not run the device "
                                 "voxelizer")
        runs.append((total, timings))
        log(f"[convert] {label}: {total:.3f} s; " + ", ".join(
            f"{k} {v:.3f}" for k, v in timings.items()))
    w0 = lods[0]
    steady, st = runs[1]
    name = os.path.splitext(os.path.basename(obj_path))[0]
    return {
        f"convert_{name}{max_dim}_seconds_steady_state": steady,
        "seconds_cold": runs[0][0], "seconds_steady": steady,
        "stages_cold": runs[0][1], "stages_steady": st,
        "dims": list(w0.dims), "lod0_voxels": w0.voxel_count,
        "voxels_per_sec": w0.voxel_count / steady,
        "max_runs": int(w0.col_runs.max()) if w0.n_cols else 0,
        "empty_frac": float((w0.col_runs == 0).mean()),
        "device": torch.cuda.get_device_name(device),
    }, lods


# bench.py:302-309: two warmup steps (the second flips the pitch, so both
# iteration directions are warm), then 24 steps of forward flight while
# turning, the pitch rocking every 4 steps
WARMUP_INPUTS = [dict(forward=0.0), dict(mouse_dy=40.0)]


def interactive_inputs(n_steps: int = 24) -> list[dict]:
    """The scripted inputs of the timed steps, at 1/30 s a step."""
    return [dict(forward=1.0, mouse_dx=6.0,
                 mouse_dy=2.0 if i % 8 < 4 else -2.0) for i in range(n_steps)]


def interactive_sessions(lods, whs, device="cuda"):
    """An ``InteractiveSession`` a resolution over one device world, each at
    the reference's spawn camera."""
    import dataclasses

    from cpuvox_tpu_torch.config import RenderConfig
    from cpuvox_tpu_torch.frontend.interactive import InteractiveSession
    from cpuvox_tpu_torch.render.frame import Renderer

    r = Renderer.create(lods, RenderConfig(width=whs[0][0],
                                           height=whs[0][1]), device=device)
    return [InteractiveSession.create(None, renderer=dataclasses.replace(
        r, config=dataclasses.replace(r.config, width=w, height=h),
        lod_distances=None)) for w, h in whs]


def run_interactive(lods, whs=((320, 180), (1920, 1080)), n_steps: int = 24,
                    sessions=None, log=lambda *a: print(*a, file=sys.stderr)):
    """``bench.py:285-316``: an ``InteractiveSession`` a resolution, two
    warmup steps, then ``n_steps`` scripted steps, each waiting for its
    frame as a user at the screen does; the step's render time
    (``frame_times``) p50 in ms, as ``bench.py`` takes it (the sorted
    times' element ``n // 2``), and the kernels' launches a step."""
    if sessions is None:
        sessions = interactive_sessions(lods, whs)
    out = {}
    for (w, h), s in zip(whs, sessions):
        _require_cuda(s.renderer, "run_interactive")
        t0 = time.perf_counter()
        for kw in WARMUP_INPUTS:
            s.step(1 / 30, **kw)
        log(f"[interactive] {w}x{h} warmup {time.perf_counter() - t0:.2f}s")
        s.frame_times.clear()
        before = _launch_counts()
        magenta = 0
        for kw in interactive_inputs(n_steps):
            magenta += int((s.step(1 / 30, **kw) == np.uint32(
                MAGENTA_I32 & 0xFFFFFFFF)).sum())
        after = _launch_counts()
        lat = sorted(s.frame_times)
        p50 = lat[len(lat) // 2] * 1e3
        out[f"{w}x{h}"] = {
            "step_ms_p50": p50, "step_ms_min": lat[0] * 1e3,
            "step_ms_max": lat[-1] * 1e3,
            "step_ms_mean": sum(lat) / len(lat) * 1e3,
            "fps": len(lat) / sum(lat),
            "n_steps": n_steps, "magenta_pixels": magenta,
            "gate": s.renderer.occupancy_on,
            "launches_per_step": {k: (after[k] - before[k]) / n_steps
                                  for k in after},
            "device": torch.cuda.get_device_name(s.renderer.device)}
    return out
