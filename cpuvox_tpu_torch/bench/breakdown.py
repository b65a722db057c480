"""Where a terrain2048 flythrough frame's time goes on a CUDA card.

    python -m cpuvox_tpu_torch.bench.breakdown [--frames 24] [--width 1920 --height 1080]

Three passes over the same frames of the benchmark path, on one card:

1. stages, host clock with a ``torch.cuda.synchronize()`` after each: host
   setup (camera, segments, reprojection tables, host ray init and its copy
   to the card), the phase-1 march (chunks counted by the rasterize kernel's
   launch counter) and phase 2 (reproject, resolve, upscale);
2. whole frames unprofiled, host clock: the wall time of the pass;
3. the same frames under ``torch.profiler``: every device activity (kernels,
   copies, fills) with its interval on the card.  The device's busy time is
   the union of those intervals; the busy share is that over pass 2's wall
   (the profiler slows the host, so its own wall is printed but not used).

Device time by name is summed from the same activities: each kernel counts
once (``key_averages``' "CUDA total" column counts a kernel under its aten op
too).  The last line of stdout is one JSON object with every number.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch


def union_us(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def device_activities(prof):
    """(name, start_us, end_us) of every activity the profiler saw on the card."""
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("breakdown: no CUDA device", file=sys.stderr)
        return 2

    from cpuvox_tpu_torch.bench.harness import terrain2048
    from cpuvox_tpu_torch.ops import phase1_kernel
    from cpuvox_tpu_torch.render.frame import Renderer
    from cpuvox_tpu_torch.shared import RenderConfig, bench_path

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    renderer = Renderer.create(
        terrain2048(log=print), RenderConfig(width=args.width, height=args.height),
        device="cuda")
    dims = renderer.device_world.dims
    wh = (args.width, args.height)
    ts = np.linspace(0.0, bench_path.BENCH_CLIP_LENGTH, args.frames)
    cams = [bench_path.benchmark_camera(float(t), dims, wh) for t in ts]
    sync = torch.cuda.synchronize
    for cam in (cams[0], cams[len(cams) * 6 // 10]):  # build + warm both directions
        renderer.render_device(cam)
    sync()

    # 1. stages
    print("t, setup_ms, march_ms, phase2_ms, chunks, rays, direction")
    rows = []
    for t, cam in zip(ts, cams):
        sync()
        t0 = time.perf_counter()
        f = renderer.frame_setup(cam)
        sync()
        t1 = time.perf_counter()
        n0 = phase1_kernel.launches
        rb = renderer.march(f)
        sync()
        t2 = time.perf_counter()
        renderer.phase2(f, rb)
        sync()
        t3 = time.perf_counter()
        row = ((t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3,
               phase1_kernel.launches - n0, sum(s.ray_count for s in f.segs))
        rows.append(row)
        print(f"{t:.3f} " + " ".join(f"{x:.3f}" for x in row[:3])
              + f" {row[3]} {row[4]} {f.iteration_direction}", flush=True)
    med = np.median(np.array(rows, dtype=np.float64), axis=0)

    # 2. whole frames, unprofiled
    sync()
    frame_ms = []
    for cam in cams:
        t0 = time.perf_counter()
        renderer.render_device(cam)
        sync()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    wall_ms = float(np.sum(frame_ms))

    # 3. the same frames under the profiler
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for cam in cams:
            renderer.render_device(cam)
        sync()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    dev = device_activities(prof)
    if not dev:
        raise RuntimeError("the profiler recorded no device activity")
    busy_ms = union_us((s, e) for _n, s, e in dev) / 1e3
    by_name = defaultdict(lambda: [0.0, 0])
    for n, s, e in dev:
        by_name[n][0] += (e - s) / 1e3
        by_name[n][1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    dev_sum_ms = sum(v[0] for v in by_name.values())
    print(f"device activity over {args.frames} frames: sum {dev_sum_ms:.3f} ms, "
          f"busy (union) {busy_ms:.3f} ms; unprofiled wall {wall_ms:.3f} ms -> "
          f"busy share {busy_ms / wall_ms:.4f}; profiled wall {prof_wall_ms:.3f} ms")
    for n, (ms, k) in top:
        print(f"  {ms:10.3f} ms {ms / dev_sum_ms:7.2%} {k:6d}x  {n[:90]}")
    print(json.dumps({
        "card": card, "frames": args.frames, "resolution": list(wh),
        "median_setup_ms": med[0], "median_march_ms": med[1],
        "median_phase2_ms": med[2], "median_chunks": med[3],
        "frame_ms_p50": float(np.median(frame_ms)), "wall_ms": wall_ms,
        "device_sum_ms": dev_sum_ms, "device_busy_ms": busy_ms,
        "busy_share": busy_ms / wall_ms, "profiled_wall_ms": prof_wall_ms,
        "device_ms_by_name": {n[:120]: [ms, k] for n, (ms, k) in top}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
