"""Where a flythrough frame's time goes on a CUDA card.

    python -m cpuvox_tpu_torch.bench.breakdown [--scene terrain2048|layered2048]
        [--gate auto|on|off] [--frames 24] [--width 1920 --height 1080]
        [--argb] [--device-init] [--compact]

``--gate`` sets ``RenderConfig.occupancy_gate``, so that the same frames can
be timed through the occupancy-gated and the dense march; ``--argb`` sets
``argb_records`` (kernel 2 writes the inline colors, phase 2 skips the
resolve), ``--device-init`` builds the rays on the device
(``host_init=False``), and ``--compact`` marches on a live-ray index
(``Renderer.create(compact=True)``) where the default marches every ray slot
to the end.  Five passes over the same frames of the benchmark
path, on one card:

1. stages, host clock with a ``torch.cuda.synchronize()`` after each: setup
   (camera, segments, reprojection tables, ray init on the device or on the
   host with its copy to the card), the phase-1 march (chunks or gated
   iterations counted by the rasterize kernel's launches: its wrapper's
   count plus the march graph's iterations from the device counter,
   ``ops/march_loop.kernel_launches``; the rays
   rewound on the gated march, index rebuilds and mean ray slots a chunk)
   and phase 2 (reproject, resolve, upscale);
2. whole frames unprofiled, host clock: the wall time of the pass;
3. whole frames with and without live-ray compaction in turns (the order
   swaps every frame), host clock, before the profiler is ever on: each
   side's frame p50 and the pairs the compacted march wins; then whole
   frames with phase 2 through the fused kernel and through its previous
   design (``reproject_kernel.reproject_screen_two_pass``) in turns, and
   the two phase 2s alone on the same raybuffer: each side's p50;
4. the same frames under ``torch.profiler``: every device activity (kernels,
   copies, fills) with its interval on the card.  The device's busy time is
   the union of those intervals; the busy share is that over pass 2's wall
   (the profiler slows the host, so its own wall is printed but not used);
5. the phase-1 march alone under ``torch.profiler``, frame setups made
   beforehand: device activities per chunk of the dense march or per gated
   iteration (one rasterize launch a chunk or iteration; the default march
   is one graph launch a frame, ``--compact`` launches each from the host),
   and the march's device busy time over pass 1's
   march time; then phase 2 alone on those marches' raybuffers, as the
   renderer runs it and through its plain torch version: device
   activities a frame, and the fused kernel's launches as its wrapper
   counts them (profiled right after the march, the profiler can come
   back short of them).

Device time by name is summed from the same activities: each kernel counts
once (``key_averages``' "CUDA total" column counts a kernel under its aten op
too); for the port's three kernels the device time a launch is printed (the
rasterizer is the group kernel ``rasterize_visits_kernel``, which reads the
column records itself: the march runs no torch record gather and no unpack
``cumsum``; phase 2 is ``reproject_screen_kernel``).  The last line of stdout is one JSON object with every
number.
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
    from cpuvox_tpu_torch.bench.harness import SCENES

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", choices=sorted(SCENES), default="terrain2048")
    ap.add_argument("--gate", choices=("auto", "on", "off"), default="auto")
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--argb", action="store_true")
    ap.add_argument("--device-init", action="store_true")
    ap.add_argument("--compact", action="store_true")
    args = ap.parse_args(argv)
    compact = args.compact
    if not torch.cuda.is_available():
        print("breakdown: no CUDA device", file=sys.stderr)
        return 2

    from cpuvox_tpu_torch.bench import path as bench_path
    from cpuvox_tpu_torch.config import RenderConfig
    from cpuvox_tpu_torch.ops import march_loop, reproject_kernel
    from cpuvox_tpu_torch.render import raymarch
    from cpuvox_tpu_torch.render.frame import Renderer

    def rasterize_launches():  # the march graphs' iterations included
        return march_loop.kernel_launches()["rasterize_visits"]

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    renderer = Renderer.create(
        SCENES[args.scene](log=print),
        RenderConfig(width=args.width, height=args.height,
                     occupancy_gate=args.gate, argb_records=args.argb,
                     host_init=not args.device_init), device="cuda",
        compact=compact)
    print(f"{args.scene}: occupancy gate {renderer.occupancy_on}, chunk and "
          f"budget {renderer.march_params}, max_runs "
          f"{renderer.device_world.max_runs}, ARGB mode {renderer.argb_on} "
          f"(max_col_colors {renderer.device_world.max_col_colors}), "
          f"host_init {not args.device_init}, compaction {compact}",
          flush=True)
    dims = renderer.device_world.dims
    wh = (args.width, args.height)
    ts = np.linspace(0.0, bench_path.BENCH_CLIP_LENGTH, args.frames)
    cams = [bench_path.benchmark_camera(float(t), dims, wh) for t in ts]
    sync = torch.cuda.synchronize
    for cam in (cams[0], cams[len(cams) * 6 // 10]):  # build + warm both directions
        renderer.render_device(cam)
    sync()

    # 1. stages
    print("t, setup_ms, march_ms, phase2_ms, chunks, rewinds, rays, direction")
    rows = []
    stats = raymarch.gated_stats
    cstats = raymarch.compact_stats
    cstats.update(rebuilds=0, chunks=0, ray_slots=0)
    for t, cam in zip(ts, cams):
        sync()
        t0 = time.perf_counter()
        f = renderer.frame_setup(cam)
        sync()
        t1 = time.perf_counter()
        n0, w0 = rasterize_launches(), stats["rewinds"]
        rb = renderer.march(f, compact=compact)
        sync()
        t2 = time.perf_counter()
        renderer.phase2(f, rb)
        sync()
        t3 = time.perf_counter()
        row = ((t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3,
               rasterize_launches() - n0, stats["rewinds"] - w0,
               sum(s.ray_count for s in f.segs))
        rows.append(row)
        print(f"{t:.3f} " + " ".join(f"{x:.3f}" for x in row[:3])
              + f" {row[3]} {row[4]} {row[5]} {f.iteration_direction}",
              flush=True)
    med = np.median(np.array(rows, dtype=np.float64), axis=0)
    tot = np.sum(np.array(rows, dtype=np.float64), axis=0)
    rebuilds = cstats["rebuilds"] / len(cams)
    mean_rays = cstats["ray_slots"] / max(cstats["chunks"], 1)
    print(f"compaction: {rebuilds:.2f} index rebuilds a frame, mean "
          f"{mean_rays:.1f} of {renderer.ray_capacity} ray slots a chunk",
          flush=True)

    def render(cam, compact=compact):  # a whole frame, as render_device
        f = renderer.frame_setup(cam)
        return renderer.phase2(f, renderer.march(f, compact=compact))

    # 2. whole frames, unprofiled
    sync()
    frame_ms = []
    for cam in cams:
        t0 = time.perf_counter()
        render(cam)
        sync()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    wall_ms = float(np.sum(frame_ms))

    # 3. compaction on and off in turns, before the profiler is ever on
    paired = {True: [], False: []}
    for k, cam in enumerate(cams):
        for c in ((True, False) if k % 2 else (False, True)):
            sync()
            t0 = time.perf_counter()
            render(cam, compact=c)
            sync()
            paired[c].append((time.perf_counter() - t0) * 1e3)
    on, off = np.array(paired[True]), np.array(paired[False])
    print(f"compaction in turns: frame p50 {np.median(on):.3f} ms compacted, "
          f"{np.median(off):.3f} ms not; the compacted march is faster in "
          f"{int((on < off).sum())} of {len(cams)} pairs, median difference "
          f"{np.median(on - off):+.3f} ms")

    # 3b. phase 2 through the fused kernel and through its previous design
    # (the torch index map, the two-pass sample, the torch resolve), in
    # turns: whole frames, then phase 2 alone on the same raybuffer
    def previous(f, rb):
        return reproject_kernel.reproject_screen_two_pass(
            *renderer.phase2_args(f, rb))

    p2_frame = {"fused": [], "previous": []}
    p2_alone = {"fused": [], "previous": []}
    for k, cam in enumerate(cams):
        order = (("fused", renderer.phase2), ("previous", previous))
        for name, p2 in (order if k % 2 else order[::-1]):
            sync()
            t0 = time.perf_counter()
            f = renderer.frame_setup(cam)
            rb = renderer.march(f, compact=compact)
            p2(f, rb)
            sync()
            p2_frame[name].append((time.perf_counter() - t0) * 1e3)
        for name, p2 in (order if k % 2 else order[::-1]):
            t0 = time.perf_counter()
            p2(f, rb)
            sync()
            p2_alone[name].append((time.perf_counter() - t0) * 1e3)
    fu, pr = np.array(p2_frame["fused"]), np.array(p2_frame["previous"])
    p2_med = {k: float(np.median(v)) for k, v in p2_alone.items()}
    print(f"phase 2 fused and previous in turns: frame p50 {np.median(fu):.3f} "
          f"ms fused, {np.median(pr):.3f} ms previous; fused faster in "
          f"{int((fu < pr).sum())} of {len(cams)} pairs, median difference "
          f"{np.median(fu - pr):+.3f} ms; phase 2 alone p50 "
          f"{p2_med['fused']:.3f} ms fused, {p2_med['previous']:.3f} ms "
          f"previous")

    # 4. the same frames under the profiler
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for cam in cams:
            render(cam)
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
    per_launch = {}
    for short in ("roll_chunk_kernel", "rasterize_visits_kernel",
                  "reproject_screen_kernel"):
        ms, k = map(sum, zip(*([v for n, v in by_name.items() if short in n]
                               or [[0.0, 0]])))
        per_launch[short] = [ms, k, ms / k * 1e3 if k else None]
        print(f"  {short}: {ms:.3f} ms over {k} launches -> "
              f"{ms / max(k, 1) * 1e3:.2f} us on the device a launch")

    # 5. the march alone under the profiler, then phase 2 alone on its
    # raybuffers
    setups = [renderer.frame_setup(cam) for cam in cams]
    sync()
    n0 = rasterize_launches()
    with torch.profiler.profile(activities=acts) as prof:
        raybufs = [renderer.march(f, compact=compact) for f in setups]
        sync()
    iters = rasterize_launches() - n0
    march_dev = device_activities(prof)
    march_busy_ms = union_us((s, e) for _n, s, e in march_dev) / 1e3
    unit = "gated iteration" if renderer.occupancy_on else "chunk"
    print(f"march alone: {len(march_dev)} device activities over {iters} "
          f"{unit}s -> {len(march_dev) / iters:.1f} per {unit}; device busy "
          f"{march_busy_ms:.3f} ms against {tot[1]:.3f} ms of march (pass 1) "
          f"-> march busy share {march_busy_ms / tot[1]:.4f}")
    p2_acts = {}
    k0 = reproject_kernel.launches
    for label, fn in (("as the renderer runs it", renderer.phase2),
                      ("its plain torch version", lambda f, rb: (
                          reproject_kernel.reproject_screen_ref(
                              *renderer.phase2_args(f, rb))))):
        with torch.profiler.profile(activities=acts) as prof:
            for f, rb in zip(setups, raybufs):
                fn(f, rb)
            sync()
        p2_dev = device_activities(prof)
        p2_acts[label] = len(p2_dev) / len(setups)
        names = sorted({n[:50] for n, _s, _e in p2_dev})
        print(f"phase 2 alone, {label}: {len(p2_dev)} device activities "
              f"over {len(setups)} frames -> {p2_acts[label]:.1f} a frame "
              f"({len(names)} names: {', '.join(names[:4])})")
    p2_launches = reproject_kernel.launches - k0
    print(f"phase 2 alone: {p2_launches} launches of the fused kernel "
          f"counted by its wrapper over {len(setups)} frames (the profiler "
          f"can drop activities right after a profile as large as the "
          f"march's)")
    print(json.dumps({
        "card": card, "scene": args.scene, "gate": args.gate,
        "argb": renderer.argb_on, "host_init": not args.device_init,
        "paired_frame_ms_p50_compacted": float(np.median(on)),
        "paired_frame_ms_p50_uncompacted": float(np.median(off)),
        "paired_compacted_wins": int((on < off).sum()),
        "paired_frame_ms_p50_phase2_fused": float(np.median(fu)),
        "paired_frame_ms_p50_phase2_previous": float(np.median(pr)),
        "paired_phase2_fused_wins": int((fu < pr).sum()),
        "paired_phase2_ms_p50": p2_med,
        "compact": compact, "index_rebuilds_per_frame": rebuilds,
        "mean_ray_slots_per_chunk": mean_rays,
        "kernel_device_ms_launches_us": per_launch,
        "frames": args.frames,
        "resolution": list(wh), "occupancy_on": renderer.occupancy_on,
        "march_params": list(renderer.march_params),
        "median_setup_ms": med[0], "median_march_ms": med[1],
        "median_phase2_ms": med[2], "median_chunks": med[3],
        "total_setup_ms": tot[0], "total_march_ms": tot[1],
        "total_phase2_ms": tot[2], "total_chunks": tot[3],
        "median_rewinds": med[4], "total_rewinds": tot[4],
        "frame_ms_p50": float(np.median(frame_ms)), "wall_ms": wall_ms,
        "device_sum_ms": dev_sum_ms, "device_busy_ms": busy_ms,
        "busy_share": busy_ms / wall_ms, "profiled_wall_ms": prof_wall_ms,
        "march_activities_per_chunk": len(march_dev) / iters,
        "march_busy_ms": march_busy_ms,
        "march_busy_share": march_busy_ms / tot[1],
        "phase2_activities_per_frame": p2_acts,
        "phase2_fused_launches_per_frame": p2_launches / len(setups),
        "device_ms_by_name": {n[:120]: [ms, k] for n, (ms, k) in top}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
