"""Drive the PyTorch port's main paths on one CUDA card and check every kernel.

Run from the repository root, on a machine with an NVIDIA H100 (sm_90a) and
``nvcc``:

    python3 chip_smoke.py

(``python3 chip_smoke.py --shard-only`` builds the kernels and the two 2048
worlds and runs phase 12 alone: the multi-device renderer over the shards
of card 0 and, with more than one card, over the cards.)

Phases; each prints its own lines, and any mismatch or exception exits
non-zero (no phase catches its own failure):

1. device: requires CUDA, prints the card's name and power limit, and holds
   the card's f32 ``/`` and ``sqrt`` against numpy's on a million values;
2. build: compiles the kernel sources (``cpuvox_tpu_torch/csrc/*.cu``, one
   ``nvcc`` each, all at once) and prints each kernel's registers and
   spills (``cuobjdump -res-usage``); meanwhile the roll's previous design
   (``bench/roll_variants.PREVIOUS_DESIGN``) builds beside it;
3. terrain2048, the dense march (``bench.py``'s default scene, built as
   ``bench.py`` builds it and cached in ``.bench_cache/``): device ray init
   against host init on the card (every field and lane, six cameras) with
   the setup time both ways; each kernel against its plain torch version on
   the card, bit-exact (tolerance 0, f32 compared as bits): the roll on an
   adversarial state and on a 1080p frame's mid-march state, the rasterizer
   on one chunk of that frame (raybuffer and the 8 state fields: the group
   kernel on the roll's visits, and the previous one-thread-a-ray kernel on
   the cells torch fetches, each against the plain version), both with the
   live-ray index the march holds there (under half the ray slots) and at
   full width; phase 2 on that frame: the fused kernel, and the previous
   two-pass sample on the frame's reprojection maps, each against its
   plain version, and the fused kernel on the same view rendered at scale
   0.5 and upscaled; then a 64^3
   random world at 160x120 against the numpy oracle; one 320x180 frame
   through the kernels, the plain path, the kernels without compaction and
   the kernels with device ray init (bit-equal, and each variant's phase 2
   through the fused kernel against its plain version); the 1920x1080
   flythrough (24 frames) with launch counts, index rebuilds and mean rays
   a chunk, a magenta check, fps and frame p50, no torch column fetch, no
   torch phase-2 index map and one phase-2 launch a frame on the way;
4. terrain2048 in ARGB mode (``argb_records=True``, with
   ``host_init=False``: device ray init): the records' shape and
   ``max_col_colors``; both rasterizers with MCC 13 on a 1080p chunk
   against their plain version, phase 2 as in 3; one 320x180 frame three
   ways (ARGB kernels, ARGB plain, index-mode kernels: equal screens); the
   1920x1080 flythrough (24 frames) with 0 magenta; the same frames
   through both modes in turns
   (each mode's frame p50), and three of them against index mode's screen;
5. the split record layout: a small world of about 128 runs a column, both
   rasterizers at that MAXR against their plain version, one frame against
   the plain path and its phase 2 through the fused kernel;
6. layered2048, the occupancy-gated march (``bench.py``'s deep, mostly
   empty headline scene; its world built and cached in a child process
   while phases 3-5 run): (a) the device world, whose gate must resolve on,
   and device against host init at its dims; (b) the roll at chunk 128 and
   both rasterizers on a packed group of 16 gated cells at MAXR 29, mid-march,
   with the live-ray index and at full width, against their plain versions,
   in both iteration directions; (c) one 320x180 frame five ways, equal
   raybuffers and screens: gated kernels, gated plain versions, dense
   kernels, gated kernels without compaction, gated kernels with device ray
   init; (d) the 1920x1080 flythrough
   (24 frames) with 0 magenta, every kernel launched and busy rays rewound;
   (e) phase 2 on a 1080p frame;
7. each kernel's time against its plain version, its bound and, where
   PyTorch calls compute the same function, their time, at each path's
   shapes: per call by CUDA events around one Python call, and the
   device's own time a launch (calls queued back to back behind a wait);
   beside each, its previous design on the same inputs (the roll's
   previous constants, the one-thread-a-ray rasterizer and the torch
   column fetch that fed it, the two-pass sample and the torch phase 2
   around it);
8. more LOD distances than the roll kernel holds in registers (after 3):
   the kernel's memory form at 9 distances against the plain roll, rays up
   to LOD 8, and a 320x180 terrain2048 frame at ``lod_levels`` 9 through
   the kernels and the plain path, its rays past LOD 7;
9. the camera-batch rollout (``parallel/batch.py``, ``bench.py:203-251``'s
   world and 64-camera steps at 256x256, both iteration directions): one
   step through the kernels == through the plain versions == each
   camera's single-camera frame; 8 cameras in ARGB mode and 8 on a gated
   256x128x256 layered world against their single frames; the batched
   phase-2 kernel and a launch of the single-camera kernel a camera, each
   against the plain phase 2 camera by camera, timed side by side; cams/s
   with compaction off and on in turns, launches a step, a step's device
   busy share;
10. the dynamic worlds (``world/dynamic.py``, ``bench.py:254-282``): the
   512x128x512 surface world rebuilt on the card == the same build on the
   CPU, every field, with ``exact_lod1`` off and on; a 1280x720 frame
   through the kernels == the plain path; 12 timed frames (fps, the
   rebuild's and the render's ms) for each setting; an editable 64^3 world
   after three ``set_voxel_column`` edits and a chain snapshot, card == CPU
   word for word, its frames through the kernels == plain;
11. the mesh path (``assets/``, ``world/rle_device.py``,
   ``frontend/interactive.py``) on the procedural town (``bench/meshes.py``;
   the reference's mill.obj is not in the repository): (a) voxio built with
   g++, the town parsed natively == by the python parser, every array; (b)
   the whole conversion on the card at ``max_dimension`` 512, 6 LODs ==
   the numpy pipeline in every field of every LOD, and the card's chain
   with ``cascade=False`` too; (c) the conversion at 2048 twice, cold (the
   mesh path's first conversion in the process, made before (b)) and
   steady, each stage synced (``bench/harness.run_convert``), through the
   device voxelizer (counted), ``rle.validate_world`` on every LOD (in a
   child process while the card goes on), the card's soup of a seeded
   eighth of the triangles == ``voxelize_mesh`` of it, the LOD0 voxels,
   max_runs and empty_frac; (d) a solid white 256^3 block at
   ``lod_levels`` 9, every LOD all white (LOD 8's channel sums pass 2^31);
   (e) ``InteractiveSession`` over the 2048 world (gate on) at 320x180 and
   1920x1080 with ``bench.py:302-309``'s inputs: the first 2 steps and the
   first step through the kernels == a plain session's, render modes 2
   and 3 == plain, 0 magenta, then the timed steps (step p50, launches a
   step); (f) the same 1080p steps replayed twice from the same state: each
   stage synced (controllers, frame setup, march, phase 2, frame copy),
   then under ``torch.profiler`` (the device busy share), and
   ``FrameProfiler`` with CUDA events around 8 more steps at each size;
12. the multi-device renderer (``parallel/``) over 4 shards of the card
   (``["cuda:0"] * 4``), on the worlds phases 3 and 6 built: (a)
   terrain2048 and (b) layered2048 at 1920x1080 through ``ShardedRenderer``
   (LOD0 striped in tiles of 256 columns; the dense and the gated march),
   three path cameras at the default LOD0 radius and at a radius of 300
   (a window of 5 x 5 of the 8 x 8 tiles), screens == the unsharded
   Renderer's, the window, the exchanges and their bytes; (f) on each, the
   rasterizer on a chunk of the active window against its plain version;
   (c) ``render_frame_sharded`` on both worlds == the unsharded frame,
   launches a frame, frame ms sharded and unsharded in turns; (d) the
   composed mode, one frame on each; (e) the rollout's 64 cameras at
   256x256 camera-sharded == the unsharded batch, cams/s both ways in
   turns.  In one more run of (a), (b), (c), (d) and (e) each, the four
   kernels are held against their plain versions on the same inputs, at
   the shapes the sharded path gives them (a shard's slice of the rays,
   the gathered raybuffer, a camera block): every phase-2 call, and each
   shard's first roll and rasterizer call at full width and on a live-ray
   index.  With more than one card,
   (a), (c) and (e) again over the real cards;
13. the benchmark entry, ``python -m cpuvox_tpu_torch.bench``, a process
   a mode (``BENCH_RUNS``): terrain2048 at 1920x1080 over 8 frames and
   layered2048 at 320x180, each through its verify gate (one path camera
   through the kernels and the plain versions, screens and raybuffers
   equal), then rollout64, dynamic512 and convert_town2048; each must exit
   0 and print only JSON lines, ``bench.py``'s metric names, no ``verify``
   key, 0 magenta pixels and the card's line, and in a flythrough record
   both ``fps_seq`` and ``fps_pipe``; each record is printed.

[loop], at the end of phases 3, 4 and 6: the default Renderer's march, one
launch of the march graph (``render/march_graph.py``: a WHILE conditional
node whose condition the loop-control kernel, ``csrc/march_loop.cu``,
sets), on terrain2048 in index and ARGB mode (dense) and layered2048
(gated), at 1920x1080.  First (phase 3) the loop-control kernel against its
plain version at the frame's ray count, timed.  Then for each variant: (a)
on path cameras in both iteration directions the graph march == the
host-driven march with the kernels on the same rays, raybuffer and screen,
and at 320x180 a frame == the plain versions in the direction that phase
3's, 4's or 6's small frame (whose "no compaction" variant is the graph
march) did not hold; (b) a warm ``render_device`` under
``torch.cuda.set_sync_debug_mode("error")``; (c) the device counter's
iterations == the host loop's chunks or gated iterations on each camera;
(d) the 24-frame flythrough, sequential and pipelined (frame i dispatched
before frame i-1 is waited for), its launch counts set to 0 just before it
and read just after: the pipelined screens == the sequential ones, 0
magenta, one graph launch a frame, the roll, the rasterizer and the control
kernel launched once an iteration by the graph (and the control kernel once
more a frame), and a raybuffer ``render_device`` returned unchanged after
the next frame; (e) frame p50 sequential and pipelined, the device span,
the pipelined pass's device busy share under ``torch.profiler`` and, from
CUDA events, the card's time a frame after its setup against the
pipelined pass's wall, and each variant's capture and instantiation ms and
the private pool's bytes.

The three flythrough Renderers are created with ``compact=True`` (the march
on a live-ray index, driven from the host; the Renderer's default is the
full-width march graph, which [loop], the oracle check, the split-layout
frame, the dynamic worlds, the mesh path's sessions and a variant of each
small frame run).  Each flythrough makes the harness's sequential and
pipelined passes.  Kernel launch counts are set to 0 just before each
flythrough, [loop]'s, the rollout's first timed run, the dynamic terrain's (``exact_lod1`` off)
timed run, the mesh path's 1080p interactive run (two warmup steps and
24 timed) and each sharded run of phase 12 (summed as the ``shard`` path),
and read just after each; launches made to compare or time a kernel are
not counted; a march graph's launches are counted on the device
(``ops/march_loop.kernel_launches``).  The last lines are the card line,
one JSON line of kernels (``launches_by_path`` per path; the batched phase
2, ``reproject_screens``, and the loop-control kernel, ``march_loop``, have
their own entries), and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import atexit
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

MAIN_WH = (1920, 1080)
SMALL_WH = (320, 180)
N_FRAMES = 24
KERNELS = [  # name, source, the TPU kernel it replaces
    ("roll_chunk", "cpuvox_tpu_torch/csrc/roll.cu",
     "cpuvox_tpu/ops/roll_kernel.py:146"),
    ("rasterize_visits", "cpuvox_tpu_torch/csrc/rasterize.cu",
     "cpuvox_tpu/ops/phase1_kernel.py:715"),
    ("reproject_screen", "cpuvox_tpu_torch/csrc/reproject.cu",
     "cpuvox_tpu/ops/reproject_kernel.py:64"),
]
# the march loop's control: no Pallas kernel computes it on the TPU, the
# jitted while_loop's condition does
LOOP_KERNEL = ("march_loop", "cpuvox_tpu_torch/csrc/march_loop.cu",
               "cpuvox_tpu/render/raymarch.py:928")
LOOP_PATHS = ("terrain2048", "terrain2048 ARGB", "layered2048")
# the fused phase-2 kernel's f32 and integer operations: a segment's score
# at a pixel (two correctly rounded divisions, counted as one each), and
# then a pixel's ray index, sample address and resolve
PHASE2_OPS_PER_SEGMENT = 20
PHASE2_OPS_PER_PIXEL = 20
# NVIDIA H100 SXM, published: HBM3 bandwidth and f32 rate outside the tensor
# cores (the kernels do integer and f32 scalar work)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """``nvidia-smi``'s name and power limit, one card's to a ``; ``."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return "; ".join(r.stdout.strip().splitlines())


# ------------------------------------------------------------- comparison


def _bits(t):
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t.to(torch.int32)


def compare(name: str, got, want, stats: dict) -> None:
    """Bit-exact comparison of tensor sequences; records the mismatch count
    and the largest absolute difference in ``stats[name]`` and raises on any
    mismatch."""
    mism, err = 0, 0.0
    for g, w in zip(got, want, strict=True):
        d = _bits(g) != _bits(w)
        n = int(d.sum())
        if n:
            mism += n
            diff = (g[d].double() - w[d].double()).abs()
            err = max(err, float(torch.nan_to_num(diff, nan=np.inf).max()))
    s = stats.setdefault(name, {"mismatches": 0, "max_abs_err": 0.0})
    s["mismatches"] += mism
    s["max_abs_err"] = max(s["max_abs_err"], err)
    if mism:
        raise AssertionError(f"{name}: {mism} elements differ from the plain "
                             f"version (max abs err {err})")


def roll_both(dda, alive, *rest, index=None):
    """The roll kernel and its plain version on copies of the same state."""
    from cpuvox_tpu_torch.bench.capture import clone
    from cpuvox_tpu_torch.ops import roll_kernel

    got = roll_kernel.roll_chunk(clone(dda), alive.clone(), *rest,
                                 index=index)
    want = roll_kernel.roll_chunk_ref(clone(dda), alive.clone(), *rest,
                                      index=index)
    return [*got[0], got[1], got[2]], [*want[0], want[1], want[2]]


def roll_both_cap(cap, dims):
    """``roll_both`` on a capture, with its live-ray index."""
    return roll_both(cap.dda, cap.alive, cap.frame.static.dirs,
                     cap.lod_distances, cap.far, dims, cap.chunk,
                     index=cap.index)


def raster_both(cap, stats: dict):
    """The group rasterizer on the capture's cells (visits or a packed
    group) and the previous design on the same cells fetched by torch, each
    against the plain version on copies of the captured state; returns (the
    plain result, texels it wrote)."""
    from cpuvox_tpu_torch.bench.capture import clone
    from cpuvox_tpu_torch.ops import phase1_kernel

    args = (cap.frame.static, cap.consts, cap.frame.iteration_direction)
    want = phase1_kernel.rasterize_visits_ref(clone(cap.rs), cap.wa, cap.src,
                                              *args, index=cap.index)
    got = phase1_kernel.rasterize_visits(clone(cap.rs), cap.wa, cap.src,
                                         *args, index=cap.index)
    compare("rasterize_visits", got, want, stats)
    old = phase1_kernel.rasterize_chunk(clone(cap.rs), cap.cells, *args,
                                        index=cap.index)
    compare("rasterize_chunk", old, want, stats)
    return want, int((want.raybuf >= 0).sum() - (cap.rs.raybuf >= 0).sum())


def capture_compacted(renderer, cam, k: int):
    """A capture after at least ``k`` iterations that holds a live-ray index
    of at most half the ray slots: deeper into the frame until it does."""
    from cpuvox_tpu_torch.bench.capture import capture

    R = renderer.ray_capacity
    for depth in (k, 2 * k, 4 * k):
        cap = capture(renderer, cam, k=depth)
        if cap.index is not None and 2 * cap.index.shape[0] <= R:
            return cap, depth
    raise AssertionError(f"no live-ray index under half of {R} ray slots "
                         f"within {depth} iterations")


def rays_of(cap) -> str:
    """How many ray slots a capture's kernels work on."""
    R = cap.dda.pos.shape[0]
    if cap.index is None:
        return f"all {R} ray slots"
    return f"a live-ray index of {rays_worked(cap)} of {R} ray slots"


# ------------------------------------------------------------- scenes


def random_world_64(seed=5, n=6000):
    """A 64^3 random voxel soup (tests/scenes.py::random_world at 64^3) with
    a 6-level LOD chain."""
    from cpuvox_tpu_torch.world import rle

    dims = (64, 64, 64)
    rng = np.random.default_rng(seed)
    x = rng.integers(0, dims[0], n)
    y = rng.integers(0, dims[1], n)
    z = rng.integers(0, dims[2], n)
    rgb = tuple(rng.integers(0, 256, n).astype(np.uint8) for _ in range(3))
    w0 = rle.build_lod_from_voxels(dims, 0, x * dims[2] + z, y, rgb)
    return rle.build_lod_chain(w0, 6)


def adversarial_roll_state(device, R=256, seed=3):
    """Axis-parallel rays (inf tdelta), out-of-bounds positions, dead lanes,
    mixed LODs (tests/test_pallas_kernel.py:351-392)."""
    from cpuvox_tpu_torch.render import raymarch as rm

    rng = np.random.default_rng(seed)
    pos = rng.integers(-4, 60, size=(R, 2)).astype(np.int32)
    dirs = rng.normal(size=(R, 2)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True).astype(np.float32)
    dirs[:8, 0] = 0.0
    with np.errstate(divide="ignore"):
        tdelta = np.abs(1.0 / dirs).astype(np.float32)
    tmax = (rng.random((R, 2)).astype(np.float32) * tdelta).astype(np.float32)
    tmax = np.where(np.isfinite(tmax), tmax, np.float32(1e30)).astype(np.float32)
    dda = rm.DDAState(
        pos=pos, tmax=tmax, tdelta=tdelta,
        stp=np.where(dirs >= 0, 1, -1).astype(np.int32),
        ids=np.sort(rng.random((R, 2)).astype(np.float32) * 3.0, axis=1),
        lod=rng.integers(0, 3, size=R).astype(np.int32))

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return (rm.DDAState(*(put(x) for x in dda)), put(rng.random(R) < 0.9),
            put(dirs), put(np.array([2., 5., 9., 14., 20., 27.], np.float32)),
            40.0, (64, 16, 64), 16)


def path_camera(renderer, t, wh=None):
    """The benchmark path's camera at ``t`` of its clip length."""
    from cpuvox_tpu_torch.bench import path as bench_path

    return bench_path.benchmark_camera(t * bench_path.BENCH_CLIP_LENGTH,
                                       renderer.device_world.dims,
                                       wh or renderer.render_wh)


# ------------------------------------------------------------- phases


def check_card_arithmetic(device) -> None:
    """The card's f32 ``/`` and ``sqrt`` against numpy's on a million values
    each: the device ray init relies on both being correctly rounded."""
    rng = np.random.default_rng(7)
    a = (rng.random(1 << 20, dtype=np.float32) * np.float32(4096.0)
         + np.float32(1e-3))
    b = rng.random(1 << 20, dtype=np.float32) + np.float32(1e-3)
    ta, tb = torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)
    off_div = int(((ta / tb).cpu().numpy().view(np.int32)
                   != (a / b).view(np.int32)).sum())
    off_sqrt = int((torch.sqrt(ta).cpu().numpy().view(np.int32)
                    != np.sqrt(a).view(np.int32)).sum())
    if off_div or off_sqrt:
        raise AssertionError(f"the card's f32 arithmetic differs from "
                             f"numpy's: / in {off_div}, sqrt in {off_sqrt} "
                             f"of {a.size} values")
    log(f"[device] f32 / and sqrt on the card == numpy's on {a.size} values "
        "each (0 differ): no soft divide or square root is needed")


def init_cameras(renderer):
    """The cameras the reference's device-init check uses: four along the
    path, one outside the world, one looking up."""
    from cpuvox_tpu_torch.render import camera as cm

    dims, wh = renderer.device_world.dims, renderer.render_wh
    cams = [path_camera(renderer, t) for t in (0.1, 0.35, 0.9, 0.95)]
    cams.append(cm.Camera(position=(-50.0, dims[1] * 0.6, -80.0),
                          pitch_deg=10.0, yaw_deg=30.0, screen=wh))
    cams.append(cm.Camera(position=(dims[0] / 2, dims[1] * 0.8, dims[2] / 2),
                          pitch_deg=-25.0, yaw_deg=200.0, screen=wh))
    return cams


def check_device_init(renderer, scene: str, card: str) -> dict:
    """Device ray init against host init on the card, every field and lane,
    and a frame setup's time both ways (host clock, synchronised)."""
    host_r = dataclasses.replace(renderer, config=dataclasses.replace(
        renderer.config, host_init=True))
    dev_r = dataclasses.replace(renderer, config=dataclasses.replace(
        renderer.config, host_init=False))
    cams = init_cameras(renderer)
    for i, cam in enumerate(cams):
        fh, fd = host_r.frame_setup(cam), dev_r.frame_setup(cam)
        got = [*fd.static, *fd.dda, fd.alive0]
        want = [*fh.static, *fh.dda, fh.alive0]
        for g, w in zip(got, want, strict=True):
            if g.shape != w.shape or g.dtype != w.dtype:
                raise AssertionError(f"[{scene}] camera {i}: device init "
                                     f"gives {g.shape} {g.dtype}, host init "
                                     f"{w.shape} {w.dtype}")
        compare(f"device_init_{scene}_{i}", got, want, {})
    # a frame setup's time both ways, camera by camera in turns (host,
    # device, device, host), five rounds, the median of each camera's ten
    times = {"host": [[] for _ in cams], "device": [[] for _ in cams]}
    for _ in range(5):
        for label, r in (("host", host_r), ("device", dev_r),
                         ("device", dev_r), ("host", host_r)):
            for i, cam in enumerate(cams):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r.frame_setup(cam)
                torch.cuda.synchronize()
                times[label][i].append((time.perf_counter() - t0) * 1e3)
    med = {k: [float(np.median(t)) for t in v] for k, v in times.items()}
    inside = [0, 1, 2, 3, 5]  # the path's cameras and the one looking up
    ms = {k: {"inside": float(np.mean([v[i] for i in inside])),
              "outside": v[4]} for k, v in med.items()}
    R = renderer.ray_capacity
    log(f"[{scene}] device ray init == host init on the card: {len(cams)} "
        f"cameras (4 on the path, 1 outside, 1 looking up) at "
        f"{renderer.render_wh[0]}x{renderer.render_wh[1]}, 12 fields and "
        f"alive, all {R} lanes, 0 differ; a frame's setup, cameras inside "
        f"the world: {ms['host']['inside']:.3f} ms with host init, "
        f"{ms['device']['inside']:.3f} ms with device init; the camera "
        f"outside: {ms['host']['outside']:.3f} ms and "
        f"{ms['device']['outside']:.3f} ms ({card})")
    return ms


def check_argb_frames(argb, index, card: str, n: int = 3) -> None:
    """``n`` path frames at full size: the ARGB renderer's screen against
    the index-mode renderer's.  Then the flythrough's frames through both
    renderers in turns (the order swaps every frame): each mode's frame and
    phase-2 time."""
    from cpuvox_tpu_torch.bench import path as bench_path
    from cpuvox_tpu_torch.render.raymarch import MAGENTA_I32

    def timed(r, cam):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f = r.frame_setup(cam)
        rb = r.march(f)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        r.phase2(f, rb)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return (t2 - t0) * 1e3, (t2 - t1) * 1e3

    rows = {"argb": [], "index": []}
    for k, t in enumerate(np.linspace(0.0, bench_path.BENCH_CLIP_LENGTH,
                                      N_FRAMES)):
        cam = bench_path.benchmark_camera(float(t), argb.device_world.dims,
                                          MAIN_WH)
        order = [("argb", argb), ("index", index)]
        for name, r in (order if k % 2 else order[::-1]):
            rows[name].append(timed(r, cam))
    a, i = np.array(rows["argb"]), np.array(rows["index"])
    log(f"[argb] {N_FRAMES} flythrough frames through both modes in turns on "
        f"{card}: frame p50 ARGB {np.median(a[:, 0]):.3f} ms, index mode "
        f"{np.median(i[:, 0]):.3f} ms (ARGB slower in "
        f"{int((a[:, 0] > i[:, 0]).sum())} of {N_FRAMES} pairs, median "
        f"difference {np.median(a[:, 0] - i[:, 0]):+.3f} ms); phase 2 p50 "
        f"ARGB {np.median(a[:, 1]):.3f} ms, index mode "
        f"{np.median(i[:, 1]):.3f} ms")
    for t in np.linspace(0.1, 0.8, n):
        cam = path_camera(argb, float(t))
        a, rb, _ = argb.render_device(cam)
        b, _rb, _ = index.render_device(cam)
        compare(f"argb_frame_t{t:.2f}", [a], [b], {})
        if int((a == MAGENTA_I32).sum()):
            raise AssertionError(f"ARGB frame t={t:.2f} holds magenta")
        if not int((rb < 0).sum()):
            raise AssertionError("the ARGB raybuffer holds no color bits")
    log(f"[argb] {n} flythrough frames at {MAIN_WH[0]}x{MAIN_WH[1]}: ARGB "
        f"screen == index-mode screen, 0 pixels differ, 0 magenta")


def split_layout_world():
    """A 32x256x32 world whose columns alternate voxel and air: about 128
    runs a column, over the 60 an inline record holds."""
    from cpuvox_tpu_torch.world import rle

    dims = (32, 256, 32)
    ys = np.arange(0, 256, 2)
    cols = np.array([x * dims[2] + z for x in range(4, 28, 3)
                     for z in range(4, 28, 3)])
    xz = np.repeat(cols, ys.shape[0])
    y = np.tile(ys, cols.shape[0])
    rgb = tuple(((y * (3 + i) + xz) % 251).astype(np.uint8) for i in range(3))
    return rle.build_lod_chain(
        rle.build_lod_from_voxels(dims, 0, xz, y, rgb), 6)


def check_split_layout(device, stats: dict) -> None:
    """The split record layout: the rasterizer at a MAXR over 60 against its
    plain version, and one frame against the plain path."""
    from cpuvox_tpu_torch.bench.capture import capture
    from cpuvox_tpu_torch.config import RenderConfig
    from cpuvox_tpu_torch.render import camera as cm
    from cpuvox_tpu_torch.render.frame import Renderer

    cfg = RenderConfig(width=SMALL_WH[0], height=SMALL_WH[1],
                       occupancy_gate="off")
    r = Renderer.create(split_layout_world(), cfg, device=device)
    dw = r.device_world
    if dw.rec_fwd is not None or dw.max_runs <= 60:
        raise AssertionError(f"max_runs {dw.max_runs}: not the split layout")
    cam = cm.Camera(position=(16.0, 150.0, -10.0), pitch_deg=20.0,
                    yaw_deg=10.0, screen=SMALL_WH)
    cap = capture(r, cam, k=1)
    _want, written = raster_both(cap, stats)
    if not written:
        raise AssertionError("[split] the captured chunk wrote no texel")
    plain = dataclasses.replace(r, config=dataclasses.replace(
        cfg, backend="xla"), lod_distances=None)
    a, rb_a, _ = r.render_device(cam)
    b, rb_b, _ = plain.render_device(cam)
    compare("frame_split", [a, rb_a], [b, rb_b], {})
    check_phase2(r, r.frame_setup(cam), rb_a, stats)
    log(f"[split] split record layout (max_runs {dw.max_runs}, meta records "
        f"{tuple(dw.col_rec.shape)}, {dw.runs.shape[0]} run words): "
        f"rasterize_visits == rasterize_chunk == plain at "
        f"MAXR={cap.cells.runs.shape[-1]} on "
        f"{rays_of(cap)} ({written} texels written); "
        f"{SMALL_WH[0]}x{SMALL_WH[1]} frame through the kernels == plain "
        f"path, {int((rb_a > 0).sum())} texels drawn, 0 differ; "
        f"reproject_screen == plain on it")


def check_phase2(renderer, f, raybuf, stats: dict) -> tuple:
    """The fused phase-2 kernel against its plain version on a frame's
    raybuffer; returns the kernel's arguments."""
    from cpuvox_tpu_torch.ops import reproject_kernel

    args = renderer.phase2_args(f, raybuf)
    compare("reproject_screen", [reproject_kernel.reproject_screen(*args)],
            [reproject_kernel.reproject_screen_ref(*args)], stats)
    return args


def check_terrain_kernels(renderer, stats: dict, tag="terrain"):
    """Each kernel against its plain version on a terrain frame (index mode,
    or ARGB mode where the renderer's records carry colors)."""
    from cpuvox_tpu_torch.bench.capture import capture
    from cpuvox_tpu_torch.ops import reproject_kernel

    dev = renderer.device
    dims = renderer.device_world.dims
    dda, alive, *rest = adversarial_roll_state(dev)
    compare("roll_chunk", *roll_both(dda, alive, *rest), stats)
    log(f"[{tag}] roll_chunk == plain on the adversarial state "
        f"(R={dda.pos.shape[0]}, C={rest[-1]}): 0 of "
        f"{dda.pos.shape[0] * (rest[-1] * 13 + 12)} fields differ")

    cam = path_camera(renderer, 0.35)
    for compact in (False, True):  # full width, then as the march runs it
        if compact:
            cap, depth = capture_compacted(renderer, cam, k=2)
        else:
            cap, depth = capture(renderer, cam, k=2, compact=False), 2
        compare("roll_chunk", *roll_both_cap(cap, dims), stats)
        log(f"[{tag}] roll_chunk == plain on a terrain2048 "
            f"{renderer.render_wh[0]}x{renderer.render_wh[1]} frame, chunk "
            f"{depth + 1}, "
            f"on {rays_of(cap)} (C={cap.chunk}, {int(cap.alive.sum())} rays "
            f"marching): visits, 6 DDA fields, alive")
        want, written = raster_both(cap, stats)
        if not written:
            raise AssertionError(f"[{tag}] the captured chunk wrote no texel")
        mcc = 0 if cap.cells.colors is None else cap.cells.colors.shape[-1]
        log(f"[{tag}] rasterize_visits == rasterize_chunk == plain on that "
            f"chunk, on "
            f"{rays_of(cap)}: raybuffer {tuple(want.raybuf.shape)} + 8 state "
            f"fields, {written} texels written, "
            f"MAXR={cap.cells.runs.shape[-1]}, MCC={mcc}")

    f = renderer.frame_setup(path_camera(renderer, 0.35))
    raybuf = renderer.march(f)
    maps = sample_maps(renderer, f.tables)
    for ri, mask in maps:
        compare("sample_raybuffer",
                [reproject_kernel.sample_raybuffer(raybuf, ri, mask)],
                [reproject_kernel.sample_raybuffer_ref(raybuf, ri, mask)], stats)
    log(f"[{tag}] sample_raybuffer (the previous phase-2 design) == plain on "
        f"that frame's maps (LR {tuple(maps[0][0].shape)}, TD "
        f"{tuple(maps[1][0].shape)}, raybuffer {tuple(raybuf.shape)})")
    args = check_phase2(renderer, f, raybuf, stats)
    # and the same view rendered at half size, upscaled to the full screen
    half = dataclasses.replace(renderer, config=dataclasses.replace(
        renderer.config, render_scale=0.5), lod_distances=None)
    fh = half.frame_setup(path_camera(renderer, 0.35))
    check_phase2(half, fh, half.march(fh), stats)
    log(f"[{tag}] reproject_screen == plain on that frame "
        f"({'ARGB' if renderer.argb_on else 'index'} mode, "
        f"{args[2]}x{args[3]}) and on the same view at render scale 0.5 "
        f"({half.render_wh[0]}x{half.render_wh[1]} upscaled to "
        f"{MAIN_WH[0]}x{MAIN_WH[1]}): 0 pixels differ")
    return {"roll": cap, "raster": (cap, written), "phase2": (args, maps)}


def sample_maps(renderer, tables):
    """The two reprojection passes' (ray index, mask) maps of a frame."""
    from cpuvox_tpu_torch.render import reproject

    w, h = renderer.render_wh
    seg_id, ray_idx = reproject.segment_ray_index(tables, w, h,
                                                  renderer.device)
    return [(ray_idx, (seg_id >= 2).to(torch.int32)),
            (ray_idx.t().contiguous(),
             (seg_id < 2).to(torch.int32).t().contiguous())]


def check_oracle(device):
    """The port on the card against the numpy oracle on a 64^3 world."""
    from cpuvox_tpu_torch.config import RenderConfig
    from cpuvox_tpu_torch.render import camera as cm
    from cpuvox_tpu_torch.render import oracle
    from cpuvox_tpu_torch.render import segments as sg
    from cpuvox_tpu_torch.render.frame import Renderer
    from cpuvox_tpu_torch.utils import colors

    lods = random_world_64()
    wh = (160, 120)
    cam = cm.limit_rotation_horizon(cm.Camera(
        position=(20.5, 40.0, 6.5), pitch_deg=25.0, yaw_deg=35.0, screen=wh))
    lod_d, far = cm.setup_lods(cam, 64, 6, 1.0)
    cam_data = cm.make_camera_data(cam, lod_d, far)
    vps = cm.vanishing_point_screen(cam, cm.vanishing_point_world(cam))
    segs = sg.build_segments(cam, vps)
    ctxs = sg.build_segment_contexts(cam, segs, vps)
    t0 = time.perf_counter()
    td, lr = oracle.render_raybuffers_oracle(lods, cam, cam_data, segs, ctxs)
    screen = oracle.reproject_oracle(cam, segs, ctxs, vps, td, lr)
    t_oracle = time.perf_counter() - t0
    r = Renderer.create(lods, RenderConfig(width=wh[0], height=wh[1]),
                        device=device)
    r.lod_distances, r.far_clip = lod_d, far
    got, (gtd, glr, *_rest) = r.render(cam, return_raybuffers=True)
    for what, a, b in (("td", gtd, td), ("lr", glr, lr), ("screen", got, screen)):
        n = int((a != b).sum()) if a.shape == b.shape else -1
        if n:
            raise AssertionError(f"oracle check: {what} differs ({n} texels, "
                                 f"shapes {a.shape} vs {b.shape})")
    drawn = int((screen != colors.SKYBOX).sum())
    if not drawn:
        raise AssertionError("oracle check: the scene drew nothing")
    log(f"[oracle] port (kernels, {device}, gate "
        f"{'on' if r.occupancy_on else 'off'}) == numpy oracle on a 64^3 "
        f"random world at {wh[0]}x{wh[1]}: td {td.shape}, lr {lr.shape}, "
        f"screen {screen.shape}, {drawn} non-sky pixels, 0 texels differ "
        f"(oracle {t_oracle:.1f} s)")


def check_small_frame(renderer, scene: str, variants, stats: dict):
    """One 320x180 frame through each variant: (label, config changes,
    another renderer or None, compact).  Screens must all equal the
    first's, and so must the raybuffers of the variants that share its
    renderer (an index-mode raybuffer holds indices, an ARGB one colors).
    Each variant's raybuffer also goes through the fused phase-2 kernel and
    its plain version."""
    from cpuvox_tpu_torch.render import raymarch

    cam = path_camera(renderer, 0.35, SMALL_WH)
    outs = []
    for label, kw, other, compact in variants:
        base = other or renderer
        cfg = dataclasses.replace(base.config, width=SMALL_WH[0],
                                  height=SMALL_WH[1], **kw)
        r = dataclasses.replace(base, config=cfg, lod_distances=None)
        n0 = raymarch.compact_stats["rebuilds"]
        t0 = time.perf_counter()
        f = r.frame_setup(cam)
        rb = r.march(f, compact=compact)
        screen = r.phase2(f, rb)
        torch.cuda.synchronize()
        outs.append((label, screen, rb, time.perf_counter() - t0,
                     r.occupancy_on))
        check_phase2(r, f, rb, stats)
        rebuilt = raymarch.compact_stats["rebuilds"] - n0
        if bool(rebuilt) != compact:
            raise AssertionError(f"{scene} {label}: {rebuilt} index rebuilds "
                                 f"with compact={compact}")
    for (label, screen, rb, _t, _g), (_l, _kw, other, _c) in zip(
            outs[1:], variants[1:]):
        compare(f"frame_{scene}_{label}",
                [screen] if other else [screen, rb],
                [outs[0][1]] if other else [outs[0][1], outs[0][2]], {})
    log(f"[{scene}] {SMALL_WH[0]}x{SMALL_WH[1]} frame: "
        + " == ".join(f"{label} (gate {'on' if g else 'off'}, {t:.2f} s cold)"
                      for label, _s, _r, t, g in outs)
        + f": screen {tuple(outs[0][1].shape)}, raybuffer "
        f"{tuple(outs[0][2].shape)}, 0 texels differ; reproject_screen == "
        "plain on each")


def check_gated_kernels(renderer, stats: dict):
    """Phase 4b: the roll at chunk 128 and the rasterizer on a gated group,
    mid-march, in both iteration directions."""
    from cpuvox_tpu_torch.bench.capture import capture

    dims = renderer.device_world.dims
    caps = {}
    for t, compact in ((0.35, True), (0.6, True), (0.35, False)):
        if compact:
            cap, _depth = capture_compacted(renderer, path_camera(renderer, t),
                                            k=3)
        else:
            cap = capture(renderer, path_camera(renderer, t), k=3,
                          compact=False)
        d = cap.frame.iteration_direction
        if not cap.gated or cap.chunk != 128:
            raise AssertionError(f"layered2048 did not take the gated march "
                                 f"(gated {cap.gated}, chunk {cap.chunk})")
        compare("roll_chunk", *roll_both_cap(cap, dims), stats)
        if not int(cap.cells.valid.sum()):
            raise AssertionError(f"direction {d:+d}: the captured group holds "
                                 "no gated cell")
        _want, written = raster_both(cap, stats)
        GK, _rk, maxr = cap.cells.runs.shape
        log(f"[layered] direction {d:+d} (path t={t}), on {rays_of(cap)}: "
            f"roll_chunk == plain at C={cap.chunk} ({int(cap.alive.sum())} "
            f"rays marching); rasterize_visits == rasterize_chunk == plain "
            f"on a gated group "
            f"(GK={GK}, MAXR={maxr}, {int(cap.cells.valid.sum())} gated "
            f"cells, {written} texels written): raybuffer + 8 state fields, "
            f"0 elements differ")
        if compact:
            caps[d] = (cap, written)
    if set(caps) != {1, -1}:
        raise AssertionError(f"iteration directions seen: {sorted(caps)}")
    return caps


def flythrough(renderer, scene: str, card: str, gated: bool):
    """A path's 1080p flythrough with the launch counts set to 0 just before
    it and read just after it, and every torch column fetch and torch
    phase-2 index map counted (the frames through the kernels must make
    none): phase 2 is one launch of the fused kernel a frame."""
    from cpuvox_tpu_torch.bench.harness import run_flythrough
    from cpuvox_tpu_torch.ops import march_loop, phase1_kernel
    from cpuvox_tpu_torch.ops import reproject_kernel
    from cpuvox_tpu_torch.render import raymarch, reproject

    march_loop.reset_launches()
    raymarch.gated_stats.update(iterations=0, rewinds=0)
    raymarch.compact_stats.update(rebuilds=0, chunks=0, ray_slots=0)
    watched = ((raymarch, "_fetch_columns"), (reproject, "segment_ray_index"))
    originals = [getattr(m, name) for m, name in watched]
    calls = {name: 0 for _m, name in watched}

    def counted(name, fn):
        def wrapper(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapper

    for (m, name), fn in zip(watched, originals):
        setattr(m, name, counted(name, fn))
    try:
        metrics = run_flythrough(renderer, n_frames=N_FRAMES, log=log)
    finally:
        for (m, name), fn in zip(watched, originals):
            setattr(m, name, fn)
    counts = march_loop.kernel_launches()
    launches = [counts[k[0]] for k in KERNELS]
    gstats = dict(raymarch.gated_stats)
    cstats = dict(raymarch.compact_stats)
    # the harness's two warmup frames count too, and its pipelined pass
    frames = 2 * N_FRAMES + 2
    if any(calls.values()) or phase1_kernel.chunk_launches:
        raise AssertionError(f"{scene}: torch calls {calls} and "
                             f"{phase1_kernel.chunk_launches} launches of the "
                             "previous rasterizer on the frame path")
    if reproject_kernel.sample_launches or launches[2] != frames:
        raise AssertionError(
            f"{scene}: phase 2 made {launches[2]} fused launches and "
            f"{reproject_kernel.sample_launches} sample launches in {frames} "
            "frames, where one fused launch a frame was expected")
    if not cstats["rebuilds"]:
        raise AssertionError(f"{scene}: the march never compacted its rays")
    if metrics["magenta_pixels"]:
        raise AssertionError(f"{scene}: {metrics['magenta_pixels']} magenta "
                             "pixels in the flythrough")
    if min(launches) <= 0:
        raise AssertionError(f"{scene}: a kernel did not run on the path: "
                             f"launches {launches}")
    if gated and gstats["rewinds"] <= 0:
        raise AssertionError(f"{scene}: the gated march rewound no ray")
    extra = (f"; {gstats['iterations'] / frames:.1f} gated iterations and "
             f"{gstats['rewinds'] / frames:.0f} rays rewound per frame"
             if gated else "")
    extra += (f"; {cstats['rebuilds'] / frames:.1f} index rebuilds a frame, "
              f"mean {cstats['ray_slots'] / cstats['chunks']:.0f} of "
              f"{renderer.ray_capacity} ray slots a chunk")
    log(f"[{scene}] {MAIN_WH[0]}x{MAIN_WH[1]} flythrough, {N_FRAMES} frames "
        f"on {card}: fps {metrics['fps']:.3f} (pipelined "
        f"{metrics['fps_pipe']:.3f}), frame p50 "
        f"{metrics['frame_ms_p50']:.1f} ms (device span p50 "
        f"{metrics['frame_gpu_ms_p50']:.1f} ms), "
        f"{metrics['ray_columns_per_sec']:.0f} ray columns/s, 0 magenta, 0 "
        f"torch column fetches, 0 torch phase-2 index maps; launches roll "
        f"{launches[0]}, rasterize {launches[1]}, phase 2 {launches[2]} "
        f"(0 of the previous sample){extra}")
    return dict(zip([k[0] for k in KERNELS], launches)), metrics, gstats


def check_lods_past_8(renderer, stats: dict) -> None:
    """More LOD distances than the roll kernel holds in registers: the
    kernel's memory form at 9 distances against the plain roll (rays up to
    LOD 8), and one 320x180 frame at ``lod_levels`` 9 through the kernels
    against the plain path, rays of the frame past LOD 7."""
    from cpuvox_tpu_torch.ops import roll_kernel

    dda, alive, dirs, _lods, far, dims, _c = adversarial_roll_state(
        renderer.device)
    lods = torch.arange(1, 10, dtype=torch.float32, device=renderer.device)
    got, want = roll_both(dda, alive, dirs, lods, far, dims, 48)
    compare("roll_chunk", got, want, stats)
    top = int(got[-1][:, 4].max())
    if top < 8:
        raise AssertionError(f"the roll at 9 LOD distances reached LOD {top}")
    seen = []
    kernel = roll_kernel.roll_chunk

    def spy(*a, **kw):
        out = kernel(*a, **kw)
        seen.append(out[2][:, 4].max())
        return out

    roll_kernel.roll_chunk = spy
    try:
        kw = {"lod_levels": 9, "lod_error": 64.0}
        check_small_frame(renderer, "lod9", [
            ("kernels", kw, None, True),
            ("plain", {**kw, "backend": "xla"}, None, True)], stats)
    finally:
        roll_kernel.roll_chunk = kernel
    frame_top = int(torch.stack(seen).max())
    if frame_top < 8:
        raise AssertionError(f"the lod_levels 9 frame reached LOD {frame_top}")
    log(f"[lod9] roll_chunk at 9 LOD distances (the memory form) == plain on "
        f"the adversarial state at C=48, rays up to LOD {top}, 0 elements "
        f"differ; the lod_levels 9 frame's rays reached LOD {frame_top}")


# ------------------------------------------------------------- the march loop

# path cameras of the [loop] phase: both iteration directions appear
LOOP_PATH_T = (0.0, 0.35, 0.6, 0.9)
SMALL_FRAME_T = 0.35  # check_small_frame's camera


def check_loop_kernel(renderer, stats: dict) -> dict:
    """The loop-control kernel against its plain version at the frame's ray
    count (tolerance 0: alive, the counter and the condition), on seeded
    masks with rays alive, with none alive, at the budget's end, as the
    first check, and at an odd count from an odd address (its byte path);
    then its time against the plain version and its bound."""
    from cpuvox_tpu_torch.ops import march_loop

    dev = renderer.device
    R = renderer.ray_capacity
    rng = np.random.default_rng(7)

    def mask(p):
        return torch.from_numpy(rng.random(R + 1) < p).to(dev)

    cases = [(mask(0.5), mask(0.5), 3, 100, False),
             (mask(0.5), torch.zeros(R + 1, dtype=torch.bool, device=dev),
              3, 100, False),
             (mask(0.1), mask(0.9), 99, 100, False),
             (mask(0.5), mask(0.5), 41, 100, True)]
    conds = []
    for alive, rs_alive, i, mx, first in cases:
        for lo in (0, 1):  # the word path, then R - 1 rays from an odd byte
            a, b = alive[lo:lo + R - lo], rs_alive[lo:lo + R - lo]
            got = [a.clone(), torch.tensor(i, dtype=torch.int32, device=dev)]
            want = [a.clone(), got[1].clone()]
            got.append(march_loop.loop_control(got[0], b, got[1], mx, first))
            want.append(march_loop.loop_control_ref(want[0], b, want[1], mx,
                                                    first))
            compare("march_loop", got, want, stats)
            conds.append(int(got[2]))
    if conds != [1, 1, 0, 0, 0, 0, 1, 1]:
        raise AssertionError(f"[loop] the control's conditions {conds}")
    alive, rs_alive = mask(0.5)[:R], mask(0.5)[:R]
    counter = torch.zeros((), dtype=torch.int32, device=dev)
    ms = time_ms(lambda _: march_loop.loop_control(alive, rs_alive, counter,
                                                   1 << 30), 50)
    device = device_ms(lambda _: march_loop.loop_control(
        alive, rs_alive, counter, 1 << 30), lambda: None, 400)
    plain_ms = time_ms(lambda _: march_loop.loop_control_ref(
        alive, rs_alive, counter, 1 << 30), 50)
    # read alive and rs_alive and the counter, write alive, the counter and
    # the condition; an AND and an OR a ray
    nbytes, nops = 3 * R + 12, 2 * R
    b_ms, b_by = bound(nbytes, nops)
    out = {"ms": ms, "device_ms": device, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
           "operations": nops, "library_ms": None, "rays": R}
    log(f"[loop] march_loop == plain at {R} rays (and {R - 1} from an odd "
        f"address): alive, counter and condition, 0 elements differ, "
        f"tolerance 0; kernel {ms:.4f} ms a call, {device:.4f} ms on the "
        f"device a launch, plain {plain_ms:.4f} ms, bound {b_ms:.6f} ms "
        f"({b_by}: {nbytes} B, {nops} ops), library none ({card_line()})")
    return out


def check_loop(renderer, tag: str, card: str, stats: dict, loop: dict):
    """Phase [loop] on one variant of the march graph (``Renderer`` with the
    kernels and compaction off): (a) on 1080p path cameras in both
    iteration directions the graph march == the host-driven march with the
    kernels on the same rays (raybuffer and screen), and at 320x180 in the
    direction that ``check_small_frame`` did not hold, a frame == the plain
    versions; (b) a warm ``render_device`` under
    ``set_sync_debug_mode("error")``; (c) the device counter's iterations
    == the host loop's on each camera; (d) the 24-frame flythrough
    sequential and pipelined, its launch counts set to 0 just before and
    read just after: pipelined screens == sequential, 0 magenta, one graph
    launch a frame, and a returned raybuffer unchanged after the next
    frame; (e) frame p50 both ways, the device span, the pipelined pass's
    busy share under the profiler (over the profiled pass's own wall, which
    the profiler lengthens), the card's time a frame after its setup (CUDA
    events around the graph launch and phase 2) and its sum over the
    pipelined pass's unprofiled wall, and each capture's times and pool
    bytes.  Adds the path's counts and numbers to ``loop[tag]``."""
    from cpuvox_tpu_torch.bench.breakdown import device_activities, union_us
    from cpuvox_tpu_torch.bench.harness import run_flythrough
    from cpuvox_tpu_torch.ops import march_loop
    from cpuvox_tpu_torch.render import raymarch

    r = renderer
    if not (r.kernels and not r.compact and r.device.type == "cuda"):
        raise AssertionError(f"[loop] {tag}: not a march-graph Renderer")
    stat, key = ((raymarch.gated_stats, "iterations") if r.occupancy_on
                 else (raymarch.compact_stats, "chunks"))
    t_phase = time.perf_counter()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    # the profiler's tracer started before this variant's graphs are
    # instantiated: the kernels of a graph instantiated before a process's
    # first profile do not show in later profiles
    with torch.profiler.profile(activities=acts):
        torch.cuda.synchronize()
    dirs: dict = {}
    for t in LOOP_PATH_T:
        cam = path_camera(r, t)
        f = r.frame_setup(cam)
        n0 = march_loop.graph_stats["iterations"]
        got = r.march(f)
        graph_it = march_loop.graph_stats["iterations"] - n0
        h0 = stat[key]
        host = r.march_rays(f.static, f.dda, f.alive0, f.cam_data,
                            f.cam_data.position[1], f.iteration_direction,
                            compact=False)
        host_it = stat[key] - h0
        compare(f"[loop] {tag} t={t}", [got, r.phase2(f, got)],
                [host, r.phase2(f, host)], {})
        if graph_it != host_it or graph_it <= 0:
            raise AssertionError(f"[loop] {tag} t={t}: {graph_it} graph "
                                 f"iterations, {host_it} on the host loop")
        r.render_device(cam)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            r.render_device(cam)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        dirs.setdefault(f.iteration_direction, []).append((t, graph_it))
    if set(dirs) != {1, -1}:
        raise AssertionError(f"[loop] {tag}: directions {dirs}")
    log(f"[loop] {tag} (a)-(c) {MAIN_WH[0]}x{MAIN_WH[1]}: the graph march "
        f"== the host-driven march with the kernels, raybuffer and screen, "
        f"0 texels and 0 pixels differ; a warm render_device under "
        f"set_sync_debug_mode('error') raised nothing; iterations (t, "
        f"graph == host loop) by direction {dirs}")

    # (a) against the plain versions at 320x180, the other direction
    small = dataclasses.replace(r, config=dataclasses.replace(
        r.config, width=SMALL_WH[0], height=SMALL_WH[1]), lod_distances=None)
    plain = dataclasses.replace(small, config=dataclasses.replace(
        small.config, backend="xla"))
    d_small = small.frame_setup(path_camera(small, SMALL_FRAME_T,
                                            SMALL_WH)).iteration_direction
    t_other = next(t for t in LOOP_PATH_T if small.frame_setup(path_camera(
        small, t, SMALL_WH)).iteration_direction != d_small)
    cam = path_camera(small, t_other, SMALL_WH)
    t0 = time.perf_counter()
    a, rb_a, _g = small.render_device(cam)
    b, rb_b, _g = plain.render_device(cam)
    compare(f"[loop] {tag} 320x180 plain", [a, rb_a], [b, rb_b], {})
    log(f"[loop] {tag} (a) {SMALL_WH[0]}x{SMALL_WH[1]} at t={t_other} "
        f"(direction {-d_small}; check_small_frame's 'no compaction' frame "
        f"holds direction {d_small}): the graph frame == the plain versions, "
        f"screen and raybuffer, 0 differ ({time.perf_counter() - t0:.1f} s)")
    del small, plain

    # (d) the flythrough, sequential and pipelined, counted
    march_loop.reset_launches()
    raymarch.gated_stats.update(iterations=0, rewinds=0)
    m = run_flythrough(r, n_frames=N_FRAMES, log=log, keep_screens=True)
    counts = march_loop.kernel_launches()
    launches, iters = march_loop.graph_stats["launches"], \
        march_loop.graph_stats["iterations"]
    frames = 2 * N_FRAMES + 2
    compare(f"[loop] {tag} pipelined screens", m.pop("screens_pipe"),
            m.pop("screens_seq"), {})
    if m["magenta_pixels"]:
        raise AssertionError(f"[loop] {tag}: {m['magenta_pixels']} magenta "
                             "pixels")
    if (launches != frames or iters <= 0 or counts["roll_chunk"] != iters
            or counts["rasterize_visits"] != iters
            or counts["march_loop"] != frames + iters
            or counts["reproject_screen"] != frames):
        raise AssertionError(f"[loop] {tag}: {launches} graph launches and "
                             f"{iters} iterations in {frames} frames, "
                             f"kernel counts {counts}")
    cams = [path_camera(r, t) for t in (0.35, 0.6)]
    _s, rb0, _g = r.render_device(cams[0])
    keep = rb0.clone()
    _s, rb1, _g = r.render_device(cams[1])
    torch.cuda.synchronize()
    if (not torch.equal(rb0, keep) or torch.equal(rb0, rb1)
            or rb0.data_ptr() == r._graph.state.rs.raybuf.data_ptr()):
        raise AssertionError(f"[loop] {tag}: a returned raybuffer changed "
                             "with the next frame, or aliases the graph's")

    # (e) the pipelined pass's busy share, under the profiler
    path = [path_camera(r, t) for t in np.linspace(0.0, 1.0, N_FRAMES)]
    # the pass twice under the profiler, the second read
    for _ in range(2):
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            previous = None
            for cam in path:
                r.render_device(cam)
                ready = torch.cuda.Event()
                ready.record()
                if previous is not None:
                    previous.synchronize()
                previous = ready
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) * 1e3
    # the card's own time a frame: CUDA events around the march graph's
    # launch and phase 2, the frame's setup done and synced before
    frame_dev = []
    for cam in path:
        f = r.frame_setup(cam)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        r.phase2(f, r.march(f))
        end.record()
        torch.cuda.synchronize()
        frame_dev.append(start.elapsed_time(end))
    dev_frame_ms = float(np.median(frame_dev))
    dev = device_activities(prof)
    if not dev:
        raise AssertionError(f"[loop] {tag}: the profiler recorded no "
                             "device activity")
    busy_ms = union_us((a_, b_) for _n, a_, b_ in dev) / 1e3
    wall_ms = N_FRAMES / m["fps_pipe"] * 1e3
    caps = r._graph.captures
    loop[tag] = {"launches": counts, "graph_launches": launches,
                 "iterations": iters, "fps_seq": m["fps_seq"],
                 "fps_pipe": m["fps_pipe"], "frame_ms_p50": m["frame_ms_p50"],
                 "frame_ms_p50_pipe": m["frame_ms_p50_pipe"],
                 "frame_gpu_ms_p50": m["frame_gpu_ms_p50"],
                 "busy_share_pipe": busy_ms / prof_ms,
                 "device_frame_ms_p50": dev_frame_ms,
                 "device_share_pipe": sum(frame_dev) / wall_ms,
                 "captures": caps}
    log(f"[loop] {tag} (d) {MAIN_WH[0]}x{MAIN_WH[1]} flythrough, {N_FRAMES} "
        f"frames: pipelined screens == sequential, 0 pixels differ, 0 "
        f"magenta; a returned raybuffer unchanged after the next frame; "
        f"{launches} graph launches in {frames} frames (2 warmup, "
        f"{N_FRAMES} sequential, {N_FRAMES} pipelined), {iters} "
        f"iterations ({iters / frames:.1f} a frame): roll "
        f"{counts['roll_chunk']}, rasterize {counts['rasterize_visits']}, "
        f"march_loop {counts['march_loop']}, phase 2 "
        f"{counts['reproject_screen']} ({card})")
    log(f"[loop] {tag} (e) fps {m['fps_seq']:.3f} sequential, "
        f"{m['fps_pipe']:.3f} pipelined; frame p50 {m['frame_ms_p50']:.3f} "
        f"ms sequential (device span p50 {m['frame_gpu_ms_p50']:.3f} ms), "
        f"{m['frame_ms_p50_pipe']:.3f} ms pipelined; the pipelined pass "
        f"again under the profiler: device busy (the union of "
        f"{len(dev)} device activities) {busy_ms:.3f} ms in its "
        f"{prof_ms:.3f} ms, busy share {busy_ms / prof_ms:.4f} (against the "
        f"unprofiled pass's {wall_ms:.3f} ms: {busy_ms / wall_ms:.4f}); the "
        f"card's time a frame after its setup (events around the graph "
        f"launch and phase 2) p50 {dev_frame_ms:.3f} ms, "
        f"{sum(frame_dev):.3f} ms over the {N_FRAMES} frames, "
        f"{sum(frame_dev) / wall_ms:.4f} of the unprofiled pipelined pass "
        f"({card})")
    for c in caps:
        log(f"[loop] {tag} (e) capture, direction {c['direction']}, "
            f"{'gated' if c['gated'] else 'dense'}: warm iteration "
            f"{c['warm_ms']:.3f} ms, capture {c['capture_ms']:.3f} ms, "
            f"instantiate {c['instantiate_ms']:.3f} ms, private pool "
            f"+{c['pool_bytes']} bytes")
    log(f"[loop] {tag} done in {time.perf_counter() - t_phase:.1f} s")


ROLLOUT_WH = (256, 256)
N_ROLLOUT_CAMS = 64


def check_batch_singles(renderer, cams, tag: str, stats: dict):
    """The camera batch through the kernels against each camera's own
    frame; returns the batch."""
    from cpuvox_tpu_torch.parallel.batch import render_camera_batch
    from cpuvox_tpu_torch.render.raymarch import MAGENTA_I32

    got = render_camera_batch(renderer, cams)
    compare(f"{tag} batch, single frames", [got],
            [torch.stack([renderer.render_device(c)[0] for c in cams])],
            stats)
    if int((got == MAGENTA_I32).sum()):
        raise AssertionError(f"[{tag}] magenta pixels in the batch")
    return got


def rollout_work(renderer, args):
    """``phase2_work`` of every camera of a batched phase-2 call."""
    raybuf, tables, R1, rw, rh, W, H, colors, sky = args
    nbytes = nops = 0
    for b, t in enumerate(tables):
        one = (raybuf[b * R1:(b + 1) * R1], t, rw, rh, W, H, colors, sky)
        w = phase2_work(one, sample_maps(renderer, t))
        nbytes += w[0]
        nops += w[1]
    return nbytes, nops


def check_rollout(card: str, stats: dict) -> dict:
    """The RL-rollout mode (``parallel/batch.py``): ``bench.py``'s rollout
    world and 64-camera steps at 256x256 (``bench/harness.py``).  The batch
    through the kernels == the batch through the plain versions == each
    camera's single-camera frame; 8 cameras in ARGB mode and 8 on a gated
    layered world against their single frames; both phase-2 variants
    against the plain phase 2 camera by camera, timed side by side; then
    cams/s compacted and not in turns, launches a step, and a step's device
    busy share.  The rollout path's kernel counts are set to 0 just before
    its first timed run and read just after it."""
    from cpuvox_tpu_torch.bench import harness
    from cpuvox_tpu_torch.bench.breakdown import device_activities, union_us
    from cpuvox_tpu_torch.config import RenderConfig
    from cpuvox_tpu_torch.models import procedural
    from cpuvox_tpu_torch.ops import phase1_kernel, roll_kernel
    from cpuvox_tpu_torch.ops import reproject_kernel as rk
    from cpuvox_tpu_torch.parallel import batch
    from cpuvox_tpu_torch.render.frame import Renderer

    t0 = time.perf_counter()
    r = harness.rollout_renderer(ROLLOUT_WH)
    dw = r.device_world
    if r.occupancy_on or dw.max_runs != 3:
        raise AssertionError(f"rollout world: gate {r.occupancy_on}, "
                             f"max_runs {dw.max_runs}")
    cams = harness.rollout_cameras(1, N_ROLLOUT_CAMS, ROLLOUT_WH, dw.dims)
    frames = [r.frame_geometry(c) for c in cams]
    n_up = sum(f.iteration_direction < 0 for f in frames)
    log(f"[rollout] world {dw.dims} up in {time.perf_counter() - t0:.1f} s "
        f"({dw.lod0_voxels} LOD0 voxels, max_runs {dw.max_runs}, gate off); "
        f"{N_ROLLOUT_CAMS} cameras at {ROLLOUT_WH[0]}x{ROLLOUT_WH[1]}, "
        f"{N_ROLLOUT_CAMS - n_up} looking down and {n_up} up, R1 "
        f"{r.ray_capacity} rays a camera")
    if not 0 < n_up < N_ROLLOUT_CAMS:
        raise AssertionError("the rollout step holds one iteration direction")

    # the step three ways
    t0 = time.perf_counter()
    kb = check_batch_singles(r, cams, "rollout", {})
    torch.cuda.synchronize()
    t_k = time.perf_counter() - t0
    plain = dataclasses.replace(r, config=dataclasses.replace(
        r.config, backend="xla"), compact=True)
    t0 = time.perf_counter()
    pb = batch.render_camera_batch(plain, cams)
    torch.cuda.synchronize()
    t_p = time.perf_counter() - t0
    compare("rollout batch, plain", [kb], [pb], {})
    log(f"[rollout] one step of {N_ROLLOUT_CAMS} cameras: the batch through "
        f"the kernels == the batch through the plain versions (compacted, "
        f"{t_p:.1f} s) == the {N_ROLLOUT_CAMS} single-camera kernel frames "
        f"({t_k:.2f} s with the batch, cold), index mode, 0 pixels differ, "
        "0 magenta")

    ra = harness.rollout_renderer(ROLLOUT_WH, argb_records=True)
    if not ra.argb_on:
        raise AssertionError("the rollout world did not engage ARGB mode")
    check_batch_singles(ra, cams[:8], "rollout ARGB", {})
    mcc = ra.device_world.max_col_colors
    del ra
    gdims = (256, 128, 256)
    rg = Renderer.create(
        procedural.layered_world(dims=gdims, seed=99, lod_levels=6),
        RenderConfig(width=ROLLOUT_WH[0], height=ROLLOUT_WH[1],
                     occupancy_gate="on"), device=r.device, compact=True)
    if not rg.occupancy_on:
        raise AssertionError("the layered world's gate resolved off")
    gcams = harness.rollout_cameras(2, 8, ROLLOUT_WH, gdims)
    check_batch_singles(rg, gcams, "rollout gated", {})
    log(f"[rollout] 8 cameras in ARGB mode (max_col_colors {mcc}) and 8 "
        f"on a gated layered {gdims} world (max_runs "
        f"{rg.device_world.max_runs}): each batch == its single-camera "
        "kernel frames, 0 pixels differ, 0 magenta")
    del rg

    # phase 2 of the looking-down group, both variants
    group = [f for f in frames if f.iteration_direction > 0]
    args = batch.phase2_group_args(r, batch.march_group(r, group, 1), group)
    want = rk.reproject_screens_ref(*args)
    compare("reproject_screens", [rk.reproject_screens(*args)], [want], stats)
    compare("reproject_screen", [rk.reproject_screens_per_camera(*args)],
            [want], stats)
    p2 = {}
    for name, fn in (("batched", rk.reproject_screens),
                     ("per camera", rk.reproject_screens_per_camera)):
        time_ms(lambda _: fn(*args), 3)  # warm
        p2[name] = {"ms": time_ms(lambda _: fn(*args), 20),
                    "device_ms": device_ms(lambda _: fn(*args),
                                           lambda: None, 4)}
    p2["plain_ms"] = time_ms(lambda _: rk.reproject_screens_ref(*args), 3)
    # the library calls of the sample alone: one gather and one where a pass
    # over the whole group's raybuffer, each camera's ray indices offset to
    # its block of R1 rows
    raybuf, R1 = args[0], args[2]
    maps = [sample_maps(r, t) for t in args[1]]
    batch_maps = [(torch.cat([m[k][0].long() + b * R1
                              for b, m in enumerate(maps)]),
                   torch.cat([m[k][1] != 0 for m in maps])) for k in (0, 1)]

    def gather_where(_):
        return [torch.where(m, torch.gather(raybuf, 0, ri), -1)
                for ri, m in batch_maps]

    time_ms(gather_where, 3)  # warm
    p2["library_ms"] = time_ms(gather_where, 20)
    p2["library_device_ms"] = device_ms(gather_where, lambda: None, 10)
    work = rollout_work(r, args)
    p2["bound_ms"], p2["bound_by"] = bound(*work)
    p2["bytes"], p2["operations"] = int(work[0]), int(work[1])
    log(f"[rollout] phase 2 of {len(group)} cameras ({args[0].shape[0]} "
        f"rays x {args[0].shape[1]} texels): reproject_screens (one launch) "
        f"{p2['batched']['ms']:.4f} ms a call, "
        f"{p2['batched']['device_ms']:.4f} ms on the device; "
        f"reproject_screen a camera ({len(group)} launches) "
        f"{p2['per camera']['ms']:.4f} ms a call, "
        f"{p2['per camera']['device_ms']:.4f} ms on the device; plain "
        f"{p2['plain_ms']:.4f} ms; library (torch.gather + where over the "
        f"group's raybuffer, the sample alone) {p2['library_ms']:.4f} ms a "
        f"call, {p2['library_device_ms']:.4f} ms on the device; bound "
        f"{p2['bound_ms']:.4f} ms "
        f"({p2['bound_by']}: {p2['bytes']} B); both == plain camera by "
        f"camera, 0 pixels differ ({card})")

    # the timed runs: compaction off (the Renderer's default, the path's
    # launch counts) and on, in turns
    runs = {False: [], True: []}
    for k, compact in enumerate((False, True, True, False)):
        rr = dataclasses.replace(r, compact=compact)
        if k == 0:
            for m in (roll_kernel, phase1_kernel, rk):
                m.launches = 0
            rk.screens_launches = 0
        m = harness.run_rollout(rr, N_ROLLOUT_CAMS, log=log)
        if k == 0:
            launches = {"roll_chunk": roll_kernel.launches,
                        "rasterize_visits": phase1_kernel.launches,
                        "reproject_screen": rk.launches,
                        "reproject_screens": rk.screens_launches}
        if m["magenta_pixels"]:
            raise AssertionError("[rollout] magenta pixels in the timed run")
        runs[compact].append(m)
    if min(launches["roll_chunk"], launches["rasterize_visits"],
           launches["reproject_screens"]) <= 0 or launches["reproject_screen"]:
        raise AssertionError(f"[rollout] launches {launches}: a kernel of "
                             "the path did not run, or phase 2 ran a camera "
                             "at a time")
    cps = {c: [m["cams_per_sec"] for m in v] for c, v in runs.items()}
    per_step = runs[False][0]["launches_per_step"]

    # a step's device busy share: the union of its device activities under
    # the profiler over the same step's unprofiled wall; and where a step's
    # host time goes, each stage synced
    step = harness.rollout_cameras(9, N_ROLLOUT_CAMS, ROLLOUT_WH, dw.dims)
    walls = []
    stages = {"setup": [], "ray init": [], "march": [], "phase 2": []}
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch.render_camera_batch(r, step)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        t = {k: 0.0 for k in stages}
        t0 = time.perf_counter()
        sframes = [r.frame_geometry(c) for c in step]
        t["setup"] += time.perf_counter() - t0
        for d in (1, -1):
            g = [f for f in sframes if f.iteration_direction == d]
            t0 = time.perf_counter()
            rays = batch._group_rays_host(r, g)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            cam_y = np.repeat(np.asarray([f.cam_data.position[1] for f in g],
                                         np.float32), r.ray_capacity)
            rb = r.march_rays(*rays, g[0].cam_data, cam_y, d)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            batch.phase2_group(r, rb, g)
            torch.cuda.synchronize()
            t["ray init"] += t1 - t0
            t["march"] += t2 - t1
            t["phase 2"] += time.perf_counter() - t2
        for k, v in t.items():
            stages[k].append(v * 1e3)
    log(f"[rollout] where a step's time goes (each stage synced, medians of "
        f"3): " + ", ".join(f"{k} {np.median(v):.3f} ms"
                             for k, v in stages.items())
        + f"; whole step {np.median(walls):.3f} ms ({card})")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        batch.render_camera_batch(r, step)
        torch.cuda.synchronize()
    dev = device_activities(prof)
    if not dev:
        raise AssertionError("the profiler recorded no device activity")
    busy_ms = union_us((a, b) for _n, a, b in dev) / 1e3
    wall_ms = float(np.median(walls))
    log(f"[rollout] cams/s at {N_ROLLOUT_CAMS} cameras, 4 steps a run, runs "
        f"in turns (off, on, on, off): compaction off "
        f"{cps[False][0]:.2f}, {cps[False][1]:.2f}; on {cps[True][0]:.2f}, "
        f"{cps[True][1]:.2f}; launches a step (off): roll "
        f"{per_step['roll_chunk']:.1f}, rasterize "
        f"{per_step['rasterize_visits']:.1f}, phase 2 "
        f"{per_step['reproject_screens']:.1f}; a step's device busy "
        f"{busy_ms:.3f} ms of {wall_ms:.3f} ms wall: busy share "
        f"{busy_ms / wall_ms:.4f} ({len(dev)} device activities) ({card})")
    return {"launches": launches, "cams_per_sec": cps, "phase2": p2,
            "busy_share": busy_ms / wall_ms, "step_ms": wall_ms,
            "stages_ms": {k: float(np.median(v)) for k, v in stages.items()}}


def check_dynamic(card: str, stats: dict) -> dict:
    """Dynamic worlds (``world/dynamic.py``, ``models/dynamic_demo.py``):
    the rebuilt arrays on the card == the same build on the CPU, field by
    field, for the 512 x 128 x 512 surface world (both ``exact_lod1``
    settings) and an editable world after ``set_voxel_column`` edits and a
    chain snapshot; a 1280x720 frame through the kernels == the plain path;
    then ``bench.py``'s timed run (12 frames, 3 where a frame takes over
    2 s).  The path's kernel counts are set to 0 just before the
    ``exact_lod1=False`` timed run (the demo's setting) and read after."""
    from cpuvox_tpu_torch.bench import harness
    from cpuvox_tpu_torch.config import RenderConfig
    from cpuvox_tpu_torch.ops import march_loop
    from cpuvox_tpu_torch.render.raymarch import MAGENTA_I32
    from cpuvox_tpu_torch.world import dynamic as td

    fields = ("col_base", "grid_z", "col_rec", "runs", "runs_rev", "colors")
    dev = torch.device("cuda", 0)
    out = {}
    for exact in (False, True):
        t0 = time.perf_counter()
        d = harness.dynamic_terrain(exact_lod1=exact)
        t_create = time.perf_counter() - t0
        spec = d.spec
        built = []
        for base in (d.base_top, d.base_top.cpu()):
            top = td.animate_heights(spec, base, 0.3)
            wa = td.build_surface_world_arrays(spec, top,
                                               td.terrain_colors(spec, top))
            built.append([getattr(wa, k).to(dev) for k in fields])
        compare(f"dynamic arrays, exact_lod1 {exact}", built[0], built[1], {})
        cam = harness.dynamic_camera(spec.dims)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        screen = d.render_frame(0.3, cam)
        torch.cuda.synchronize()
        t_frame = time.perf_counter() - t1
        plain = dataclasses.replace(d.renderer, config=dataclasses.replace(
            d.renderer.config, backend="xla"), compact=True)
        t1 = time.perf_counter()
        want, _rb, _g = plain.render_device(cam)
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t1
        compare(f"dynamic frame, exact_lod1 {exact}", [screen], [want], {})
        if int((screen == MAGENTA_I32).sum()):
            raise AssertionError("[dynamic] magenta pixels in the frame")
        log(f"[dynamic] exact_lod1 {exact} (max_runs {d.renderer._wa.max_runs}"
            f", {tuple(built[0][2].shape)} meta records, "
            f"{built[0][3].shape[0]} run words, {built[0][5].shape[0]} color "
            f"words): the rebuild on the card == on the CPU, all 6 fields, 0 "
            f"words differ; a {harness.dynamic_camera(spec.dims).screen[0]}x"
            f"{harness.dynamic_camera(spec.dims).screen[1]} frame through the "
            f"kernels ({t_frame:.2f} s cold) == the plain path "
            f"(compacted, {t_plain:.2f} s), 0 pixels differ, 0 magenta "
            f"(DynamicTerrain.create {t_create:.1f} s)")
        n_frames = 12
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        d.render_frame(0.4, cam)
        torch.cuda.synchronize()
        if time.perf_counter() - t1 > 2.0:
            n_frames = 3
        if not exact:
            march_loop.reset_launches()
        m = harness.run_dynamic(d, n_frames=n_frames, log=log)
        if not exact:
            out["launches"] = {k[0]: march_loop.kernel_launches()[k[0]]
                               for k in KERNELS}
            if min(out["launches"].values()) <= 0:
                raise AssertionError(f"[dynamic] launches {out['launches']}")
        if m["magenta_pixels"]:
            raise AssertionError("[dynamic] magenta pixels in the timed run")
        # after the timed frames' swaps the Renderer's march graph reads its
        # own copy of the world, refreshed each frame; a fresh Renderer on
        # the same arrays reads them in place
        d.rebuild(0.55)
        a, _rb, _g = d.renderer.render_device(cam)
        b, _rb, _g = dataclasses.replace(d.renderer).render_device(cam)
        compare(f"dynamic swapped world, exact_lod1 {exact}", [a], [b], {})
        out[exact] = m
        log(f"[dynamic] exact_lod1 {exact}: "
            f"{m['fps']:.3f} fps over {n_frames} frames"
            + ("" if n_frames == 12 else " (3 frames: a frame took over 2 s)")
            + f", frame {m['frame_ms_mean']:.3f} ms; split: rebuild p50 "
            f"{m['rebuild_ms_p50']:.3f} ms, render p50 "
            f"{m['render_ms_p50']:.3f} ms; launches a frame: roll "
            f"{m['launches_per_frame']['roll_chunk']:.1f}, rasterize "
            f"{m['launches_per_frame']['rasterize_visits']:.1f}, phase 2 "
            f"{m['launches_per_frame']['reproject_screen']:.1f}; after the "
            f"swaps, a frame == a fresh Renderer's on the same arrays, 0 "
            f"pixels differ ({card})")
        del d, plain

    # an editable world: the build, three column edits and the chain
    # snapshot on the card == on the CPU, and its frames through the kernels
    # == the plain path
    w0 = random_world_64()[0]
    occ = np.zeros(64, bool)
    occ[[0, 3, 4, 5, 8, 20, 21, 22, 23]] = True
    argb = np.where(occ, np.uint32(0xFF204080) + np.arange(64, dtype=np.uint32)
                    * np.uint32(0x010203), np.uint32(0)).astype(np.uint32)
    worlds = []
    for device in (dev, torch.device("cpu")):
        spec, ew = td.editable_from_lod0(w0, max_runs=24, col_colors=24,
                                         device=device)
        for x, z in ((8, 8), (40, 17), (63, 0)):
            ew = td.set_voxel_column(
                spec, ew, x, z, torch.from_numpy(occ).to(device),
                torch.from_numpy(argb.view(np.int32)).to(device))
        wa, K = td.editable_chain_snapshot(spec, ew, 6)
        worlds.append((spec, ew, wa, K))
    (spec, ew, wa, K), (_s, cew, cwa, cK) = worlds
    if K != cK:
        raise AssertionError(f"chain run capacity {K} on the card, {cK} on "
                             "the CPU")
    compare("editable world", [ew.rec_fwd, ew.rec_rev, ew.colors],
            [cew.rec_fwd.to(dev), cew.rec_rev.to(dev), cew.colors.to(dev)], {})
    compare("editable chain", [getattr(wa, k) for k in fields],
            [getattr(cwa, k).to(dev) for k in fields], {})
    from cpuvox_tpu_torch.render import camera as cm

    cam = cm.Camera(position=(32.0, 48.0, -8.0), pitch_deg=25.0,
                    yaw_deg=15.0, screen=SMALL_WH)
    cfg = RenderConfig(width=SMALL_WH[0], height=SMALL_WH[1])
    for name, make in (("editable", td.editable_renderer),
                       ("chain", td.editable_chain_renderer)):
        a, _rb, _g = make(spec, ew, cfg).render_device(cam)
        b, _rb, _g = make(spec, ew, dataclasses.replace(
            cfg, backend="xla")).render_device(cam)
        compare(f"{name} frame", [a], [b], {})
    log(f"[dynamic] editable 64^3 world (max_runs {spec.max_runs}, "
        f"col_colors {spec.col_colors}, records {tuple(ew.rec_fwd.shape)}): "
        f"3 set_voxel_column edits and a 6-level chain snapshot (max_runs "
        f"{K}) on the card == on the CPU, 0 words differ; its LOD0 and chain "
        f"{SMALL_WH[0]}x{SMALL_WH[1]} frames through the kernels == plain")
    return out


# ------------------------------------------------------------- the mesh path

MESH_MAX_DIM = 2048
MESH_CHECK_DIM = 512
MESH_LOD_LEVELS = 6
# the white block's side and its LODs: LOD 8 holds 256^3 / 8^8 = 1 voxel
MESH_BLOCK, MESH_BLOCK_LODS = 256, 9
# steps held against a plain session: the two warmup steps at 320x180 (the
# second flips the pitch, so both iteration directions), one at 1080p
MESH_PLAIN_STEPS = {SMALL_WH: 2, MAIN_WH: 1}
WORLD_FIELDS = ("col_offset", "col_runs", "col_color_offset", "col_min",
                "col_max", "runs", "colors")


def compare_worlds(name: str, got, want) -> None:
    """Two LOD chains equal in every field of every level, dtypes too."""
    if len(got) != len(want):
        raise AssertionError(f"{name}: {len(got)} levels, {len(want)} wanted")
    for L, (g, w) in enumerate(zip(got, want)):
        if (g.dims, g.lod) != (w.dims, w.lod):
            raise AssertionError(f"{name}: LOD {L} dims/lod differ")
        for f in WORLD_FIELDS:
            a, b = getattr(g, f), getattr(w, f)
            if a.dtype != b.dtype or not np.array_equal(a, b):
                raise AssertionError(f"{name}: LOD {L} field {f} differs")


def validate_in_child(path: str) -> subprocess.Popen:
    """``rle.validate_world`` on every LOD of the .world file at ``path``,
    in a child process (a python loop over the occupied columns: a minute
    and more at LOD 0 of a 2048-wide world) that runs while the card works
    on the next checks; ``finish_validation`` waits for it."""
    code = ("import sys, time\n"
            "from cpuvox_tpu_torch.world import rle, save\n"
            "for w in save.load_world(sys.argv[1]):\n"
            "    t0 = time.perf_counter()\n"
            "    rle.validate_world(w)\n"
            "    print(f'LOD {w.lod}: {int((w.col_runs > 0).sum())} "
            "occupied columns valid in {time.perf_counter() - t0:.1f} s', "
            "flush=True)\n")
    return subprocess.Popen([sys.executable, "-c", code, path],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, cwd=os.path.dirname(
                                os.path.abspath(__file__)))


def build_world_in_child(scene: str) -> subprocess.Popen:
    """Build and cache one of bench.py's scenes (``harness.scene_world``) in
    a child process, so that its host-side numpy overlaps the card's work;
    the child is killed at exit if it still runs."""
    code = ("import sys\n"
            "from cpuvox_tpu_torch.bench.harness import scene_world\n"
            "scene_world(sys.argv[1], log=print)\n")
    proc = subprocess.Popen([sys.executable, "-c", code, scene],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, cwd=os.path.dirname(
                                os.path.abspath(__file__)))
    atexit.register(proc.kill)
    return proc


def wait_child(proc: subprocess.Popen, what: str,
               timeout: float) -> tuple[str, float]:
    """A child's output and the seconds waited for it; raises if it fails
    or outlasts ``timeout`` (then it is killed)."""
    t0 = time.perf_counter()
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    if proc.returncode:
        raise AssertionError(f"{what} failed:\n{out}")
    return out, time.perf_counter() - t0


def finish_validation(proc: subprocess.Popen, timeout: float = 300) -> None:
    out, waited = wait_child(proc, "rle.validate_world", timeout)
    log(f"[mesh] (c) rle.validate_world on every LOD (a child process; "
        f"waited {waited:.1f} s for it): "
        + "; ".join(out.strip().splitlines()))


def copy_session(s):
    """An ``InteractiveSession`` on the same renderer from ``s``'s camera
    and controller state, to replay ``s``'s next steps."""
    return dataclasses.replace(s, look=dataclasses.replace(s.look),
                               fly=dataclasses.replace(s.fly), frame_times=[])


def split_steps(replays, timed: dict, card: str):
    """``run_interactive``'s warmup and timed steps replayed on two copies
    of its session: on the first, each step split into its stages, each
    synced, host clock (ms a step: medians, and the range), and each step's
    march beside its gated iterations (rasterize launches); on the second,
    the timed steps under ``torch.profiler``, whose device activities'
    union over the steps' unprofiled wall is the device busy share.
    Returns (the stages' medians, the busy share)."""
    from cpuvox_tpu_torch.bench import harness
    from cpuvox_tpu_torch.bench.breakdown import device_activities, union_us
    from cpuvox_tpu_torch.ops import march_loop

    s, sp = replays
    r = s.renderer
    inputs = harness.interactive_inputs(timed["n_steps"])
    stages = {k: [] for k in ("controllers", "frame setup", "march",
                              "phase 2", "frame copy")}
    iters = []
    for kw in harness.WARMUP_INPUTS:
        s.step(1 / 30, **kw)
    for kw in inputs:
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        s.cam = s.fly.update(s.look.update(s.cam, kw["mouse_dx"],
                                           kw["mouse_dy"]), 1 / 30,
                             forward=kw["forward"])
        t.append(time.perf_counter())
        f = r.frame_setup(s.cam)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        n0 = march_loop.kernel_launches()["rasterize_visits"]
        rb = r.march(f)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        iters.append(march_loop.kernel_launches()["rasterize_visits"] - n0)
        screen = r.phase2(f, rb)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        screen.cpu().numpy()
        t.append(time.perf_counter())
        for k, a, b in zip(stages, t, t[1:]):
            stages[k].append((b - a) * 1e3)
    total = [sum(v) for v in zip(*stages.values())]
    per_iter = [m / max(n, 1) for m, n in zip(stages["march"], iters)]
    for kw in harness.WARMUP_INPUTS:
        sp.step(1 / 30, **kw)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for kw in inputs:
            sp.step(1 / 30, **kw)
        torch.cuda.synchronize()
    dev = device_activities(prof)
    if not dev:
        raise AssertionError("[mesh] (f) the profiler recorded no device "
                             "activity")
    busy_ms = union_us((a, b) for _n, a, b in dev) / 1e3 / len(inputs)
    wall_ms = timed["step_ms_mean"]
    log(f"[mesh] (f) {MAIN_WH[0]}x{MAIN_WH[1]}: the timed steps replayed, "
        "each stage synced (median, min-max ms a step): "
        + ", ".join(f"{k} {np.median(v):.3f} ({min(v):.3f}-{max(v):.3f})"
                    for k, v in stages.items())
        + f"; all stages {np.median(total):.3f} ({min(total):.3f}-"
        f"{max(total):.3f}); march ms / gated iterations, step by step: "
        + " ".join(f"{m:.1f}/{n}" for m, n in zip(stages["march"], iters))
        + f", {np.median(per_iter):.3f} ({min(per_iter):.3f}-"
        f"{max(per_iter):.3f}) ms an iteration; the timed steps "
        f"{timed['step_ms_min']:.3f}-{timed['step_ms_max']:.3f}, p50 "
        f"{timed['step_ms_p50']:.3f}, mean "
        f"{wall_ms:.3f}; replayed under the profiler: device busy "
        f"{busy_ms:.3f} ms a step of the timed mean {wall_ms:.3f} ms: busy "
        f"share {busy_ms / wall_ms:.4f} ({len(dev)} device activities) "
        f"({card})")
    return {k: float(np.median(v)) for k, v in stages.items()}, \
        busy_ms / wall_ms


def check_mesh(card: str, dev: torch.device) -> dict:
    """The asset pipeline and the interactive frontend on the card: the
    procedural town (``bench/meshes.py``) parsed natively and in python, its
    conversion at 512 against the numpy pipeline, at 2048 cold and steady
    (``bench/harness.run_convert``), the int64 cascade on a white block, and
    ``InteractiveSession`` over the converted world at 320x180 and
    1920x1080, kernels against the plain path, then timed; the mesh path's
    kernel counts are set to 0 just before the 1080p timed steps and read
    after."""
    from cpuvox_tpu_torch.assets import native, voxelizer
    from cpuvox_tpu_torch.assets.mesh import SimpleMesh, rescale
    from cpuvox_tpu_torch.assets.obj import _import_obj_python, import_obj
    from cpuvox_tpu_torch.assets.pipeline import convert_obj_to_world
    from cpuvox_tpu_torch.bench import harness
    from cpuvox_tpu_torch.frontend.interactive import InteractiveSession
    from cpuvox_tpu_torch.ops import march_loop
    from cpuvox_tpu_torch.utils.profiling import FrameProfiler
    from cpuvox_tpu_torch.world import rle_device, save

    # (a) the parser: voxio built with g++, native == python, every array
    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("the native .obj parser (csrc/voxio.cpp) did "
                             "not build")
    t_build = time.perf_counter() - t0
    path = harness.town_obj(log=log)
    t0 = time.perf_counter()
    a = import_obj(path)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    b = _import_obj_python(path)
    t_python = time.perf_counter() - t0
    for f in ("positions", "colors", "uvs", "material_index"):
        x, y = getattr(a, f), getattr(b, f)
        if x.dtype != y.dtype or not np.array_equal(x, y):
            raise AssertionError(f"[mesh] (a) {f}: native != python")
    if a.materials or b.materials:
        raise AssertionError("[mesh] (a) the town has no materials")
    log(f"[mesh] (a) voxio built with g++ in {t_build:.1f} s; the town "
        f"({a.triangle_count} triangles) parsed natively in {t_native:.3f} s "
        f"== by the python parser ({t_python:.3f} s), all 4 arrays")

    # (c) first, so that its cold conversion is the mesh path's first in the
    # process: the 2048 conversion, cold and steady, each stage synced
    calls = (voxelizer.device_calls, voxelizer.host_calls)
    conv, lods = harness.run_convert(path, MESH_MAX_DIM, MESH_LOD_LEVELS,
                                     device=dev, log=log)
    if (voxelizer.device_calls - calls[0], voxelizer.host_calls - calls[1]) \
            != (2, 0):
        raise AssertionError("[mesh] (c) the conversion did not run the "
                             "device voxelizer")

    # (b) the whole pipeline at 512 on the card == the numpy pipeline
    t0 = time.perf_counter()
    want = convert_obj_to_world(path, MESH_CHECK_DIM,
                                lod_levels=MESH_LOD_LEVELS, device=None)
    t_numpy = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = convert_obj_to_world(path, MESH_CHECK_DIM,
                               lod_levels=MESH_LOD_LEVELS, device=dev)
    t_card = time.perf_counter() - t0
    compare_worlds("[mesh] (b) card pipeline", got, want)
    mesh = import_obj(path)
    dims = rescale(mesh, MESH_CHECK_DIM)
    soup = voxelizer.voxelize_mesh_device(mesh, dims, device=dev,
                                          return_device=True)
    compare_worlds("[mesh] (b) cascade off", rle_device.build_lod_chain_device(
        *soup, dims, MESH_LOD_LEVELS, cascade=False), want)
    log(f"[mesh] (b) the town at max_dimension {MESH_CHECK_DIM} {dims}, "
        f"{want[0].voxel_count} LOD0 voxels: the card's pipeline "
        f"({t_card:.2f} s) == the numpy pipeline ({t_numpy:.2f} s) in "
        f"all 7 fields of all {MESH_LOD_LEVELS} LODs, and so is the card's "
        "chain with cascade=False")
    del got, want, soup

    # (c) the 2048 world: valid, the eighth's soup, the numbers
    world_path = os.path.join(harness.CACHE_DIR, f"town{MESH_MAX_DIM}.world")
    save.save_world(world_path, lods)
    validator = validate_in_child(world_path)
    try:
        mesh = import_obj(path)
        dims = rescale(mesh, MESH_MAX_DIM)
        n_cand = voxelizer.triangle_tables(mesh, dims, dev)["total"]
        n_tris = mesh.triangle_count
        pick = np.sort(np.random.default_rng(8).choice(n_tris, n_tris // 8,
                                                       replace=False))
        rows = (pick[:, None] * 3 + np.arange(3)).ravel()
        eighth = SimpleMesh(positions=mesh.positions[rows],
                            colors=mesh.colors[rows], uvs=mesh.uvs[rows],
                            material_index=mesh.material_index[rows])
        t0 = time.perf_counter()
        want = voxelizer.voxelize_mesh(eighth, dims)
        t_numpy = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = voxelizer.voxelize_mesh_device(eighth, dims, device=dev)
        t_card = time.perf_counter() - t0
        for k, (x, y) in enumerate(zip((*want[:2], *want[2]),
                                       (*got[:2], *got[2]))):
            if x.dtype != y.dtype or not np.array_equal(x, y):
                raise AssertionError(f"[mesh] (c) the eighth's soup, array "
                                     f"{k}: card != numpy")
        cand = voxelizer.triangle_tables(eighth, dims, dev)["total"]
        stages = conv["stages_steady"]
        log(f"[mesh] (c) the town at max_dimension {MESH_MAX_DIM} "
            f"{tuple(dims)}: {conv['lod0_voxels']} LOD0 voxels, max_runs "
            f"{conv['max_runs']}, empty_frac {conv['empty_frac']:.4f}; "
            f"converted on the card {conv['seconds_cold']:.3f} s cold "
            f"(before (b)), "
            f"{conv['seconds_steady']:.3f} s steady ("
            + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
            + f" s), {conv['voxels_per_sec']:.0f} LOD0 voxels a second; "
            f"{n_cand} voxelizer candidates, "
            f"{n_cand / stages['voxelize']:.0f} a second in the steady "
            f"voxelize stage ({card})")
        log(f"[mesh] (c) a seeded eighth of the triangles ({len(pick)}, "
            f"{cand} candidates, {want[0].shape[0]} voxels): the card's soup "
            f"({t_card:.3f} s, {cand / t_card:.0f} candidates a second) == "
            f"voxelize_mesh ({t_numpy:.2f} s), values and order")
        del mesh, eighth, want, got

        # (d) the int64 cascade: a solid white 256^3 block at lod_levels 9,
        # whose LOD 8 red sum 255 * 2^24 passes 2^31
        n = MESH_BLOCK
        ar = torch.arange(n, device=dev)
        x, z, y = torch.meshgrid(ar, ar, ar, indexing="ij")
        white = torch.full((n ** 3,), 0xFFFFFF, dtype=torch.int64, device=dev)
        t0 = time.perf_counter()
        block = rle_device.build_lod_chain_device(
            (x * n + z).reshape(-1), y.reshape(-1), white, None, (n, n, n),
            MESH_BLOCK_LODS)
        t_block = time.perf_counter() - t0
        for w in block:
            if w.voxel_count != (n >> w.lod) ** 3 or \
                    not (w.colors == np.uint32(0xFFFFFFFF)).all():
                raise AssertionError(f"[mesh] (d) LOD {w.lod} of the white "
                                     "block is not all white")
        top = block[-1]
        log(f"[mesh] (d) a solid white {n}^3 block at lod_levels "
            f"{MESH_BLOCK_LODS} ({t_block:.2f} s): every LOD all white, LOD "
            f"{top.lod} {top.voxel_count} voxel(s) (red sum 255 * "
            f"{(1 << top.lod) ** 3} = {255 * (1 << top.lod) ** 3}, carried in "
            "int64)")
        del x, z, y, white, block

        # (e) InteractiveSession over the 2048 world: kernels == plain, then
        # timed (the validator child is waited for first)
        whs = (SMALL_WH, MAIN_WH)
        inputs = harness.WARMUP_INPUTS + harness.interactive_inputs()
        sessions = harness.interactive_sessions(lods, whs, device=dev)
        renderers = [s.renderer for s in sessions]
        for (w, h), s in zip(whs, sessions):
            if not s.renderer.occupancy_on:
                raise AssertionError("[mesh] (e) the town's gate resolved off")
            plain = dataclasses.replace(s, renderer=dataclasses.replace(
                s.renderer, config=dataclasses.replace(s.renderer.config,
                                                       backend="xla")),
                look=dataclasses.replace(s.look),
                fly=dataclasses.replace(s.fly), frame_times=[])
            k = MESH_PLAIN_STEPS[(w, h)]
            for kw in inputs[:k]:
                got, want = s.step(1 / 30, **kw), plain.step(1 / 30, **kw)
                compare(f"mesh {w}x{h} step",
                        [torch.from_numpy(got.view(np.int32))],
                        [torch.from_numpy(want.view(np.int32))], {})
                if (got == np.uint32(0xFFFF1493)).any():
                    raise AssertionError(f"[mesh] (e) magenta at {w}x{h}")
            line = (f"[mesh] (e) {w}x{h}: the first {k} step(s) through the "
                    f"kernels == the plain session's (plain "
                    f"{plain.frame_times[0]:.2f} s a frame), 0 pixels differ, "
                    "0 magenta")
            if (w, h) == SMALL_WH:
                for mode in (2, 3):
                    got = s.step(0.0, mode=mode)
                    want = plain.step(0.0, mode=mode)
                    compare(f"mesh mode {mode}", [torch.from_numpy(
                        got.view(np.int32))], [torch.from_numpy(
                            want.view(np.int32))], {})
                line += "; render modes 2 and 3 (the raybuffers) == plain"
            log(line)
            del plain, s
        finish_validation(validator)
    finally:
        if validator.poll() is None:  # a check above failed
            validator.kill()
            validator.communicate()

    sessions = [InteractiveSession.create(None, renderer=dataclasses.replace(
        r, lod_distances=None)) for r in renderers]
    metrics = harness.run_interactive(None, whs=whs[:1], sessions=sessions[:1],
                                      log=log)
    replays = [copy_session(sessions[1]) for _ in range(2)]
    march_loop.reset_launches()
    metrics.update(harness.run_interactive(None, whs=whs[1:],
                                           sessions=sessions[1:], log=log))
    launches = march_loop.kernel_launches()
    if min(launches[k_[0]] for k_ in KERNELS) <= 0:
        raise AssertionError(f"[mesh] (e) launches {launches}: a kernel of "
                             "the path did not run")
    for wh, m in metrics.items():
        if m["magenta_pixels"] or not m["gate"]:
            raise AssertionError(f"[mesh] (e) {wh}: {m['magenta_pixels']} "
                                 f"magenta pixels, gate {m['gate']}")
        per = m["launches_per_step"]
        log(f"[mesh] (e) interactive {wh}, {m['n_steps']} steps: step p50 "
            f"{m['step_ms_p50']:.3f} ms, {m['fps']:.3f} fps; launches a step: "
            f"roll {per['roll_chunk']:.1f}, rasterize "
            f"{per['rasterize_visits']:.1f}, phase 2 "
            f"{per['reproject_screen']:.1f} ({card})")

    # (f) where the 1080p steps' time goes: the same steps from the same
    # state, each stage synced, then under the profiler
    m = metrics[f"{MAIN_WH[0]}x{MAIN_WH[1]}"]
    m["split_ms"], m["busy_share"] = split_steps(replays, m, card)

    # FrameProfiler: events around more of the same steps
    prof = FrameProfiler(dev)
    for (w, h), s in zip(whs, sessions):
        for kw in harness.interactive_inputs(8):
            with prof.scope(f"step {w}x{h}"):
                s.step(1 / 30, **kw)
    log("[mesh] (f) FrameProfiler (CUDA events around 8 more steps each, "
        "the flight going on past the timed steps):\n"
        + prof.report())
    return {"convert": conv, "interactive": metrics, "launches": launches}


# ------------------------------------------------------------- the shards

# the world shard's tile side, and the LOD0 radius that makes its window a
# strict subset of a 2048 grid's 8 x 8 tiles: 2 * ceil(302 / 256) + 1 = 5
SHARD_TILE_COLS = 256
SHARD_LOD0_RADIUS = 300.0
N_SHARDS = 4  # the shards of one card
# path cameras: outside the world looking up, inside level, inside down
SHARD_PATH_T = (0.3, 0.5, 0.9)
SHARD_ROLLOUT_STEPS = 4


def shard_counts_run(tally: dict, fn):
    """``fn()`` with the kernels' launch counts set to 0 just before it and
    added to ``tally`` just after it."""
    from cpuvox_tpu_torch.ops import march_loop

    march_loop.reset_launches()
    out = fn()
    for k, v in march_loop.kernel_launches().items():
        tally[k] = tally.get(k, 0) + v
    return out


@contextlib.contextmanager
def held_against_plain(stats: dict, held: dict):
    """Within the block the four kernels' wrappers are held against their
    plain versions on copies of the same inputs, at the shapes the caller
    gives them (a shard's slice of the rays, the gathered raybuffer, a
    camera block), into ``stats`` under the kernel's name: every phase-2
    call, and of each march (a ``raymarch.phase1`` call: one a shard or
    camera block) the first roll and rasterizer call at full width and the
    first on a live-ray index (a plain rasterizer call takes 0.4-1.8 s
    at 1080p).  ``held`` collects, by kernel, the calls held, the rays of
    the state each was given (a call may work on a live-ray index of them)
    and the marches they came from.  The wrapper's own launch is the
    caller's; the plain version launches nothing."""
    from cpuvox_tpu_torch.bench.capture import clone
    from cpuvox_tpu_torch.ops import phase1_kernel, roll_kernel
    from cpuvox_tpu_torch.ops import reproject_kernel as rk
    from cpuvox_tpu_torch.render import raymarch

    orig = {"phase1": (raymarch, raymarch.phase1),
            "roll_chunk": (roll_kernel, roll_kernel.roll_chunk),
            "rasterize_visits": (phase1_kernel,
                                 phase1_kernel.rasterize_visits),
            "reproject_screen": (rk, rk.reproject_screen),
            "reproject_screens": (rk, rk.reproject_screens)}

    def note(name, rays, march=None):
        h = held.setdefault(name, {"calls": 0, "rays": set(),
                                   "marches": set()})
        h["calls"] += 1
        h["rays"].add(int(rays))
        if march is not None:
            h["marches"].add(march)

    marches = [0]  # phase1 calls so far
    first: set = set()

    def phase1(*a, **kw):
        marches[0] += 1
        return orig["phase1"][1](*a, **kw)

    def is_first(name, index) -> bool:
        key = (name, marches[0], index is None)
        new = key not in first
        first.add(key)
        return new

    def roll(dda, alive, *rest, **kw):
        if not is_first("roll_chunk", kw.get("index")):
            return orig["roll_chunk"][1](dda, alive, *rest, **kw)
        want = roll_kernel.roll_chunk_ref(clone(dda), alive.clone(), *rest,
                                          **kw)
        got = orig["roll_chunk"][1](dda, alive, *rest, **kw)
        compare("roll_chunk", [*got[0], got[1], got[2]],
                [*want[0], want[1], want[2]], stats)
        note("roll_chunk", dda.pos.shape[0], marches[0])
        return got

    def raster(rs, *rest, **kw):
        if not is_first("rasterize_visits", kw.get("index")):
            return orig["rasterize_visits"][1](rs, *rest, **kw)
        want = phase1_kernel.rasterize_visits_ref(clone(rs), *rest, **kw)
        got = orig["rasterize_visits"][1](rs, *rest, **kw)
        compare("rasterize_visits", got, want, stats)
        note("rasterize_visits", rs.raybuf.shape[0], marches[0])
        return got

    def phase2(name, ref):
        def fn(raybuf, *rest):
            got = orig[name][1](raybuf, *rest)
            compare(name, [got], [ref(raybuf, *rest)], stats)
            note(name, raybuf.shape[0])
            return got
        return fn

    spies = {"phase1": phase1, "roll_chunk": roll,
             "rasterize_visits": raster,
             "reproject_screen": phase2("reproject_screen",
                                        rk.reproject_screen_ref),
             "reproject_screens": phase2("reproject_screens",
                                         rk.reproject_screens_ref)}
    for name, (mod, _fn) in orig.items():
        setattr(mod, name, spies[name])
    try:
        yield held
    finally:
        for name, (mod, fn) in orig.items():
            setattr(mod, name, fn)


def held_txt(held: dict) -> str:
    """``held_against_plain``'s calls and ray counts, kernel by kernel."""
    return "; ".join(
        f"{k} {v['calls']} calls on {sorted(v['rays'])} rays"
        + (f" in {len(v['marches'])} marches" if v["marches"] else "")
        for k, v in sorted(held.items()))


def held_run(tag: str, fn, stats: dict):
    """``fn()`` (one sharded run, not counted) with its kernel calls held
    against their plain versions (``held_against_plain``); logs what was
    held and returns ``fn``'s result."""
    t0 = time.perf_counter()
    with held_against_plain(stats, {}) as held:
        out = fn()
    if not ({"roll_chunk", "rasterize_visits"} <= held.keys()
            and held.keys() & {"reproject_screen", "reproject_screens"}):
        raise AssertionError(f"[shard] {tag}: a kernel of the path was not "
                             f"held against its plain version ({held})")
    log(f"[shard] {tag}: the kernels == their plain versions on the same "
        f"inputs, 0 elements differ ({held_txt(held)}; "
        f"{time.perf_counter() - t0:.1f} s with the plain calls)")
    return out


def compare_screens(name: str, got, want, stats: dict) -> None:
    """Screens ((H, W) uint32 numpy or int32 tensors) bit for bit."""
    def t(x):
        return (torch.from_numpy(np.ascontiguousarray(x).view(np.int32))
                if isinstance(x, np.ndarray) else x.cpu())

    compare(name, [t(g) for g in got], [t(w) for w in want], stats)


def with_lod0(renderer, r0):
    """A Renderer over the same world tables with ``lod_distances[0]`` set
    to ``r0`` (None: as resolved)."""
    ld = renderer.lod_distances.copy()
    if r0 is not None:
        ld[0] = r0
    return dataclasses.replace(renderer, lod_distances=ld)


def check_world_shard(tag: str, lods, plain, devices, where: str,
                      tally: dict, stats: dict) -> dict:
    """``ShardedRenderer`` over ``devices`` at the default LOD0 radius and
    at ``SHARD_LOD0_RADIUS`` (a strict-subset window): three path cameras
    each, screens == the unsharded Renderer's, the window, the exchanges and
    their bytes; one more frame with its kernel calls held against their
    plain versions; then (f) the rasterizer on a capture of the active window
    against its plain version.  Returns the sharded renderer."""
    from cpuvox_tpu_torch.bench.capture import capture
    from cpuvox_tpu_torch.parallel import ShardedRenderer

    t0 = time.perf_counter()
    sr = ShardedRenderer(lods, devices, plain.config,
                         tile_cols=SHARD_TILE_COLS)
    sr.inner.compact = plain.compact  # march as the unsharded Renderer
    sw = sr.sw
    t_build = time.perf_counter() - t0
    cams = [path_camera(plain, t) for t in SHARD_PATH_T]
    for label, r0 in (("default radius", None),
                      ("strict subset", SHARD_LOD0_RADIUS)):
        ref = with_lod0(plain, r0)
        sr.inner.lod_distances = ref.lod_distances.copy()
        sr.inner.far_clip = ref.far_clip
        n0, b0 = sr._n_exchanges, sr._exchange_bytes
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = shard_counts_run(tally, lambda: [sr.render(c) for c in cams])
        t_frames = time.perf_counter() - t0
        compare_screens(f"[shard] {tag} {label}", got,
                        [ref.render(c) for c in cams], stats)
        w = sr._window_key[2]
        strict = w < max(sw.nt_x, sw.nt_z)
        if r0 is not None and not strict:
            raise AssertionError(f"[shard] {tag}: the window {w} is not a "
                                 f"strict subset of {sw.nt_x}x{sw.nt_z} tiles")
        log(f"[shard] ({'a' if tag == 'terrain2048' else 'b'}) {tag} "
            f"{MAIN_WH[0]}x{MAIN_WH[1]} over {where}, tiles of "
            f"{SHARD_TILE_COLS} columns ({sw.nt_x}x{sw.nt_z} tiles, built in "
            f"{t_build:.1f} s), {label} (lod_distances[0] "
            f"{ref.lod_distances[0]:.0f}): window W {w} "
            f"({'a strict subset' if strict else 'covers the grid'}; last "
            f"corner {sr._window_key[:2]}), {len(cams)} path cameras == the "
            f"unsharded Renderer, 0 pixels differ; "
            f"{sr._n_exchanges - n0} exchanges, "
            f"{sr._exchange_bytes - b0} bytes gathered, "
            f"{t_frames * 1e3:.1f} ms for the {len(cams)} frames with their "
            f"exchanges ({card_line()})")
    held_run(f"{tag} strict subset, {cams[-1].position}",
             lambda: sr.render(cams[-1]), stats)
    # (f) the rasterizer on the first chunk of a camera inside the world,
    # its window active: the cells it reads at LOD0 go through the window
    for k, cam in ((k, c) for c in cams[::-1] for k in (0, 1)):
        sr._activate(*sr._window(sr.inner.setup_camera(cam)[0]))
        cap = capture(sr.inner, cam, k, compact=False)
        if cap.gated:
            lod0, valid = cap.src.rows[..., 3] == 0, cap.src.proc
        else:
            lod0, valid = cap.src[:, 4] == 0, cap.src[:, 5] != 0
        n_lod0 = int((lod0 & valid).sum())
        if n_lod0:
            break
    else:
        raise AssertionError(f"[shard] {tag}: no capture holds a LOD0 cell")
    _want, written = raster_both(cap, stats)
    log(f"[shard] (f) {tag}: rasterize_visits with the window "
        f"{sr.inner._wa.win} (the "
        f"{'gated group' if cap.gated else 'dense chunk'} after {k} "
        f"iterations, {n_lod0} valid LOD0 cells, {written} texels written) "
        f"== plain, and the previous design on the same cells == plain, 0 "
        f"elements differ")
    return sr


def time_turns(fns: dict, reps_each: int) -> dict:
    """Each function's host times in ms, synced, in turns a, b, b, a."""
    names = list(fns)
    order = names + names[::-1]
    ms = {n: [] for n in names}
    def sync():  # every card a sharded run may have used
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)

    for _ in range(reps_each):
        for n in order:
            sync()
            t0 = time.perf_counter()
            fns[n]()
            sync()
            ms[n].append((time.perf_counter() - t0) * 1e3)
    return ms


def check_ray_sharded(tag: str, plain, rmesh, where: str, tally: dict,
                      stats: dict) -> None:
    """(c) ``render_frame_sharded`` over ``rmesh`` on three path cameras ==
    the unsharded frame; launches a frame of each kernel; one more frame
    with its kernel calls (each shard's roll and rasterizer, phase 2 on the
    gathered raybuffer) held against their plain versions; frame ms sharded
    and unsharded, in turns."""
    from cpuvox_tpu_torch.parallel.mesh import render_frame_sharded

    cams = [path_camera(plain, t) for t in SHARD_PATH_T]
    own: dict = {}
    got = shard_counts_run(own, lambda: [
        render_frame_sharded(plain, c, rmesh) for c in cams])
    for k, v in own.items():
        tally[k] = tally.get(k, 0) + v
    compare_screens(f"[shard] {tag} ray-sharded", got,
                    [plain.render(c) for c in cams], stats)
    held_run(f"(c) {tag} ray-sharded over {where}",
             lambda: render_frame_sharded(plain, cams[1], rmesh), stats)
    per_frame = {k: v / len(cams) for k, v in own.items()}
    ms = {"unsharded": [], "sharded": []}
    for c in cams:
        m = time_turns({"unsharded": lambda: plain.render(c),
                        "sharded": lambda: render_frame_sharded(
                            plain, c, rmesh)}, 1)
        for k in ms:
            ms[k] += m[k]
    med = {k: float(np.median(v)) for k, v in ms.items()}
    log(f"[shard] (c) {tag} {MAIN_WH[0]}x{MAIN_WH[1]}, one camera's rays "
        f"over {where} ({rmesh.n_ray_shards} shards): {len(cams)} path "
        f"cameras == the unsharded frame, 0 pixels differ; a frame "
        f"launches roll {per_frame['roll_chunk']:.1f}, rasterize "
        f"{per_frame['rasterize_visits']:.1f}, phase 2 "
        f"{per_frame['reproject_screen']:.1f}; frame ms in turns (median of "
        f"{len(ms['sharded'])}): sharded {med['sharded']:.3f}, unsharded "
        f"{med['unsharded']:.3f} (all sharded {np.round(ms['sharded'], 3).tolist()}, "
        f"unsharded {np.round(ms['unsharded'], 3).tolist()}) ({card_line()})")


def check_camera_sharded(rmesh, where: str, tally: dict, stats: dict) -> None:
    """(e) the rollout's 64 cameras at 256x256 over ``rmesh``: the batch ==
    the unsharded batch, then once more with its kernel calls (each camera
    block's march and phase 2) held against their plain versions, and
    cams/s both ways in turns."""
    from cpuvox_tpu_torch.bench import harness
    from cpuvox_tpu_torch.parallel.batch import render_camera_batch

    r = harness.rollout_renderer(ROLLOUT_WH)
    dims = r.device_world.dims
    cams = harness.rollout_cameras(1, N_ROLLOUT_CAMS, ROLLOUT_WH, dims)
    got = shard_counts_run(tally, lambda: render_camera_batch(r, cams,
                                                              rmesh=rmesh))
    compare_screens("[shard] rollout camera-sharded", [got],
                    [render_camera_batch(r, cams)], stats)
    held_run(f"(e) rollout camera-sharded over {where}",
             lambda: render_camera_batch(r, cams, rmesh=rmesh), stats)
    steps = [harness.rollout_cameras(2 + s, N_ROLLOUT_CAMS, ROLLOUT_WH, dims)
             for s in range(SHARD_ROLLOUT_STEPS)]

    def run(mesh):
        for st in steps:
            render_camera_batch(r, st, rmesh=mesh)

    ms = time_turns({"unsharded": lambda: run(None),
                     "sharded": lambda: run(rmesh)}, 1)
    n = N_ROLLOUT_CAMS * SHARD_ROLLOUT_STEPS
    cps = {k: [n / (t / 1e3) for t in v] for k, v in ms.items()}
    log(f"[shard] (e) rollout{N_ROLLOUT_CAMS} {ROLLOUT_WH[0]}x"
        f"{ROLLOUT_WH[1]} over {where}: the camera-sharded batch == the "
        f"unsharded batch, 0 pixels differ; cams/s in turns ({n} cameras "
        f"a run): sharded {np.round(cps['sharded'], 2).tolist()}, unsharded "
        f"{np.round(cps['unsharded'], 2).tolist()} ({card_line()})")


def check_shard(card: str, stats: dict, terrain, terrain_lods, layered,
                layered_lods) -> dict:
    """The multi-device renderer (``parallel/``) on the card, its shards
    ``N_SHARDS`` repeats of it: (a) terrain2048 and (b) layered2048 world
    sharded at the default LOD0 radius and with a strict-subset window, (f)
    the rasterizer's window on a capture of each, (c) the ray-sharded frame
    on both, (d) the composed mode, one frame each, (e) the camera-sharded
    rollout.  Every screen == the unsharded Renderer's, and in one more run
    of each the kernel calls == their plain versions.  The launch counts
    of the sharded runs (not of their comparisons) are the ``shard``
    path's, returned by kernel.  With more than one card, (a), (c) and (e)
    again over the real cards."""
    from cpuvox_tpu_torch.parallel import RenderMesh

    tally: dict = {}
    dev = terrain.device
    one = [dev] * N_SHARDS
    where = f"{N_SHARDS} shards of {dev}"
    worlds = (("terrain2048", terrain_lods, terrain),
              ("layered2048", layered_lods, layered))
    sharded = {tag: check_world_shard(tag, lods, plain, one, where, tally,
                                      stats)
               for tag, lods, plain in worlds}
    rmesh = RenderMesh.create(one)
    for tag, _lods, plain in worlds:
        check_ray_sharded(tag, plain, rmesh, where, tally, stats)
    # (d) composed: the strict-subset window, one camera's rays over rmesh
    for tag, _lods, plain in worlds:
        sr = sharded.pop(tag)
        sr.ray_mesh = rmesh
        ref = with_lod0(plain, SHARD_LOD0_RADIUS)
        sr.inner.lod_distances = ref.lod_distances.copy()
        cam = path_camera(plain, SHARD_PATH_T[1])
        got = shard_counts_run(tally, lambda: sr.render(cam))
        compare_screens(f"[shard] {tag} composed", [got], [ref.render(cam)],
                        stats)
        held_run(f"(d) {tag} composed", lambda: sr.render(cam), stats)
        log(f"[shard] (d) {tag} composed: LOD0 over {where} (window "
            f"{sr._window_key}) and the camera's rays over the same "
            f"{rmesh.n_ray_shards}: one frame == the unsharded Renderer, 0 "
            "pixels differ")
        del sr
    check_camera_sharded(rmesh, where, tally, stats)
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        cards = [torch.device("cuda", i) for i in range(n_cards)]
        where = f"{n_cards} cards"
        real = RenderMesh.create(cards)
        check_world_shard("terrain2048", terrain_lods, terrain, cards, where,
                          {}, stats)
        for tag, _lods, plain in worlds:
            check_ray_sharded(tag, plain, real, where, {}, stats)
        check_camera_sharded(real, where, {}, stats)
    else:
        log(f"[shard] one card ({card}): (a), (c) and (e) did not run "
            "over several cards")
    if min(tally.get(k, 0) for k in ("roll_chunk", "rasterize_visits",
                                      "reproject_screen",
                                      "reproject_screens")) <= 0:
        raise AssertionError(f"[shard] launches {tally}: a kernel of the "
                             "path did not run")
    log(f"[shard] launches of the sharded runs: {tally}")
    return tally


def time_ms(fn, reps: int, setup=lambda: None) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events around each call;
    ``setup`` (untimed) prepares each call's inputs."""
    total = 0.0
    for _ in range(reps):
        args = setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn(args)
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def bound(nbytes: float, nops: float):
    """(ms, "bytes" | "operations"): the least time the card could take to
    move ``nbytes`` and do ``nops`` f32/int operations."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = nops / F32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def rays_worked(cap) -> int:
    return cap.dda.pos.shape[0] if cap.index is None else cap.index.shape[0]


def roll_work(cap):
    """Bytes and operations of one roll call over its Rk rays (the live-ray
    index's, read too, or all): the DDA state and alive read and written,
    the directions read, the (C, 13, Rk) visits written; about 40
    integer/f32 operations a step."""
    R, C = rays_worked(cap), cap.chunk
    state = R * (8 * 5 + 4 + 1)  # pos, tmax, tdelta, stp, ids; lod; alive
    index = 0 if cap.index is None else 4 * R
    return 2 * state + R * 8 + index + C * 13 * R * 4, 40 * C * R


def raster_work(cap, written: int):
    """Bytes and operations one call of the group rasterizer needs on this
    data: each slot's cell input (the six visit fields the kernel reads, or
    a packed row and its proc flag); each valid cell's record words as
    stored (the meta words, then n_runs run words, two to a word where the
    runs are 16-bit packed); the static planes; the 8 state fields read and
    written; each texel it writes; in ARGB mode one color word read for each
    texel written (the kernel loads a cell's color word only where it writes
    one); the live-ray index.  R is the rays the call works on.  About 200
    operations a valid cell, 30 a run of a valid cell and 10 a texel."""
    from cpuvox_tpu_torch.render import device as world_device
    from cpuvox_tpu_torch.render.raymarch import PackedCells

    cells, wa = cap.cells, cap.wa
    C, R, _maxr = cells.runs.shape
    state = R * (6 * 4 + 2)
    slots = C * R * (17 if isinstance(cap.src, PackedCells) else 24)
    n_runs = torch.where(cells.valid, cells.n_runs, 0)
    valid = int(cells.valid.sum())
    runs = int(n_runs.sum())
    if wa.rec_fwd is None:  # split: 5 meta words, int32 runs
        meta, run_words = 5, runs
    else:
        meta = world_device.REC_META
        packed = world_device.packed_run_words(
            wa.max_runs, wa.max_col_colors) != wa.max_runs
        run_words = int(((n_runs + 1) // 2).sum()) if packed else runs
    color_reads = 0 if cells.colors is None else 4 * written
    index = 0 if cap.index is None else 4 * R
    return (slots + 4 * (valid * meta + run_words) + R * 36 + 2 * state
            + index + 4 * written + color_reads,
            200 * valid + 30 * runs + 10 * written)


def sample_work(maps):
    """Bytes and operations of the two sample passes: the index and mask
    read and the output written per element, and one raybuffer texel read
    per masked element."""
    nbytes = nops = 0
    for ri, mask in maps:
        n = ri.numel()
        nbytes += 12 * n + 4 * int((mask != 0).sum())
        nops += 4 * n
    return nbytes, nops


def phase2_work(args, maps):
    """Bytes and operations one call of the fused phase-2 kernel needs on
    this data: each distinct raybuffer texel the render pixels sample, in
    index mode each distinct color word they resolve to (the color table
    holds a word a voxel, so it is read where it is needed, not whole), the
    (H, W) screen written; ``PHASE2_OPS_PER_SEGMENT`` for each active
    segment up to a pixel's own (the kernel's scan stops there) and
    ``PHASE2_OPS_PER_PIXEL`` a render pixel."""
    from cpuvox_tpu_torch.render import reproject

    raybuf, tables, rw, rh, width, height, colors, _sky = args
    nbytes, nops = 4 * width * height, 0
    if tables["active"].any():
        R, P = raybuf.shape
        ri, lr = maps[0][0].clamp(0, R - 1).long(), maps[0][1] != 0
        dev = ri.device
        texel = torch.where(lr, torch.arange(rw, device=dev)[None, :],
                            torch.arange(rh, device=dev)[:, None])
        nbytes += 4 * torch.unique(ri * P + texel).numel()
        seg, _ri = reproject.segment_ray_index(tables, rw, rh, dev)
        scanned = sum(int((seg >= s).sum()) for s in range(4)
                      if tables["active"][s])
        nops += (PHASE2_OPS_PER_SEGMENT * scanned
                 + PHASE2_OPS_PER_PIXEL * rw * rh)
    if colors is not None:
        idx = reproject.reproject(raybuf, tables, rw, rh, kernels=False)
        idx = idx[idx >= 0].clamp(max=colors.shape[0] - 1)
        nbytes += 4 * torch.unique(idx).numel()
    return nbytes, nops


def device_ms(fn, setup, reps: int) -> float:
    """The card's own time of one call of ``fn``, in ms, without the host's
    launch overhead that CUDA events around one Python call hold: the card
    is first kept busy (``torch.cuda._sleep``) while the host queues ``reps``
    calls on inputs prepared beforehand, so they run back to back; events
    after the wait and after the last call span them."""
    inputs = [setup() for _ in range(reps)]
    before, start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(3))
    torch.cuda.synchronize()
    before.record()
    torch.cuda._sleep(40_000_000)  # some 20 ms of device cycles
    start.record()
    t0 = time.perf_counter()
    for args in inputs:
        fn(args)
    end.record()
    queued_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    wait_ms = before.elapsed_time(start)
    if queued_ms >= wait_ms:
        raise AssertionError(f"the host took {queued_ms:.2f} ms to queue "
                             f"{reps} calls, the card waited {wait_ms:.2f} ms")
    return start.elapsed_time(end) / reps


def time_kernels(caps: dict) -> dict:
    """Each kernel's time at a path's shapes: kernel (per Python call by
    CUDA events, and the device's own time a launch, ``device_ms``), plain
    version, bound and the PyTorch calls that compute the same function
    where there are any.  Beside each, on the same inputs, its previous
    design: the roll's (``bench/roll_variants.PREVIOUS_DESIGN``, built into
    ``caps["roll_previous"]``); the rasterizer's (``rasterize_chunk``), the
    torch column fetch that feeds it (``raymarch.fetch_cells``), and the two
    as the march ran them; phase 2's, the two-pass sample on the maps torch
    computes, and the whole torch phase 2 around it as the frame ran it."""
    from cpuvox_tpu_torch.bench.capture import clone
    from cpuvox_tpu_torch.bench.variants import use
    from cpuvox_tpu_torch.ops import _build, phase1_kernel, reproject_kernel
    from cpuvox_tpu_torch.ops import roll_kernel
    from cpuvox_tpu_torch.render import raymarch

    rcap = caps["roll"]
    roll_rest = (rcap.frame.static.dirs, rcap.lod_distances, rcap.far,
                 caps["dims"], rcap.chunk)
    roll_kw = {"index": rcap.index}
    xcap, written = caps["raster"]
    direction = xcap.frame.iteration_direction
    rargs = (xcap.frame.static, xcap.consts, direction)
    raster_kw = {"index": xcap.index}
    p2args, maps = caps["phase2"]
    raybuf = p2args[0]
    maps_long = [(ri.long(), mask != 0) for ri, mask in maps]

    def gather_where(_):
        return [torch.where(m, torch.gather(raybuf, 0, ri), -1)
                for ri, m in maps_long]

    def roll(a):
        return roll_kernel.roll_chunk(*a, *roll_rest, **roll_kw)

    def roll_setup():
        return clone(rcap.dda), rcap.alive.clone()

    plain_reps = caps.get("plain_reps", 2)
    out = {}
    for name, kern, plain, library, setup, reps, work, rays in (
            ("roll_chunk", roll,
             lambda a: roll_kernel.roll_chunk_ref(*a, *roll_rest, **roll_kw),
             None, roll_setup, (20, plain_reps), roll_work(rcap),
             rays_worked(rcap)),
            ("rasterize_visits",
             lambda rs: phase1_kernel.rasterize_visits(
                 rs, xcap.wa, xcap.src, *rargs, **raster_kw),
             lambda rs: phase1_kernel.rasterize_visits_ref(
                 rs, xcap.wa, xcap.src, *rargs, **raster_kw), None,
             lambda: clone(xcap.rs), (10, 1), raster_work(xcap, written),
             rays_worked(xcap)),
            ("reproject_screen",
             lambda _: reproject_kernel.reproject_screen(*p2args),
             lambda _: reproject_kernel.reproject_screen_ref(*p2args),
             gather_where, lambda: None, (50, 10), phase2_work(p2args, maps),
             raybuf.shape[0])):
        time_ms(kern, 2, setup)  # warm
        ms = time_ms(kern, reps[0], setup)
        dev_ms = device_ms(kern, setup, 10)
        plain_ms = time_ms(plain, reps[1], setup)
        library_ms = library_dev_ms = None
        if library is not None:
            time_ms(library, 2)
            library_ms = time_ms(library, reps[0])
            library_dev_ms = device_ms(library, setup, 10)
        b_ms, b_by = bound(*work)
        out[name] = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                     "library_ms": library_ms,
                     "library_device_ms": library_dev_ms, "rays": rays,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "bytes": int(work[0]), "operations": int(work[1])}

    # the roll's previous design, built from csrc/roll.cu with its earlier
    # constants, on the same inputs (held against the plain version first)
    use(caps["roll_previous"])
    try:
        got = roll(roll_setup())
        want = roll_kernel.roll_chunk_ref(*roll_setup(), *roll_rest,
                                          **roll_kw)
        compare("roll_chunk previous design", [*got[0], got[1], got[2]],
                [*want[0], want[1], want[2]], {})
        time_ms(roll, 2, roll_setup)  # warm
        prev = {"name": "roll_chunk, previous design",
                "kernel_ms": time_ms(roll, 20, roll_setup),
                "kernel_device_ms": device_ms(roll, roll_setup, 10)}
    finally:
        use(_build.build())
    prev["device_ratio"] = (out["roll_chunk"]["device_ms"]
                            / prev["kernel_device_ms"])
    out["roll_chunk"]["previous_design"] = prev

    # the rasterizer's previous design on the same inputs: its kernel on the
    # fetched cells, the fetch alone, and the two as the march ran them
    def old_kernel(rs):
        phase1_kernel.rasterize_chunk(rs, xcap.cells, *rargs, **raster_kw)

    def fetch(_):
        raymarch.fetch_cells(xcap.wa, xcap.src, direction)

    def old_path(rs):
        phase1_kernel.rasterize_chunk(
            rs, raymarch.fetch_cells(xcap.wa, xcap.src, direction), *rargs,
            **raster_kw)

    prev = {"name": "rasterize_chunk"}
    for key, fn, setup in (("kernel", old_kernel, lambda: clone(xcap.rs)),
                           ("fetch", fetch, lambda: None),
                           ("kernel_and_fetch", old_path,
                            lambda: clone(xcap.rs))):
        time_ms(fn, 2, setup)  # warm
        prev[key + "_ms"] = time_ms(fn, 10, setup)
        prev[key + "_device_ms"] = device_ms(fn, setup, 10)
    prev["device_ratio"] = (out["rasterize_visits"]["device_ms"]
                            / prev["kernel_and_fetch_device_ms"])
    out["rasterize_visits"]["previous_design"] = prev

    # phase 2's previous design: the two sample passes on the maps, and the
    # whole torch phase 2 around them as the frame ran it (its three
    # pageable table copies wait for the card, so only per call)
    def two_passes(_):
        return [reproject_kernel.sample_raybuffer(raybuf, *m) for m in maps]

    def old_phase2(_):
        return reproject_kernel.reproject_screen_two_pass(*p2args)

    time_ms(two_passes, 2)  # warm
    time_ms(old_phase2, 2)
    b_ms, b_by = bound(*sample_work(maps))
    prev = {"name": "sample_raybuffer, two passes",
            "kernel_ms": time_ms(two_passes, 50),
            "kernel_device_ms": device_ms(two_passes, lambda: None, 10),
            "bound_ms": b_ms, "bound_by": b_by,
            "bytes": int(sample_work(maps)[0]),
            "phase2_ms": time_ms(old_phase2, 20)}
    prev["device_ratio"] = (out["reproject_screen"]["device_ms"]
                            / prev["kernel_device_ms"])
    out["reproject_screen"]["previous_design"] = prev
    return out


def resource_usage(lib: str) -> None:
    """Registers, stack and local memory (spills) of each kernel in the
    built library, as ``cuobjdump -res-usage`` reads them."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-res-usage", lib], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    found = re.findall(r"Function (\S+?):\s*\n\s*(REG:.*)", out)
    if len(found) < len(KERNELS):
        raise AssertionError(f"cuobjdump -res-usage listed {len(found)} "
                             f"kernels:\n{out}")
    for fn, usage in found:
        fields = dict(re.findall(r"(\w+):(\d+)", usage))
        short = next((n for n in ["reproject_screens"]
                      + [k[0] for k in KERNELS] if n + "_kernel" in fn), fn)
        log(f"[build] {short}: {fields['REG']} registers, stack "
            f"{fields['STACK']} B, local {fields['LOCAL']} B (spills), "
            f"shared {fields['SHARED']} B")


# each kernel's previous design, as the [time] lines describe it
PREVIOUS_TXT = {
    "roll_chunk": lambda p: (
        f"{p['name']} {p['kernel_device_ms']:.4f} ms on the device, "
        f"{p['kernel_ms']:.4f} ms a call, 0 elements differ from the plain "
        "version"),
    "rasterize_visits": lambda p: (
        f"rasterize_chunk {p['kernel_device_ms']:.4f} ms + torch column "
        f"fetch {p['fetch_device_ms']:.4f} ms on the device (as the march "
        f"ran them {p['kernel_and_fetch_device_ms']:.4f} ms on the device, "
        f"{p['kernel_and_fetch_ms']:.4f} ms a call)"),
    "reproject_screen": lambda p: (
        f"the two sample passes {p['kernel_device_ms']:.4f} ms on the "
        f"device, {p['kernel_ms']:.4f} ms a call (bound {p['bound_ms']:.4f} "
        f"ms, {p['bound_by']}: {p['bytes']} B); the whole torch phase 2 "
        f"around them {p['phase2_ms']:.4f} ms a call"),
}


# phase 13: the benchmark entry's modes, each run as a user runs it: its
# BENCH_* knobs, the metric names it must print (in order), and whether it
# passes the verify gate (the flythrough modes)
BENCH_RUNS = [
    ({"BENCH_SCENE": "terrain2048", "BENCH_FRAMES": "8"},
     ["fps_terrain2048_1920x1080"], True),
    ({"BENCH_SCENE": "layered2048", "BENCH_WH": "320x180",
      "BENCH_FRAMES": "8"}, ["fps_layered2048_320x180"], True),
    ({"BENCH_SCENE": "rollout64"}, ["rollout64_cams_per_sec_256x256"], False),
    ({"BENCH_SCENE": "dynamic512"},
     ["fps_dynamic512_1280x720_rebuild_per_frame"], False),
    ({"BENCH_SCENE": "convert_town2048"},
     ["convert_town2048_seconds_steady_state"], False),
]
BENCH_TIMEOUT_S = 300


def check_bench(card: str) -> list[dict]:
    """Phase 13: ``python -m cpuvox_tpu_torch.bench`` in each mode of
    ``BENCH_RUNS``, a process each (its SIGALRM watchdog needs its own main
    thread), on the worlds the earlier phases cached in ``.bench_cache/``.
    Each must exit 0 and print only JSON lines, the mode's metric names in
    order, every record with ``verify`` absent (the gate passed: its log
    line must read 0 differing pixels and texels), 0 magenta pixels and
    this card's line."""
    records = []
    for env, names, gated in BENCH_RUNS:
        what = " ".join(f"{k}={v}" for k, v in env.items())
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "cpuvox_tpu_torch.bench"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            env={**os.environ, **env}, capture_output=True, text=True,
            timeout=BENCH_TIMEOUT_S)
        seconds = time.perf_counter() - t0
        if r.returncode:
            raise AssertionError(f"[bench] {what}: exit {r.returncode}\n"
                                 f"{r.stdout[-3000:]}\n{r.stderr[-6000:]}")
        recs = []
        for line in r.stdout.splitlines():
            try:
                recs.append(json.loads(line))
            except json.JSONDecodeError:
                raise AssertionError(f"[bench] {what}: a line of standard "
                                     f"output that is not JSON: {line!r}")
        if [rec.get("metric") for rec in recs] != names:
            raise AssertionError(f"[bench] {what}: printed {recs}, not the "
                                 f"metrics {names}")
        gate = ""
        if gated:
            gates = [ln for ln in r.stderr.splitlines()
                     if ln.startswith("backend verify")]
            if len(gates) != 1 or " 0 screen pixels and 0 raybuffer " \
                    "texels differ" not in gates[0]:
                raise AssertionError(f"[bench] {what}: the verify gate did "
                                     f"not pass: {gates}")
            gate = f"; {gates[0]}"
        for rec in recs:
            if "verify" in rec or rec.get("magenta_pixels", 0) \
                    or rec.get("card") != card:
                raise AssertionError(f"[bench] {what}: {rec}")
            if rec["metric"].startswith(("fps_terrain", "fps_layered")) and \
                    not all(isinstance(rec.get(k), float)
                            for k in ("fps_seq", "fps_pipe")):
                raise AssertionError(f"[bench] {what}: the flythrough's "
                                     f"record lacks fps_seq or fps_pipe: {rec}")
        log(f"[bench] {what}: exit 0 in {seconds:.1f} s, {len(recs)} "
            f"record(s), the metric names bench.py prints{gate}")
        for rec in recs:
            log(f"[bench] {json.dumps(rec)} | {card}")
        records += recs
    return records


def shard_only(card: str, dev: torch.device) -> int:
    """Phase 12 alone, on the worlds it needs: the kernels built, then
    terrain2048 and layered2048 at 1920x1080 as ``main`` builds them."""
    from cpuvox_tpu_torch.bench.harness import layered2048, terrain2048
    from cpuvox_tpu_torch.config import RenderConfig
    from cpuvox_tpu_torch.ops import _build
    from cpuvox_tpu_torch.render.frame import Renderer

    t_start = time.perf_counter()
    lib = _build.build()
    _build.library()
    log(f"[build] {len(_build.sources())} sources -> {os.path.relpath(lib)} "
        f"in {time.perf_counter() - t_start:.1f} s")
    cfg = RenderConfig(width=MAIN_WH[0], height=MAIN_WH[1])
    worlds = []
    for build in (terrain2048, layered2048):
        lods = build(log=log)
        r = Renderer.create(lods, cfg, device=dev, compact=True)
        r.render(path_camera(r, 0.0))  # resolves the LOD distances
        worlds += [r, lods]
    stats: dict = {}
    tally = check_shard(card, stats, *worlds)
    held = {k: v for k, v in stats.items() if k in tally}
    log(f"[shard] {json.dumps(held)}")
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all ({card})")
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this check runs only on the card", file=sys.stderr)
        return 2
    shard_alone = sys.argv[1:] == ["--shard-only"]
    if sys.argv[1:] and not shard_alone:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]} (the only one "
              "is --shard-only)", file=sys.stderr)
        return 2
    from cpuvox_tpu_torch.bench import roll_variants
    from cpuvox_tpu_torch.bench.harness import layered2048, terrain2048
    from cpuvox_tpu_torch.config import RenderConfig
    from cpuvox_tpu_torch.ops import _build
    from cpuvox_tpu_torch.render.frame import Renderer

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| python {sys.version.split()[0]}")
    check_card_arithmetic(dev)
    if shard_alone:
        return shard_only(card, dev)
    # layered2048's world (some 55 s of host numpy) builds in a child while
    # the card works on terrain2048; phase 6 loads it from the cache
    layered_build = build_world_in_child("layered2048")

    t0 = time.perf_counter()
    # the roll's previous design, to be timed beside it, builds meanwhile
    prev_roll: dict = {}
    prev_build = threading.Thread(target=lambda: prev_roll.update(
        roll_variants.build(os.path.join(_build.BUILD_DIR, "previous_roll"),
                            [("previous design",
                              roll_variants.PREVIOUS_DESIGN)])))
    prev_build.start()
    lib = _build.build()
    _build.library()
    log(f"[build] {len(_build.sources())} sources, one nvcc each "
        f"({' '.join(_build.COMPILE_FLAGS)}) -> {os.path.relpath(lib)} in "
        f"{time.perf_counter() - t0:.1f} s")
    resource_usage(lib)
    prev_build.join()
    if "previous design" not in prev_roll:
        raise AssertionError("the roll's previous design did not build")
    log(f"[build] the roll's previous design "
        f"({roll_variants.PREVIOUS_DESIGN}) -> "
        f"{os.path.relpath(prev_roll['previous design'])} by "
        f"{time.perf_counter() - t0:.1f} s")
    main_cfg = RenderConfig(width=MAIN_WH[0], height=MAIN_WH[1])

    # ---- terrain2048: the dense march
    t0 = time.perf_counter()
    terrain_lods = terrain2048(log=log)
    # the three main paths march on a live-ray index (compact=True; the
    # Renderer's default is the full-width march, which the small frames and
    # the oracle check run)
    terrain = Renderer.create(terrain_lods, main_cfg, device=dev,
                              compact=True)
    log(f"[terrain] device world up in {time.perf_counter() - t0:.1f} s "
        f"(max_runs {terrain.device_world.max_runs}, "
        f"{terrain.device_world.lod0_voxels} LOD0 voxels, gate "
        f"{'on' if terrain.occupancy_on else 'off'})")
    if terrain.occupancy_on:
        raise AssertionError("terrain2048's gate resolved on")
    stats: dict = {}
    check_device_init(terrain, "terrain", card)
    t_caps = check_terrain_kernels(terrain, stats)
    check_oracle(dev)
    check_small_frame(terrain, "terrain", [
        ("kernels", {}, None, True), ("plain", {"backend": "xla"}, None, True),
        ("kernels, no compaction", {}, None, False),
        ("kernels, device ray init", {"host_init": False}, None, True)],
        stats)
    t_launches, _m, _g = flythrough(terrain, "terrain", card, gated=False)
    t_caps["dims"] = terrain.device_world.dims
    t_caps["roll_previous"] = prev_roll["previous design"]
    t_times = time_kernels(t_caps)
    check_lods_past_8(terrain, stats)
    # [loop]: the default Renderer's march, one graph launch a frame
    loop: dict = {"kernel": check_loop_kernel(terrain, stats)}
    check_loop(dataclasses.replace(terrain, compact=False), "terrain2048",
               card, stats, loop)
    log(f"[terrain] done at {time.perf_counter() - t_start:.1f} s")

    # ---- terrain2048 in ARGB mode: kernel 2 writes the inline colors
    t0 = time.perf_counter()
    # with the rays initialised on the device, so that the flythroughs drive
    # both ray inits through the Renderer
    argb = Renderer.create(
        terrain_lods, dataclasses.replace(main_cfg, argb_records=True,
                                          host_init=False), device=dev,
        compact=True)
    adw = argb.device_world
    log(f"[argb] device world up in {time.perf_counter() - t0:.1f} s: "
        f"max_col_colors {adw.max_col_colors}, records "
        f"{tuple(adw.rec_fwd.shape)} int32 a direction "
        f"({adw.rec_fwd.nbytes / 1e6:.0f} MB, index mode "
        f"{terrain.device_world.rec_fwd.nbytes / 1e6:.0f} MB), ARGB mode "
        f"{argb.argb_on}")
    if not (argb.argb_on and adw.max_col_colors > 0):
        raise AssertionError("terrain2048 did not engage ARGB mode")
    a_caps = check_terrain_kernels(argb, stats, tag="argb")
    if a_caps["raster"][0].cells.colors is None:
        raise AssertionError("the ARGB chunk carries no colors")
    check_small_frame(argb, "argb", [
        ("ARGB kernels", {}, None, True),
        ("ARGB plain", {"backend": "xla"}, None, True),
        ("index-mode kernels", {}, terrain, True),
        ("ARGB kernels, no compaction", {}, None, False)], stats)
    a_launches, _m, _g = flythrough(argb, "argb", card, gated=False)
    check_argb_frames(argb, terrain, card)
    a_caps["dims"] = adw.dims
    a_caps["roll_previous"] = prev_roll["previous design"]
    a_times = time_kernels(a_caps)
    check_loop(dataclasses.replace(argb, compact=False, config=(
        dataclasses.replace(argb.config, host_init=True))),
        "terrain2048 ARGB", card, stats, loop)
    del argb, a_caps, adw
    torch.cuda.empty_cache()
    log(f"[argb] done at {time.perf_counter() - t_start:.1f} s")

    check_split_layout(dev, stats)

    # ---- layered2048: the occupancy-gated march
    out, waited = wait_child(layered_build, "the layered2048 build", 600)
    log(f"{out.strip()} (a child process; waited {waited:.1f} s for it)")
    layered_lods = layered2048(log=log)
    t0 = time.perf_counter()
    layered = Renderer.create(layered_lods, main_cfg, device=dev,
                              compact=True)
    dw = layered.device_world
    log(f"[layered] (a) device world up in {time.perf_counter() - t0:.1f} s: "
        f"{dw.lod0_voxels} LOD0 voxels, max_runs {dw.max_runs}, empty_frac "
        f"{dw.empty_frac:.4f}, records {tuple(dw.rec_fwd.shape)}, "
        f"{dw.occ_tiles.shape[0]} tile rows, solid Y {dw.solid_min_y}.."
        f"{dw.solid_max_y}; gate {layered.occupancy_on}, chunk and budget "
        f"{layered.march_params}, group {layered.gated_group_cells}")
    if not layered.occupancy_on:
        raise AssertionError("layered2048's occupancy gate resolved off")
    check_device_init(layered, "layered", card)
    g_caps = check_gated_kernels(layered, stats)
    check_small_frame(layered, "layered", [
        ("gated kernels", {}, None, True),
        ("gated plain", {"backend": "xla"}, None, True),
        ("dense kernels", {"occupancy_gate": "off"}, None, True),
        ("gated kernels, no compaction", {}, None, False),
        ("gated kernels, device ray init", {"host_init": False}, None,
         True)], stats)
    l_launches, _m, _g = flythrough(layered, "layered", card, gated=True)
    # time at the captured group with the most gated cells, and phase 2 on
    # that frame's raybuffer
    busiest = max(g_caps.values(), key=lambda c: int(c[0].cells.valid.sum()))
    f = layered.frame_setup(busiest[0].frame.cam)
    p2args = check_phase2(layered, f, layered.march(f), stats)
    log(f"[layered] reproject_screen == plain on a 1080p frame: 0 pixels "
        "differ")
    l_times = time_kernels({
        "roll": busiest[0], "raster": busiest,
        "phase2": (p2args, sample_maps(layered, f.tables)),
        "roll_previous": prev_roll["previous design"],
        "dims": dw.dims, "plain_reps": 1})
    check_loop(dataclasses.replace(layered, compact=False), "layered2048",
               card, stats, loop)
    log(f"[layered] done at {time.perf_counter() - t_start:.1f} s")
    del g_caps, busiest, f, p2args
    torch.cuda.empty_cache()

    rollout = check_rollout(card, stats)
    log(f"[rollout] done at {time.perf_counter() - t_start:.1f} s")
    dynamic = check_dynamic(card, stats)
    log(f"[dynamic] done at {time.perf_counter() - t_start:.1f} s")
    mesh = check_mesh(card, dev)
    log(f"[mesh] done at {time.perf_counter() - t_start:.1f} s")
    shard = check_shard(card, stats, terrain, terrain_lods, layered,
                        layered_lods)
    log(f"[shard] done at {time.perf_counter() - t_start:.1f} s")
    # the entry's processes load the cached worlds and upload their own
    del terrain, layered, terrain_lods, layered_lods
    torch.cuda.empty_cache()
    bench = check_bench(card)
    log(f"[bench] done at {time.perf_counter() - t_start:.1f} s")

    kernels = []
    for kname, src, replaces in KERNELS:
        lt, tt, at = l_times[kname], t_times[kname], a_times[kname]
        for path, t in (("terrain2048", tt), ("terrain2048 ARGB", at),
                        ("layered2048", lt)):
            lib_txt = ("none" if t["library_ms"] is None
                       else f"{t['library_ms']:.4f} ms a call, "
                       f"{t['library_device_ms']:.4f} ms on the device")
            log(f"[time] {kname} at {path}'s shapes ({t['rays']} rays): "
                f"kernel {t['ms']:.4f} ms a call, {t['device_ms']:.4f} ms on "
                f"the device a launch, "
                f"plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
                f"({t['bound_by']}: {t['bytes']} B, {t['operations']} ops), "
                f"library {lib_txt}; {stats[kname]['mismatches']} mismatches "
                f"against the plain version, tolerance 0 ({card})")
            prev = t["previous_design"]
            log(f"[time] {kname} at {path}'s shapes, the previous design on "
                f"the same inputs: " + PREVIOUS_TXT[kname](prev)
                + f"; this design's {t['device_ms']:.4f} ms on the device is "
                f"{prev['device_ratio']:.4f} of it ({card})")
        kernels.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces, "launches": l_launches[kname],
            "max_abs_err": stats[kname]["max_abs_err"],
            "ms": lt["ms"], "device_ms": lt["device_ms"],
            "plain_ms": lt["plain_ms"],
            "bound_ms": lt["bound_ms"], "bound_by": lt["bound_by"],
            "library_ms": lt["library_ms"],
            "library_device_ms": lt["library_device_ms"],
            "previous_design": lt["previous_design"],
            "launches_by_path": {
                "terrain2048": t_launches[kname],
                "terrain2048_argb": a_launches[kname],
                "layered2048": l_launches[kname],
                **{f"loop {p}": loop[p]["launches"][kname]
                   for p in LOOP_PATHS},
                "rollout64_256x256": rollout["launches"][kname],
                "dynamic512_1280x720": dynamic["launches"][kname],
                "mesh2048_1920x1080": mesh["launches"][kname],
                "shard": shard[kname]},
            "terrain2048": tt, "terrain2048_argb": at})
    # phase 2 of a camera batch: the batched variant of reproject_screen,
    # timed at the rollout's shapes (a direction group of 32 cameras)
    p2 = rollout["phase2"]
    kernels.append({
        "name": "reproject_screens", "route": "cuda",
        "source": "cpuvox_tpu_torch/csrc/reproject.cu",
        "replaces": "cpuvox_tpu/ops/reproject_kernel.py:64",
        "launches": rollout["launches"]["reproject_screens"],
        "max_abs_err": stats["reproject_screens"]["max_abs_err"],
        "ms": p2["batched"]["ms"], "device_ms": p2["batched"]["device_ms"],
        "plain_ms": p2["plain_ms"], "bound_ms": p2["bound_ms"],
        "bound_by": p2["bound_by"], "library_ms": p2["library_ms"],
        "library_device_ms": p2["library_device_ms"],
        "per_camera_launches": p2["per camera"],
        "launches_by_path": {
            "rollout64_256x256": rollout["launches"]["reproject_screens"],
            "mesh2048_1920x1080": mesh["launches"]["reproject_screens"],
            "shard": shard["reproject_screens"]}})
    lk = loop["kernel"]
    kernels.append({
        "name": "march_loop", "route": "cuda", "source": LOOP_KERNEL[1],
        "replaces": LOOP_KERNEL[2],
        "launches": loop["layered2048"]["launches"]["march_loop"],
        "max_abs_err": stats["march_loop"]["max_abs_err"],
        "ms": lk["ms"], "device_ms": lk["device_ms"],
        "plain_ms": lk["plain_ms"], "bound_ms": lk["bound_ms"],
        "bound_by": lk["bound_by"], "library_ms": lk["library_ms"],
        "launches_by_path": {f"loop {p}": loop[p]["launches"]["march_loop"]
                             for p in LOOP_PATHS}})
    for p in LOOP_PATHS:
        v = loop[p]
        log(f"[summary] [loop] {p}: fps {v['fps_seq']:.3f} sequential, "
            f"{v['fps_pipe']:.3f} pipelined; frame p50 "
            f"{v['frame_ms_p50']:.3f} ms, pipelined "
            f"{v['frame_ms_p50_pipe']:.3f} ms, device span p50 "
            f"{v['frame_gpu_ms_p50']:.3f} ms, the card's time a frame "
            f"{v['device_frame_ms_p50']:.3f} ms, pipelined busy share "
            f"{v['busy_share_pipe']:.4f} (profiler), "
            f"{v['device_share_pipe']:.4f} (events); captures (ms capture / "
            f"instantiate, pool bytes): " + ", ".join(
                f"{c['direction']:+d} {c['capture_ms']:.2f} / "
                f"{c['instantiate_ms']:.2f}, {c['pool_bytes']}"
                for c in v["captures"]) + f" ({card})")
    log(f"[summary] rollout cams/s (compaction off, on): "
        f"{rollout['cams_per_sec'][False]}, {rollout['cams_per_sec'][True]}, "
        f"busy share {rollout['busy_share']:.4f}; dynamic fps exact_lod1 "
        f"False {dynamic[False]['fps']:.3f}, True {dynamic[True]['fps']:.3f} "
        f"({card})")
    conv, inter = mesh["convert"], mesh["interactive"]
    log(f"[summary] town{MESH_MAX_DIM} conversion {conv['seconds_cold']:.3f} s "
        f"cold, {conv['seconds_steady']:.3f} s steady; interactive step p50 "
        + ", ".join(f"{wh} {m['step_ms_p50']:.3f} ms" for wh, m in inter.items())
        + f" ({card})")
    log("[summary] the benchmark entry: " + ", ".join(
        f"{r['metric']} {r['value']} {r['unit']}" for r in bench)
        + f" ({card})")
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
