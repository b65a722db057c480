"""Drive the PyTorch port's main paths on one CUDA card and check every kernel.

Run from the repository root, on a machine with an NVIDIA H100 (sm_90a) and
``nvcc``:

    python3 chip_smoke.py

(``python3 chip_smoke.py --shard-only`` builds the kernels and the two 2048
worlds and runs phase 12 alone: the multi-device renderer over the shards
of card 0 and, with more than one card, over the cards; it ends with the
phase's summary line and its time.)

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
   flythrough (24 frames) with launch counts, iterations by stage width and
   mean ray slots an iteration, a magenta check, fps and frame p50, no
   torch column fetch, no torch phase-2 index map and one phase-2 launch a
   frame on the way;
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
   and device against host init at its dims; (b) the roll at chunk 128, the
   gate kernel, both rasterizers on a packed group of 16 gated cells at
   MAXR 29 and the rewind kernel, mid-march, with the live-ray index and at
   full width, against their plain versions, in both iteration directions;
   (c) one 320x180 frame five ways, equal raybuffers and screens: gated
   kernels, gated plain versions, dense kernels, gated kernels without
   compaction, gated kernels with device ray init; (d) the 1920x1080
   flythrough (24 frames) with 0 magenta, every kernel launched, busy rays
   rewound and the gate and rewind kernels each launched once a gated
   iteration (counted by the kernels on the device, with the gate's steps
   past its tile budget; so are [loop]'s flythroughs and the shard path's
   counted runs); (e) phase 2 on a 1080p frame;
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
   step through the batch march graphs (a direction group's rays built on
   the card in one pass, one graph launch, one phase-2 launch) == the
   host-loop batch == the plain versions == each camera's single-camera
   frame, and the compacted step through the staged batch graphs == the
   same; 8 cameras in ARGB mode and 8 on a gated 256x128x256 layered
   world through the graphs against their single frames; 4 warm steps
   queued with no host read (``set_sync_debug_mode("error")``), no capture
   and no pool growth, uncompacted and staged; the batched phase-2 kernel
   and a launch of the single-camera kernel a camera, each against the
   plain phase 2 camera by camera, timed side by side; cams/s on the
   uncompacted and the staged graphs in turns, launches and iterations a
   step, where a step's time goes, a step's device busy share;
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
   Renderer's, the window, the exchanges and their bytes; the window over
   12 path cameras, the inner Renderer on the graph route uncompacted and
   staged: its captures and ``memory_reserved`` do not grow with the
   window's moves; (f) on each, the rasterizer on a chunk of the active
   window against its plain version.  Then the shards' device program
   (each shard or camera block in a staged march graph of its own, on a
   stream of its own): (c) ``render_frame_sharded`` on both worlds, (d)
   the composed mode (the strict-subset window, the rays over the same 4
   shards) over the 12-camera window path on both, (e) the rollout's 64
   cameras at 256x256 camera-sharded.  For each of (c), (d) and (e): ==
   the unsharded Renderer or batch == the sharded host loop
   (``host_loop``), 0 magenta; the graph launches and the iterations by
   stage (the graphs' launches counted on the device); one more run on
   the host loop with the kernel calls held against their plain
   versions (a shard's slice of the rays, the gathered raybuffer, a camera
   block: every phase-2 call, and each shard's first roll and rasterizer
   call at full width and on a live-ray index); a warm run silent under
   ``set_sync_debug_mode("error")`` up to the screen's copy; no capture
   and ``memory_reserved`` flat over warm runs (for (d), over a second
   pass of the window path, its moves included); the shards' overlap (CUDA
   events around each shard's work on its stream: their summed span over
   their union, each card's from a reference event recorded on it after a
   sync of every card); the shard graphs' capture ms and pool bytes; frame
   ms or cams/s in turns: sharded graphs, unsharded, for (e) the blocks
   queued on one stream (``one_stream``), sharded host loop.  With
   more than one card, (a), (c), (d) (with the copy of the active world
   to the other cards a window move) and (e) again over the real cards;
13. the benchmark entry, ``python -m cpuvox_tpu_torch.bench``, a process
   a mode (``BENCH_RUNS``): terrain2048 at 1920x1080 over 8 frames and
   layered2048 at 320x180, each through its verify gate (one path camera
   through the kernels and the plain versions, screens and raybuffers
   equal), then rollout64, dynamic512 and convert_town2048; each must exit
   0 and print only JSON lines, ``bench.py``'s metric names, no ``verify``
   key, 0 magenta pixels and the card's line, and in a flythrough record
   both ``fps_seq`` and ``fps_pipe``; each record is printed.

[loop], at the end of phases 3, 4 and 6: the full-width march
(``compact=False``), one launch of the march graph (``render/march_graph.py``: a WHILE conditional
node whose condition the loop-control kernel, ``csrc/march_loop.cu``,
sets), on terrain2048 in index and ARGB mode (dense) and layered2048
(gated), at 1920x1080.  First (phase 3) the loop-control kernel against its
plain version at the frame's ray count, in its three modes (first, next,
check) and with stage thresholds, timed.  Then for each variant: (a)
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
the private pool's bytes.  Then the staged march graph of the same variant
(the flythrough's compacted Renderer: a WHILE node a stage of halving
width, ``raymarch.stage_widths``, the live rays packed on the card into the
next stage's index between two): on the same cameras the staged graph ==
the uncompacted graph == the host loop with compaction, raybuffer and
screen, with equal iterations, each stage's iterations from the graph's
exit buffer and no host-loop chunk; a warm compacted ``render_device``
under ``set_sync_debug_mode("error")``; frame p50 sequential and
pipelined, uncompacted and staged in turns, with no capture and no pool
growth over the timed runs; each staged capture's ms and pool bytes a
stage.

The three flythrough Renderers are created with ``compact=True``: the
staged march graph, which is also the Renderer's default on the card
(``compact=None``: the oracle check, the split-layout frame, the rollout's
timed path, the dynamic worlds and the mesh path's sessions run it); the
full-width graph runs in [loop] and in a variant of each small frame.  Each flythrough makes the harness's sequential and
pipelined passes.  Kernel launch counts are set to 0 just before each
flythrough, [loop]'s, the rollout's first timed run, the dynamic terrain's (``exact_lod1`` off)
timed run, the mesh path's 1080p interactive run (two warmup steps and
24 timed) and each sharded run of phase 12 (summed as the ``shard`` path),
and read just after each; launches made to compare or time a kernel are
not counted; a march graph's launches are counted on the device
(``ops/march_loop.kernel_launches``).  The last lines are the card line,
one JSON line of kernels (``launches_by_path`` per path; the batched phase
2, ``reproject_screens``, the loop-control kernel, ``march_loop``, and the
gated march's ``gate`` and ``gate_rewind``, timed at layered2048's shapes,
have their own entries; theirs are the launches each kernel counted on the
device, on the layered flythrough, each [loop] flythrough and the shard
path's runs, beside the gated iterations of each), and
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
# the gated march's glue: no Pallas kernel computes it on the TPU, XLA code
# inside the jitted while_loop does
GATE_KERNELS = [("gate", "cpuvox_tpu/render/raymarch.py:1228"),
                ("gate_rewind", "cpuvox_tpu/render/raymarch.py:1547")]
GATE_SOURCE = "cpuvox_tpu_torch/csrc/gate.cu"
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


def gate_both(cap, dims, stats: dict) -> dict:
    """The gate kernel and the rewind kernel against their plain versions
    (``ops/gate_kernel.gate_ref``, ``rewind_ref``) on a capture's gated
    iteration: the chunk rolled again from the captured state, gated (the
    packed cells, ``proc``, count, cap, the rewind snapshot, ``rs.alive``),
    rasterized by the plain version, rewound (every DDA field, ``alive``,
    the rewind count).  Returns the inputs and counts ``time_gate`` reads."""
    from cpuvox_tpu_torch.bench.capture import clone
    from cpuvox_tpu_torch.ops import gate_kernel, phase1_kernel, roll_kernel
    from cpuvox_tpu_torch.render.raymarch import PackedCells

    dev = cap.alive.device
    dda, alive, visits = roll_kernel.roll_chunk_ref(
        clone(cap.dda), cap.alive.clone(), cap.frame.static.dirs,
        cap.lod_distances, cap.far, dims, cap.chunk, index=cap.index)
    gk = cap.src.rows.shape[0]
    outs = []
    for fn in (gate_kernel.gate, gate_kernel.gate_ref):
        rs = clone(cap.rs)
        counters = torch.zeros(3, dtype=torch.int64, device=dev)
        g = fn(cap.wa, visits, rs, cap.consts, gk, counters, index=cap.index)
        outs.append(([*g.cells, g.count, g.cap, g.snap, rs.alive], counters))
    compare("gate", outs[0][0], outs[1][0], stats)
    launched, overflow, rewinds = outs[0][1].tolist()
    if launched != 1 or rewinds:
        raise AssertionError(f"the gate kernel's counters {outs[0][1]}")
    rows, proc, count, cap_, snap, _alive = outs[1][0]
    g = gate_kernel.Gate(PackedCells(rows, proc), count, cap_, snap)
    rs = phase1_kernel.rasterize_visits_ref(
        clone(cap.rs), cap.wa, g.cells, cap.frame.static, cap.consts,
        cap.frame.iteration_direction, index=cap.index)
    outs = []
    for fn in (gate_kernel.rewind, gate_kernel.rewind_ref):
        d, a = clone(dda), alive.clone()
        rewound = torch.zeros((), dtype=torch.int64, device=dev)
        counters = torch.zeros(3, dtype=torch.int64, device=dev)
        fn(d, a, rewound, counters, rs, g, index=cap.index)
        outs.append([*d, a, rewound])
        if counters.tolist() != [0, 0, int(fn is gate_kernel.rewind)]:
            raise AssertionError(f"{fn.__name__}: counters "
                                 f"{counters.tolist()}")
    compare("gate_rewind", outs[0], outs[1], stats)
    return {"visits": visits, "dda": dda, "alive": alive, "rs": rs, "g": g,
            "overflow": overflow, "rewound": int(outs[0][-1])}


def gated_counts(tag: str) -> dict:
    """The gated march's counts since their last reset
    (``raymarch.gated_stats``, summed on the device): the gate kernel's and
    the rewind kernel's launches, each counted by the kernel itself, must
    equal the gated iterations."""
    from cpuvox_tpu_torch.render import raymarch

    c = dict(raymarch.gated_stats)
    if not c["gate_launches"] == c["rewind_launches"] == c["iterations"]:
        raise AssertionError(f"{tag}: {c['gate_launches']} gate and "
                             f"{c['rewind_launches']} rewind kernel launches "
                             f"in {c['iterations']} gated iterations")
    return c


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


@contextlib.contextmanager
def host_loop(renderer):
    """Within the block ``renderer`` marches on the host loop
    (``raymarch.march_on_host``), as it does on the CPU: a kernel call at a
    time, which ``held_against_plain`` holds against the plain versions (a
    graph replay calls no wrapper) and the host-loop comparisons run."""
    renderer.graph_route = lambda device=None: False
    try:
        yield renderer
    finally:
        del renderer.graph_route


def stage_summary(R: int) -> dict:
    """The march graphs' iterations by stage width since the counts were
    last set to 0 (``march_loop.stage_stats``, read from the device), their
    sum, those below the full width ``R``, and the mean ray slots an
    iteration."""
    from cpuvox_tpu_torch.ops import march_loop

    by = march_loop.stage_stats.read()
    n = sum(by.values())
    return {"by_width": by, "iterations": n,
            "narrow": sum(v for w, v in by.items() if w < R),
            "mean_slots": sum(w * v for w, v in by.items()) / n if n else 0.0}


def check_small_frame(renderer, scene: str, variants, stats: dict):
    """One 320x180 frame through each variant: (label, config changes,
    another renderer or None, compact).  Screens must all equal the
    first's, and so must the raybuffers of the variants that share its
    renderer (an index-mode raybuffer holds indices, an ARGB one colors).
    Each variant's raybuffer also goes through the fused phase-2 kernel and
    its plain version."""
    from cpuvox_tpu_torch.ops import march_loop
    from cpuvox_tpu_torch.render import raymarch

    cam = path_camera(renderer, 0.35, SMALL_WH)
    outs = []
    for label, kw, other, compact in variants:
        base = other or renderer
        cfg = dataclasses.replace(base.config, width=SMALL_WH[0],
                                  height=SMALL_WH[1], **kw)
        r = dataclasses.replace(base, config=cfg, lod_distances=None)
        n0 = raymarch.compact_stats["rebuilds"]
        march_loop.stage_stats.reset()
        t0 = time.perf_counter()
        f = r.frame_setup(cam)
        rb = r.march(f, compact=compact)
        screen = r.phase2(f, rb)
        torch.cuda.synchronize()
        outs.append((label, screen, rb, time.perf_counter() - t0,
                     r.occupancy_on))
        check_phase2(r, f, rb, stats)
        # compacted: on the host loop (the plain versions) the index was
        # rebuilt, in a graph the staged march ran below the full width
        rebuilt = raymarch.compact_stats["rebuilds"] - n0
        narrow = stage_summary(rb.shape[0])["narrow"]
        if bool(rebuilt or narrow) != compact or (rebuilt and narrow):
            raise AssertionError(f"{scene} {label}: {rebuilt} index rebuilds "
                                 f"on the host loop and {narrow} graph "
                                 f"iterations below the full width with "
                                 f"compact={compact}")
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
    """Phase 6b: the roll at chunk 128, the gate, the rasterizer on a gated
    group and the rewind, mid-march, in both iteration directions."""
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
        gated = gate_both(cap, dims, stats)
        GK, _rk, maxr = cap.cells.runs.shape
        log(f"[layered] direction {d:+d} (path t={t}), on {rays_of(cap)}: "
            f"roll_chunk == plain at C={cap.chunk} ({int(cap.alive.sum())} "
            f"rays marching); rasterize_visits == rasterize_chunk == plain "
            f"on a gated group "
            f"(GK={GK}, MAXR={maxr}, {int(cap.cells.valid.sum())} gated "
            f"cells, {written} texels written): raybuffer + 8 state fields, "
            f"0 elements differ; gate == plain (packed cells, proc, count, "
            f"cap, snapshot, rs.alive; {gated['overflow']} steps past the "
            f"tile budget) and gate_rewind == plain (DDA state, alive, "
            f"{gated['rewound']} rays rewound), 0 elements differ")
        if compact:
            caps[d] = (cap, written, gated)
    if set(caps) != {1, -1}:
        raise AssertionError(f"iteration directions seen: {sorted(caps)}")
    return caps


def flythrough(renderer, scene: str, card: str, gated: bool):
    """A path's 1080p flythrough with the launch counts set to 0 just before
    it and read just after it, and every torch column fetch and torch
    phase-2 index map counted (the frames through the kernels must make
    none): phase 2 is one launch of the fused kernel a frame.  The
    Renderer compacts, so its march is the staged march graph: no march on
    the host loop, iterations below the full width, read by stage from the
    graphs' exit buffers."""
    from cpuvox_tpu_torch.bench.harness import run_flythrough
    from cpuvox_tpu_torch.ops import march_loop, phase1_kernel
    from cpuvox_tpu_torch.ops import reproject_kernel
    from cpuvox_tpu_torch.render import raymarch, reproject

    march_loop.reset_launches()
    raymarch.gated_stats.reset()
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
    gstats = gated_counts(scene)
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
    st = stage_summary(renderer.ray_capacity)
    if cstats["chunks"] or not st["narrow"]:
        raise AssertionError(f"{scene}: {cstats['chunks']} chunks on the host "
                             f"loop, {st['narrow']} graph iterations below "
                             "the full width: the march did not run staged "
                             "in its graph")
    if metrics["magenta_pixels"]:
        raise AssertionError(f"{scene}: {metrics['magenta_pixels']} magenta "
                             "pixels in the flythrough")
    if min(launches) <= 0 or counts["march_loop"] <= 0:
        raise AssertionError(f"{scene}: a kernel did not run on the path: "
                             f"launches {launches}, march_loop "
                             f"{counts['march_loop']}")
    if gated and gstats["rewinds"] <= 0:
        raise AssertionError(f"{scene}: the gated march rewound no ray")
    extra = (f"; {gstats['iterations'] / frames:.1f} gated iterations and "
             f"{gstats['rewinds'] / frames:.0f} rays rewound per frame; "
             f"launches counted by the kernels on the device: gate "
             f"{gstats['gate_launches']}, rewind {gstats['rewind_launches']} "
             f"(gated iterations {gstats['iterations']}), "
             f"{gstats['overflow_steps']} steps past the gate's tile budget"
             if gated else "")
    extra += (f"; staged graph, iterations by stage width "
              f"{st['by_width']} ({st['iterations'] / frames:.1f} a frame), "
              f"mean {st['mean_slots']:.0f} of {renderer.ray_capacity} ray "
              f"slots an iteration; 0 chunks on the host loop")
    log(f"[{scene}] {MAIN_WH[0]}x{MAIN_WH[1]} flythrough, {N_FRAMES} frames "
        f"on {card}: fps {metrics['fps']:.3f} (pipelined "
        f"{metrics['fps_pipe']:.3f}), frame p50 "
        f"{metrics['frame_ms_p50']:.1f} ms (device span p50 "
        f"{metrics['frame_gpu_ms_p50']:.1f} ms), "
        f"{metrics['ray_columns_per_sec']:.0f} ray columns/s, 0 magenta, 0 "
        f"torch column fetches, 0 torch phase-2 index maps; launches roll "
        f"{launches[0]}, rasterize {launches[1]}, phase 2 {launches[2]} "
        f"(0 of the previous sample), loop control {counts['march_loop']} "
        f"(a check a stage a frame and one an iteration){extra}")
    return ({**dict(zip([k[0] for k in KERNELS], launches)),
             "march_loop": counts["march_loop"],
             "gated": gstats}, metrics, st)


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

    # (alive, rs_alive, counter, budget, mode, threshold): the unstaged
    # loop's any (threshold 0), then a stage's count against its threshold
    # after an iteration and in check mode (neither reset nor advanced)
    cases = [(mask(0.5), mask(0.5), 3, 100, "first", 0),
             (mask(0.5), torch.zeros(R + 1, dtype=torch.bool, device=dev),
              3, 100, "next", 0),
             (mask(0.1), mask(0.9), 99, 100, "next", 0),
             (mask(0.5), mask(0.5), 41, 100, "first", 0),
             (mask(0.5), mask(0.5), 3, 100, "next", R // 8),
             (mask(0.5), mask(0.5), 3, 100, "check", R // 2),
             (mask(0.1), mask(0.9), 41, 100, "check", 16),
             (mask(0.5), mask(0.5), 100, 100, "check", 0)]
    conds = []
    for alive, rs_alive, i, mx, mode, thr in cases:
        for lo in (0, 1):  # the word path, then R - 1 rays from an odd byte
            a, b = alive[lo:lo + R - lo], rs_alive[lo:lo + R - lo]
            kw = {"first": mode == "first", "check": mode == "check",
                  "threshold": thr}
            got = [a.clone(), torch.tensor(i, dtype=torch.int32, device=dev),
                   torch.tensor(-1, dtype=torch.int32, device=dev)]
            want = [x.clone() for x in got]
            got.append(march_loop.loop_control(got[0], b, got[1], mx,
                                               exit_out=got[2], **kw))
            want.append(march_loop.loop_control_ref(want[0], b, want[1], mx,
                                                    exit_out=want[2], **kw))
            compare("march_loop", got, want, stats)
            conds.append(int(got[3]))
    if conds != [1, 1, 0, 0, 0, 0, 1, 1, 1, 1, 0, 0, 1, 1, 0, 0]:
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
    # the condition (the timed call has no exit slot); an AND and a count a
    # ray
    nbytes, nops = 3 * R + 12, 2 * R
    b_ms, b_by = bound(nbytes, nops)
    out = {"ms": ms, "device_ms": device, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
           "operations": nops, "library_ms": None, "rays": R}
    log(f"[loop] march_loop == plain at {R} rays (and {R - 1} from an odd "
        f"address), first, next and check mode, thresholds 0, {R // 8}, "
        f"{R // 2} and 16: alive, counter, exit slot and condition, 0 "
        f"elements differ, tolerance 0; kernel {ms:.4f} ms a call, {device:.4f} ms on the "
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
    raymarch.gated_stats.reset()
    m = run_flythrough(r, n_frames=N_FRAMES, log=log, keep_screens=True)
    counts = march_loop.kernel_launches()
    gated = gated_counts(f"[loop] {tag}")
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
                 "iterations": iters, "gated": gated,
                 "fps_seq": m["fps_seq"],
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
        f"{counts['reproject_screen']}; gated march counts {gated} ({card})")
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


def check_loop_staged(renderer, tag: str, card: str, stats: dict,
                      loop: dict) -> None:
    """Phase [loop] on the staged march graph (the compacted Renderer with
    the kernels: stages of halving width, the live rays packed on the card
    between them): (a) on the 1080p path cameras in both iteration
    directions the staged graph == the uncompacted graph == the host loop
    with compaction (the kernels a call at a time), raybuffer and screen,
    with the uncompacted graph's iterations, and each stage's iterations
    from the variant's exit buffer; the compacted march never reaches the
    host loop; (b) a warm compacted ``render_device`` under
    ``set_sync_debug_mode("error")``; (c) frame p50 sequential and
    pipelined, uncompacted and staged in turns (u, s, s, u; both Renderers
    share one MarchGraph), 0 magenta, no capture and ``memory_reserved``
    unchanged over the timed runs; (d) each staged capture's ms and pool
    bytes, stage by stage.  Adds the numbers to ``loop[tag]["staged"]``."""
    from cpuvox_tpu_torch.bench.harness import run_flythrough
    from cpuvox_tpu_torch.ops import march_loop
    from cpuvox_tpu_torch.render import raymarch

    r = renderer
    if not (r.kernels and r.compact and r.graph_route()):
        raise AssertionError(f"[loop] {tag}: not a compacted march-graph "
                             "Renderer")
    t_phase = time.perf_counter()
    R = r.ray_capacity
    widths = r.stage_widths(R)
    stat, key = ((raymarch.gated_stats, "iterations") if r.occupancy_on
                 else (raymarch.compact_stats, "chunks"))
    rows = []
    for t in LOOP_PATH_T:
        cam = path_camera(r, t)
        f = r.frame_setup(cam)
        march_loop.reset_launches()
        c0 = raymarch.compact_stats["chunks"]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        ev[0].record()
        staged = r.march(f)
        ev[1].record()
        by = stage_summary(R)["by_width"]
        it_s = march_loop.graph_stats["iterations"]
        if raymarch.compact_stats["chunks"] != c0:
            raise AssertionError(f"[loop] {tag} t={t}: the compacted march "
                                 "ran on the host loop")
        torch.cuda.synchronize()
        ev[2].record()
        full = r.march(f, compact=False)
        ev[3].record()
        it_f = march_loop.graph_stats["iterations"] - it_s
        h0 = stat[key]
        host = r.march_rays(f.static, f.dda, f.alive0, f.cam_data,
                            f.cam_data.position[1], f.iteration_direction,
                            compact=True)
        it_h = stat[key] - h0
        screen = r.phase2(f, staged)
        compare(f"[loop] {tag} staged t={t}", [staged, screen, staged, screen],
                [full, r.phase2(f, full), host, r.phase2(f, host)], {})
        if int((screen == raymarch.MAGENTA_I32).sum()):
            raise AssertionError(f"[loop] {tag} staged t={t}: magenta")
        if not it_s == it_f == it_h > 0:
            raise AssertionError(f"[loop] {tag} staged t={t}: iterations "
                                 f"staged {it_s}, uncompacted {it_f}, host "
                                 f"loop {it_h}")
        r.render_device(cam)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            r.render_device(cam)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        rows.append((t, f.iteration_direction, it_s,
                     [by.get(w, 0) for w in widths],
                     round(ev[0].elapsed_time(ev[1]), 3),
                     round(ev[2].elapsed_time(ev[3]), 3)))
    if {row[1] for row in rows} != {1, -1}:
        raise AssertionError(f"[loop] {tag} staged: directions {rows}")
    log(f"[loop] {tag} staged (a)-(b) {MAIN_WH[0]}x{MAIN_WH[1]}, stage "
        f"widths {list(widths)}: the staged graph == the uncompacted graph "
        f"== the host loop with compaction, raybuffer and screen, 0 texels "
        f"and 0 pixels differ, 0 magenta; the compacted march never ran on "
        f"the host loop; a warm compacted render_device under "
        f"set_sync_debug_mode('error') raised nothing; (t, direction, "
        f"iterations == uncompacted == host loop, iterations by stage from "
        f"the exit buffer, the march's card ms staged and full width by "
        f"CUDA events) {rows} ({card})")

    # (c) frame p50, uncompacted and staged in turns, one MarchGraph
    u = dataclasses.replace(r, compact=False)
    u._graph, u._staging = r._graph, r._staging
    caps0 = len(r._graph.captures)
    runs: dict = {False: [], True: []}
    reserved = []
    raymarch.gated_stats.reset()
    for compact in (False, True, True, False):
        m = run_flythrough(r if compact else u, n_frames=N_FRAMES, log=log)
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved(r.device))
        if m["magenta_pixels"]:
            raise AssertionError(f"[loop] {tag}: {m['magenta_pixels']} "
                                 "magenta pixels in a timed run")
        runs[compact].append(m)
    gated = gated_counts(f"[loop] {tag} staged")
    if len(r._graph.captures) != caps0 or len(set(reserved)) != 1:
        raise AssertionError(f"[loop] {tag}: over the timed runs captures "
                             f"{caps0} -> {len(r._graph.captures)}, "
                             f"memory_reserved {reserved}")

    def p50(compact, k):
        return [m[k] for m in runs[compact]]

    out = {"widths": list(widths), "rows": rows,
           "seq_ms": {c: p50(c, "frame_ms_p50") for c in runs},
           "pipe_ms": {c: p50(c, "frame_ms_p50_pipe") for c in runs},
           "fps_seq": {c: p50(c, "fps_seq") for c in runs},
           "fps_pipe": {c: p50(c, "fps_pipe") for c in runs},
           "memory_reserved": reserved[0], "gated": gated,
           "captures": [c for c in r._graph.captures
                        if len(c["widths"]) > 1]}
    loop[tag]["staged"] = out

    def txt(k):
        return (f"uncompacted {np.round(out[k][False], 3).tolist()}, staged "
                f"{np.round(out[k][True], 3).tolist()}")

    log(f"[loop] {tag} staged (c) {MAIN_WH[0]}x{MAIN_WH[1]} flythrough, "
        f"{N_FRAMES} frames a pass, runs in turns (uncompacted, staged, "
        f"staged, uncompacted): frame p50 sequential ms {txt('seq_ms')}; "
        f"pipelined ms {txt('pipe_ms')}; 0 magenta; captures {caps0} and "
        f"memory_reserved {reserved[0]} bytes unchanged over the runs; "
        f"gated march counts {gated} ({card})")
    for c in out["captures"]:
        log(f"[loop] {tag} staged (d) capture, direction {c['direction']}, "
            f"{'gated' if c['gated'] else 'dense'}: warm {c['warm_ms']:.3f} "
            f"ms, capture {c['capture_ms']:.3f} ms, instantiate "
            f"{c['instantiate_ms']:.3f} ms, private pool +{c['pool_bytes']} "
            f"bytes; by stage (width: capture ms, pool bytes) "
            + ", ".join(f"{s['width']}: {s['capture_ms']:.3f}, "
                        f"{s['pool_bytes']}" for s in c["stages"]))
    log(f"[loop] {tag} staged done in {time.perf_counter() - t_phase:.1f} s")


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
    through the batch march graphs (the Renderer's default: a direction
    group's rays built in one pass on the card, one graph launch and one
    phase-2 launch a group) == the compacted batch through the staged
    batch graphs (stages of halving width at the group's bucketed ray
    count) == the host-loop batch (compaction on) == the batch through the
    plain versions == each camera's single-camera frame; 8 cameras in ARGB
    mode and 8 on a gated layered world through the graphs against their
    single frames; 4 warm steps queued under ``set_sync_debug_mode(
    "error")``, uncompacted and staged, the captures and
    ``memory_reserved`` unchanged over them; both phase-2 variants against
    the plain phase 2 camera by camera, timed side by side; then cams/s on
    the uncompacted and the staged graphs in turns, launches and iterations
    a step, where a step's time goes, and a step's device busy share, alone
    and 4 steps queued.  The rollout path's kernel counts are set to 0 just
    before its first timed run (the staged graphs, the Renderer's default
    on the card) and read just after it."""
    from cpuvox_tpu_torch.bench import harness
    from cpuvox_tpu_torch.bench.breakdown import device_activities, union_us
    from cpuvox_tpu_torch.config import RenderConfig
    from cpuvox_tpu_torch.models import procedural
    from cpuvox_tpu_torch.ops import march_loop
    from cpuvox_tpu_torch.ops import reproject_kernel as rk
    from cpuvox_tpu_torch.parallel import batch
    from cpuvox_tpu_torch.render import device_init, raymarch
    from cpuvox_tpu_torch.render.frame import Renderer
    from cpuvox_tpu_torch.render.raymarch import MAGENTA_I32

    t0 = time.perf_counter()
    # the full-width batch graphs here; ``staged`` below is the Renderer's
    # default on the card (``compact=None``), the compacted batch
    r = harness.rollout_renderer(ROLLOUT_WH, compact=False)
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

    # the step four ways
    t0 = time.perf_counter()
    kb = check_batch_singles(r, cams, "rollout", {})
    torch.cuda.synchronize()
    t_k = time.perf_counter() - t0
    buckets = sorted(k[0] // r.ray_capacity for k in r._batch_graphs)
    want = sorted({batch.bucket_size(n, N_ROLLOUT_CAMS)
                   for n in (n_up, N_ROLLOUT_CAMS - n_up)})
    if buckets != want:
        raise AssertionError(f"[rollout] batch graphs at buckets {buckets}, "
                             f"not {want}")
    # the compacted batch: staged batch graphs, sharing r's MarchGraphs
    staged = dataclasses.replace(r, compact=None)
    staged._batch_graphs = r._batch_graphs
    march_loop.reset_launches()
    c0 = raymarch.compact_stats["chunks"]
    t0 = time.perf_counter()
    sb = batch.render_camera_batch(staged, cams)
    torch.cuda.synchronize()
    t_s = time.perf_counter() - t0
    s_stages = march_loop.stage_stats.read()
    s_graphs = [v.widths for g in r._batch_graphs.values()
                for v in g.variants.values() if len(v.widths) > 1]
    if raymarch.compact_stats["chunks"] != c0 or len(s_graphs) != 2:
        raise AssertionError(f"[rollout] the compacted batch: staged graphs "
                             f"{s_graphs}, host-loop chunks "
                             f"{raymarch.compact_stats['chunks'] - c0}")
    compare("rollout batch, staged graphs", [sb], [kb], {})
    if int((sb == MAGENTA_I32).sum()):
        raise AssertionError("[rollout] magenta in the staged batch")
    host = dataclasses.replace(r, compact=True)
    t0 = time.perf_counter()
    with host_loop(host):
        hb = batch.render_camera_batch(host, cams)
    torch.cuda.synchronize()
    t_h = time.perf_counter() - t0
    plain = dataclasses.replace(r, config=dataclasses.replace(
        r.config, backend="xla"), compact=True)
    t0 = time.perf_counter()
    pb = batch.render_camera_batch(plain, cams)
    torch.cuda.synchronize()
    t_p = time.perf_counter() - t0
    if host._batch_graphs or plain._batch_graphs:
        raise AssertionError("[rollout] a host-loop batch took a graph")
    compare("rollout batch, host loop", [kb], [hb], {})
    compare("rollout batch, plain", [kb], [pb], {})
    log(f"[rollout] one step of {N_ROLLOUT_CAMS} cameras: the batch through "
        f"the batch march graphs (buckets of {buckets} cameras, "
        f"{[b * r.ray_capacity for b in buckets]} rays) == the compacted "
        f"batch through the staged batch graphs (stage widths {s_graphs}; "
        f"iterations by width {s_stages}; {t_s:.2f} s with the captures, 0 "
        f"chunks on the host loop, 0 magenta) == the "
        f"host-loop batch (compacted, {t_h:.2f} s) == the batch through the "
        f"plain versions (compacted, {t_p:.1f} s) == the {N_ROLLOUT_CAMS} "
        f"single-camera graph frames ({t_k:.2f} s with the batch, cold), "
        "index mode, 0 pixels differ, 0 magenta")
    del host, plain, hb, pb, sb

    ra = harness.rollout_renderer(ROLLOUT_WH, argb_records=True)
    if not ra.argb_on:
        raise AssertionError("the rollout world did not engage ARGB mode")
    check_batch_singles(ra, cams[:8], "rollout ARGB", {})
    mcc = ra.device_world.max_col_colors
    if not ra._batch_graphs:
        raise AssertionError("[rollout] the ARGB batch took no graph")
    del ra
    gdims = (256, 128, 256)
    rg = Renderer.create(
        procedural.layered_world(dims=gdims, seed=99, lod_levels=6),
        RenderConfig(width=ROLLOUT_WH[0], height=ROLLOUT_WH[1],
                     occupancy_gate="on"), device=r.device)
    if not rg.occupancy_on:
        raise AssertionError("the layered world's gate resolved off")
    gcams = harness.rollout_cameras(2, 8, ROLLOUT_WH, gdims)
    check_batch_singles(rg, gcams, "rollout gated", {})
    if not rg._batch_graphs:
        raise AssertionError("[rollout] the gated batch took no graph")
    log(f"[rollout] 8 cameras in ARGB mode (max_col_colors {mcc}) and 8 "
        f"on a gated layered {gdims} world (max_runs "
        f"{rg.device_world.max_runs}), through the batch march graphs: each "
        "batch == its single-camera graph frames, 0 pixels differ, 0 magenta")
    del rg

    # a warm step reads nothing from the card, and over 4 steps after it
    # nothing is captured and the pool does not grow
    steps = [harness.rollout_cameras(20 + s, N_ROLLOUT_CAMS, ROLLOUT_WH,
                                     dw.dims) for s in range(5)]

    def n_captures():
        return sum(len(g.captures) for g in r._batch_graphs.values())

    warm = {}
    for label, rr in (("uncompacted", r), ("staged", staged)):
        batch.render_camera_batch(rr, steps[0])
        torch.cuda.synchronize()
        caps = [n_captures()]
        reserved = [torch.cuda.memory_reserved(r.device)]
        march_loop.reset_launches()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for st in steps[1:]:
                batch.render_camera_batch(rr, st)
                caps.append(n_captures())
                reserved.append(torch.cuda.memory_reserved(r.device))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        g_steps = march_loop.graph_stats["launches"]
        if len(set(caps)) != 1 or len(set(reserved)) != 1 or g_steps != 8:
            raise AssertionError(f"[rollout] over 4 warm steps ({label}): "
                                 f"captures {caps}, memory_reserved "
                                 f"{reserved}, {g_steps} graph launches")
        warm[label] = (march_loop.graph_stats["iterations"] / 4, caps[0],
                       reserved[0], march_loop.stage_stats.read())
    it_steps = warm["uncompacted"][0]
    captured = "; ".join(
        f"{c['direction']:+d} at {k[0]} rays: capture {c['capture_ms']:.2f} "
        f"ms, instantiate {c['instantiate_ms']:.2f} ms, pool "
        f"+{c['pool_bytes']} B" for k, g in r._batch_graphs.items()
        for c in g.captures)
    log(f"[rollout] 4 warm steps, queued back to back under "
        f"set_sync_debug_mode('error'), uncompacted then staged: no host "
        f"read; 8 graph launches each, iterations a step (device counter) "
        f"{warm['uncompacted'][0]:.2f} and {warm['staged'][0]:.2f} (staged, "
        f"by stage width {warm['staged'][3]}); captures and memory_reserved "
        f"after the warm step {warm['uncompacted'][1:3]} and "
        f"{warm['staged'][1:3]} bytes, unchanged after each of the 4 (the "
        f"captures: {captured}) ({card})")

    # phase 2 of the looking-down group, both variants
    group = [f for f in frames if f.iteration_direction > 0]
    args = batch.phase2_group_args(
        r, batch.march_group(r, group, 1, len(group)), group)
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

    # the timed runs, in turns: the staged batch graphs (the Renderer's
    # default, the path's launch counts) and the full-width ones
    runs = {False: [], True: []}
    for k, compact in enumerate((True, False, False, True)):
        rr = staged if compact else r
        if k == 0:
            march_loop.reset_launches()
        m = harness.run_rollout(rr, N_ROLLOUT_CAMS, log=log)
        if k == 0:
            launches = march_loop.kernel_launches()
            graph_launches = march_loop.graph_stats["launches"]
        if m["magenta_pixels"]:
            raise AssertionError("[rollout] magenta pixels in the timed run")
        runs[compact].append(m)
    if (min(launches["roll_chunk"], launches["rasterize_visits"],
            launches["reproject_screens"], launches["march_loop"]) <= 0
            or launches["reproject_screen"] or graph_launches != 2 * 5):
        raise AssertionError(f"[rollout] launches {launches}, "
                             f"{graph_launches} graph launches in 5 steps: a "
                             "kernel of the path did not run, phase 2 ran a "
                             "camera at a time, or a group left the graph")
    cps = {c: [m["cams_per_sec"] for m in v] for c, v in runs.items()}
    per_step = runs[True][0]["launches_per_step"]

    # where a step's host time goes, each stage synced, and the card's time
    # for the marches and phase 2 (CUDA events around each, its inputs
    # ready); a step's device busy share: that time over the step's wall,
    # and the union of its device activities under the profiler over the
    # same step's unprofiled wall, synced alone and 4 steps queued; on the
    # staged graphs (the default), and the full-width graphs' march on the
    # same rays beside each group's
    step = harness.rollout_cameras(9, N_ROLLOUT_CAMS, ROLLOUT_WH, dw.dims)
    R1, dims = r.ray_capacity, dw.dims
    walls, card_ms, full_ms = [], [], []
    stages = {"setup": [], "ray init": [], "march": [], "phase 2": []}
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch.render_camera_batch(staged, step)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        t = {k: 0.0 for k in stages}
        t0 = time.perf_counter()
        sframes = [staged.frame_geometry(c) for c in step]
        t["setup"] += time.perf_counter() - t0
        on_card = on_full = 0.0
        for d in (1, -1):
            g = [f for f in sframes if f.iteration_direction == d]
            t0 = time.perf_counter()
            p = device_init.stack_frame_params(
                [device_init.build_frame_params(f.cam_data, f.segs, f.ctxs)
                 for f in g], batch.bucket_size(len(g), len(step)))
            rays = device_init.init_rays_batch(p, dims, R1, r.device)
            torch.cuda.synchronize()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            t1 = time.perf_counter()
            ev[0].record()
            rb = staged.march_batch_graph(*rays, g[0].cam_data, d)
            ev[1].record()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            ev[2].record()
            batch.phase2_group(staged, rb[:len(g) * R1], g)
            ev[3].record()
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            fe = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            fe[0].record()
            r.march_batch_graph(*rays, g[0].cam_data, d)
            fe[1].record()
            torch.cuda.synchronize()
            on_full += fe[0].elapsed_time(fe[1])
            t["ray init"] += t1 - t0
            t["march"] += t2 - t1
            t["phase 2"] += t3 - t2
            on_card += ev[0].elapsed_time(ev[1]) + ev[2].elapsed_time(ev[3])
        for k, v in t.items():
            stages[k].append(v * 1e3)
        card_ms.append(on_card)
        full_ms.append(on_full)
    log(f"[rollout] where a step's time goes on the staged graphs (each "
        f"stage synced, medians of 3): " + ", ".join(
            f"{k} {np.median(v):.3f} ms" for k, v in stages.items())
        + f" (ray init: the group's parameters stacked and init_rays_batch); "
        f"whole step {np.median(walls):.3f} ms; the card's time for the two "
        f"marches (events) staged {np.median(card_ms):.3f} ms with phase 2, "
        f"full-width graphs {np.median(full_ms):.3f} ms without it ({card})")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    queued = steps[1:]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for st in queued:
        batch.render_camera_batch(staged, st)
    torch.cuda.synchronize()
    queued_ms = (time.perf_counter() - t0) * 1e3
    busy = {}
    for what, work in (("step", [step]), ("queued", queued)):
        with torch.profiler.profile(activities=acts) as prof:
            for st in work:
                batch.render_camera_batch(staged, st)
            torch.cuda.synchronize()
        dev = device_activities(prof)
        if not dev:
            raise AssertionError("the profiler recorded no device activity")
        busy[what] = (union_us((a, b) for _n, a, b in dev) / 1e3, len(dev))
    busy_ms, n_dev = busy["step"]
    wall_ms = float(np.median(walls))
    q_busy = busy["queued"][0]
    ev_ms = float(np.median(card_ms))
    # the profiler can miss a graph's kernels (PERF.md, open questions):
    # under half the events' time, its share is not the card's
    traced = busy_ms >= 0.5 * ev_ms
    prof_txt = (
        f"under the profiler a step's device busy {busy_ms:.3f} ms of "
        f"{wall_ms:.3f} ms wall: busy share {busy_ms / wall_ms:.4f} ({n_dev} "
        f"device activities); 4 steps queued back to back: device busy "
        f"{q_busy:.3f} ms of {queued_ms:.3f} ms wall, busy share "
        f"{q_busy / queued_ms:.4f}" if traced else
        f"the profiler recorded {busy_ms:.3f} ms of device activity in a "
        f"step ({n_dev} activities), under half the events' time: it missed "
        "the graphs' kernels, and its busy share is not reported")
    log(f"[rollout] cams/s at {N_ROLLOUT_CAMS} cameras, 4 steps a run, runs "
        f"in turns (staged, full width, full width, staged): staged batch "
        f"graphs (the default) {cps[True][0]:.2f}, {cps[True][1]:.2f}; "
        f"full-width batch graphs {cps[False][0]:.2f}, {cps[False][1]:.2f}; "
        f"launches a step (staged graphs): "
        f"roll {per_step['roll_chunk']:.1f}, rasterize "
        f"{per_step['rasterize_visits']:.1f}, loop control "
        f"{per_step['march_loop']:.1f}, phase 2 "
        f"{per_step['reproject_screens']:.1f} (iterations from the device "
        f"counter); the card's time a step for the marches and phase 2 "
        f"(events, the init's excluded) {ev_ms:.3f} ms of a {wall_ms:.3f} ms "
        f"step: busy share {ev_ms / wall_ms:.4f}; {prof_txt} ({card})")
    return {"launches": launches, "cams_per_sec": cps, "phase2": p2,
            "busy_share": ev_ms / wall_ms,
            "busy_share_profiler": busy_ms / wall_ms if traced else None,
            "busy_share_queued": q_busy / queued_ms if traced else None,
            "card_ms_per_step": ev_ms, "step_ms": wall_ms,
            "iterations_per_step": it_steps,
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
    """``fn()`` with the kernels' launch counts and the gated march's counts
    set to 0 just before it and added to ``tally`` just after it (the gate
    and rewind kernels' launches, each equal to the gated iterations)."""
    from cpuvox_tpu_torch.ops import march_loop
    from cpuvox_tpu_torch.render import raymarch

    march_loop.reset_launches()
    raymarch.gated_stats.reset()
    out = fn()
    gated = gated_counts("[shard]")
    for k, v in (*march_loop.kernel_launches().items(),
                 ("gate", gated["gate_launches"]),
                 ("gate_rewind", gated["rewind_launches"]),
                 ("gated_iterations", gated["iterations"])):
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
    with host_loop(sr.inner):
        held_run(f"{tag} strict subset, {cams[-1].position}",
                 lambda: sr.render(cams[-1]), stats)
    check_window_path(tag, sr, plain)
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
        f"{sr.inner._wa.win.tolist()} (the "
        f"{'gated group' if cap.gated else 'dense chunk'} after {k} "
        f"iterations, {n_lod0} valid LOD0 cells, {written} texels written) "
        f"== plain, and the previous design on the same cells == plain, 0 "
        f"elements differ")
    return sr


SHARD_WINDOW_FRAMES = 12  # the path of the window check


def check_window_path(tag: str, sr, plain) -> None:
    """The world-shard window over the benchmark path at the strict-subset
    radius, the inner Renderer on the graph route, uncompacted and staged:
    the window's corner moves with the camera, and the inner march graph's
    captures and ``memory_reserved`` must not grow with the moves.  The
    window is a device tensor (``WorldArrays.win``), so a move of the same
    width is a copy into the graph's own world (``MarchGraph.world``): a
    variant is captured at most twice (on the Renderer's first world, then
    on the graph's copy), and the pool stops growing with the last
    capture."""
    ref = with_lod0(plain, SHARD_LOD0_RADIUS)
    sr.inner.lod_distances = ref.lod_distances.copy()
    sr.inner.far_clip = ref.far_clip
    path = [path_camera(plain, t)
            for t in np.linspace(0.0, 1.0, SHARD_WINDOW_FRAMES)]
    rows = []
    for compact in (False, True):
        sr.inner.compact = compact
        corners, caps, reserved = [], [], []
        for cam in path:
            sr.render(cam)
            corners.append(sr._window_key[:2])
            caps.append(len(sr.inner._graph.captures))
            reserved.append(torch.cuda.memory_reserved(sr.inner.device))
        slots = {(c["direction"], c["widths"])
                 for c in sr.inner._graph.captures}
        moves = sum(a != b for a, b in zip(corners, corners[1:]))
        last = max(i for i in range(len(caps))
                   if i == 0 or caps[i] != caps[i - 1])
        moves_after = sum(a != b for a, b in
                          zip(corners[last:], corners[last + 1:]))
        if (caps[-1] - caps[0] > 2 * len(slots)
                or len(set(reserved[last:])) != 1):
            raise AssertionError(
                f"[shard] {tag} window path (compact={compact}): corners "
                f"{corners}, captures {caps}, memory_reserved {reserved}")
        rows.append((compact, moves, caps[0], caps[-1], moves_after,
                     reserved[last], reserved[-1]))
    sr.inner.compact = plain.compact
    log(f"[shard] {tag} window path, {SHARD_WINDOW_FRAMES} path cameras at "
        f"lod_distances[0] {SHARD_LOD0_RADIUS:.0f}, the inner Renderer on "
        f"the graph route (compact, window moves, captures after the first "
        f"frame and at the end, moves after the last capture, "
        f"memory_reserved after the last capture and at the end): {rows}; "
        f"the captures do not grow with the moves ({card_line()})")


def sync_all() -> None:
    """Wait for every card a sharded run may have used."""
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def reserved_all() -> list:
    return [torch.cuda.memory_reserved(i)
            for i in range(torch.cuda.device_count())]


def time_turns(fns: dict, reps_each: int) -> dict:
    """Each function's host times in ms, synced, in turns a, b, c, c, b,
    a."""
    names = list(fns)
    order = names + names[::-1]
    ms = {n: [] for n in names}
    for _ in range(reps_each):
        for n in order:
            sync_all()
            t0 = time.perf_counter()
            fns[n]()
            sync_all()
            ms[n].append((time.perf_counter() - t0) * 1e3)
    return ms


def on_host(renderer, fn):
    """``fn()`` with ``renderer`` on the host loop (``host_loop``)."""
    with host_loop(renderer):
        return fn()


def shard_graphs(renderer, role: str, rmesh=None) -> list:
    """The Renderer's march graphs of one ``role`` of shard ("ray",
    "cam"), with ``rmesh`` only those of its slots and devices."""
    return [g for k, g in renderer._shard_graphs.items() if k[0] == role
            and (rmesh is None or (k[1] < rmesh.n_ray_shards
                                   and k[4] == rmesh.devices[k[1]]))]


def n_captures(graphs) -> int:
    return sum(len(g.captures) for g in graphs)


def capture_txt(graphs) -> str:
    """Each shard graph's captures: direction, capture / instantiation ms
    and the private pool's growth in bytes."""
    return "; ".join(
        f"{g.shape[0]} rays: " + ", ".join(
            f"{c['direction']:+d} {c['capture_ms']:.1f} / "
            f"{c['instantiate_ms']:.1f} ms, {c['pool_bytes']} B"
            for c in g.captures) for g in graphs)


def silent(fn):
    """``fn()`` after a sync, under ``set_sync_debug_mode("error")``: any
    read from the card raises."""
    sync_all()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def overlap(run, devices) -> dict:
    """``run(spans)`` once, its shards' work on their streams between
    timing events: the shards' summed span over their union span (above 1,
    they overlapped).  The events of two cards share no clock, so each
    card's times count from a reference event recorded on it right after a
    sync of every card, the references one after another at one host
    moment (apart by the host's time between two records, microseconds)."""
    sync_all()
    refs = {}
    for d in dict.fromkeys(devices):  # before every shard's start
        refs[d.index] = torch.cuda.Event(enable_timing=True)
        refs[d.index].record(torch.cuda.current_stream(d))
    spans: list = []
    run(spans)
    sync_all()
    cards = len(refs)

    def since_ref(e) -> float:
        ref = refs[e.device.index] if cards > 1 else next(iter(refs.values()))
        return ref.elapsed_time(e)

    rel = [(since_ref(a), since_ref(b)) for a, b in spans]
    summed = sum(b - a for a, b in rel)
    union = max(b for _a, b in rel) - min(a for a, _b in rel)
    return {"ratio": summed / union, "txt": (
        f"{summed / union:.3f} (the {len(rel)} shards' spans sum to "
        f"{summed:.3f} ms over a union of {union:.3f} ms; each from the "
        f"frame's start{'' if cards == 1 else f', on {cards} cards, each from its reference'}: "
        + ", ".join(f"{a:.3f}-{b:.3f}" for a, b in rel) + ")")}


@contextlib.contextmanager
def one_stream(rmesh):
    """Within the block the camera-sharded batch queues its blocks in turn
    on the current stream, each through the batch graph of its bucket and
    device (``Renderer.march_batch_graph``): the route before each block
    had a graph and a stream of its own, which ``render_camera_batch``
    takes where the mesh reports itself off the graphs."""
    rmesh.on_graphs = lambda renderer: False
    try:
        yield rmesh
    finally:
        del rmesh.on_graphs


def magenta(screens) -> int:
    from cpuvox_tpu_torch.render.raymarch import MAGENTA_I32

    return sum(int((torch.as_tensor(np.ascontiguousarray(x).view(np.int32))
                    if isinstance(x, np.ndarray) else x.cpu()).eq(
        MAGENTA_I32).sum()) for x in screens)


def turns_txt(ms: dict) -> str:
    return "; ".join(f"{k} {float(np.median(v)):.3f} (all "
                     f"{np.round(v, 3).tolist()})" for k, v in ms.items())


def warm_checks(tag: str, run, graphs, first, want, stats: dict,
                frames) -> str:
    """A sharded program's warm checks: ``run(first)`` (the device program
    on a camera or a batch, its screens on the first device) under
    ``set_sync_debug_mode("error")`` == ``want``; then over ``frames``
    (more warm runs), no capture in ``graphs()`` and ``memory_reserved``
    flat.  Returns the line's text."""
    got = silent(lambda: run(first))
    compare_screens(f"[shard] {tag} silent", [got], [want], stats)
    sync_all()
    caps, reserved = n_captures(graphs()), reserved_all()
    for f in frames:
        run(f)
    sync_all()
    if (n_captures(graphs()), reserved_all()) != (caps, reserved):
        raise AssertionError(
            f"[shard] {tag}: warm runs captured ({caps} -> "
            f"{n_captures(graphs())}) or grew memory_reserved ({reserved} "
            f"-> {reserved_all()})")
    return (f"a warm run silent under set_sync_debug_mode('error') up to "
            f"the screen's copy, == the unsharded one; {len(frames)} more "
            f"warm runs: no capture, memory_reserved {reserved} unchanged")


def check_ray_sharded(tag: str, plain, rmesh, where: str, tally: dict,
                      stats: dict) -> dict:
    """(c) ``render_frame_sharded`` over ``rmesh`` on three path cameras,
    each shard in its own staged march graph on its own stream: == the
    unsharded frame == the sharded host loop, 0 magenta; launches a frame,
    the shards' graph launches and iterations by stage; one more frame on
    the host loop with its kernel calls held against their plain versions;
    a warm frame with no host read, no capture and ``memory_reserved`` flat
    over warm frames; the shards' overlap by events; the shard graphs'
    captures; frame ms in turns: sharded graphs, unsharded, sharded host
    loop."""
    from cpuvox_tpu_torch.ops import march_loop
    from cpuvox_tpu_torch.parallel.mesh import (render_frame_sharded,
                                                render_frame_sharded_device,
                                                sharded_frame_rays)

    cams = [path_camera(plain, t) for t in SHARD_PATH_T]
    own: dict = {}
    got = shard_counts_run(own, lambda: [
        render_frame_sharded(plain, c, rmesh) for c in cams])
    graph_launches = march_loop.graph_stats["launches"]
    by_width = march_loop.stage_stats.read()
    for k, v in own.items():
        tally[k] = tally.get(k, 0) + v
    graphs = [g for g in shard_graphs(plain, "ray", rmesh)
              if g.shape[0] == sharded_frame_rays(plain, rmesh) //
              rmesh.n_ray_shards]
    n = rmesh.n_ray_shards
    if graph_launches != n * len(cams) or len(graphs) != n:
        raise AssertionError(f"[shard] {tag} ray-sharded: {graph_launches} "
                             f"graph launches and {len(graphs)} shard graphs "
                             f"for {len(cams)} frames over {n} shards")
    want = [plain.render(c) for c in cams]
    host = [on_host(plain, lambda c=c: render_frame_sharded(plain, c, rmesh))
            for c in cams]
    compare_screens(f"[shard] {tag} ray-sharded", got, want, stats)
    compare_screens(f"[shard] {tag} ray-sharded host loop", host, want,
                    stats)
    n_mag = magenta(got)
    if n_mag:
        raise AssertionError(f"[shard] {tag} ray-sharded: {n_mag} magenta")
    with host_loop(plain):
        held_run(f"(c) {tag} ray-sharded over {where}, host loop",
                 lambda: render_frame_sharded(plain, cams[1], rmesh), stats)
    warm = warm_checks(
        f"{tag} ray-sharded",
        lambda c: render_frame_sharded_device(plain, c, rmesh),
        lambda: graphs, cams[1],
        torch.from_numpy(want[1].view(np.int32)), stats, cams)
    ov = overlap(lambda spans: render_frame_sharded_device(
        plain, cams[1], rmesh, spans), rmesh.devices)
    ms = {"sharded graphs": [], "unsharded": [], "sharded host loop": []}
    for c in cams:
        m = time_turns({
            "sharded graphs": lambda: render_frame_sharded(plain, c, rmesh),
            "unsharded": lambda: plain.render(c),
            "sharded host loop": lambda: on_host(
                plain, lambda: render_frame_sharded(plain, c, rmesh))}, 1)
        for k in ms:
            ms[k] += m[k]
    caps = n_captures(graphs)
    per_frame = {k: v / len(cams) for k, v in own.items()}
    log(f"[shard] (c) {tag} {MAIN_WH[0]}x{MAIN_WH[1]}, one camera's rays "
        f"over {where} ({n} shards of {graphs[0].shape[0]} rays, stages "
        f"{plain.stage_widths(graphs[0].shape[0])}, each its own graph on "
        f"its own stream): {len(cams)} path cameras == the unsharded frame "
        f"== the sharded host loop, 0 pixels differ, 0 magenta; a frame "
        f"launches {graph_launches / len(cams):.1f} graphs, roll "
        f"{per_frame['roll_chunk']:.1f}, rasterize "
        f"{per_frame['rasterize_visits']:.1f}, phase 2 "
        f"{per_frame['reproject_screen']:.1f}; iterations by stage width "
        f"{by_width}; {warm}; overlap {ov['txt']}; the shard graphs' "
        f"captures (direction capture / instantiate ms, pool bytes): "
        f"{capture_txt(graphs)}; frame ms in turns (median of "
        f"{len(ms['unsharded'])}): {turns_txt(ms)} ({card_line()})")
    if n_captures(graphs) != caps:
        raise AssertionError(f"[shard] {tag}: the timed frames captured")
    return {"ms": {k: float(np.median(v)) for k, v in ms.items()},
            "overlap": ov["ratio"]}


def check_composed(tag: str, sr, plain, rmesh, where: str, tally: dict,
                   stats: dict) -> dict:
    """(d) the composed mode: LOD0 striped in tiles with the strict-subset
    window, one camera's rays over ``rmesh``, each shard in its own graph.
    Over the window path (``SHARD_WINDOW_FRAMES`` path cameras): every
    frame == the unsharded Renderer's, 0 magenta; a second pass moves the
    window as often with no capture and ``memory_reserved`` flat; a warm
    frame with no host read; one frame on the host loop held against the
    plain versions; the overlap; frame ms in turns: composed graphs,
    unsharded, composed host loop; over several cards, the replicas'
    copy a window move."""
    from cpuvox_tpu_torch.parallel.mesh import render_frame_sharded_device

    sr.ray_mesh = rmesh
    ref = with_lod0(plain, SHARD_LOD0_RADIUS)
    sr.inner.lod_distances = ref.lod_distances.copy()
    sr.inner.far_clip = ref.far_clip
    r = sr.inner
    path = [path_camera(plain, t)
            for t in np.linspace(0.0, 1.0, SHARD_WINDOW_FRAMES)]
    got = shard_counts_run(tally, lambda: [sr.render(c) for c in path])
    compare_screens(f"[shard] {tag} composed", got,
                    [ref.render(c) for c in path], stats)
    n_mag = magenta(got)
    if n_mag:
        raise AssertionError(f"[shard] {tag} composed: {n_mag} magenta")
    graphs = shard_graphs(r, "ray")
    sync_all()
    caps, reserved = n_captures(graphs), reserved_all()
    corners = [sr._window_key]
    for c in path:
        sr.render(c)
        corners.append(sr._window_key)
    sync_all()
    moves = sum(a != b for a, b in zip(corners, corners[1:]))
    if moves == 0 or (n_captures(graphs), reserved_all()) != (caps,
                                                              reserved):
        raise AssertionError(
            f"[shard] {tag} composed path: {moves} moves, captures {caps} "
            f"-> {n_captures(graphs)}, memory_reserved {reserved} -> "
            f"{reserved_all()}")
    cam = path[len(path) // 2]
    sr.render(cam)  # its window: a warm frame moves nothing
    want = torch.from_numpy(ref.render(cam).view(np.int32))
    got1 = silent(lambda: render_frame_sharded_device(r, cam, rmesh))
    compare_screens(f"[shard] {tag} composed silent", [got1], [want], stats)
    with host_loop(r):
        held_run(f"(d) {tag} composed, host loop", lambda: sr.render(cam),
                 stats)
    ov = overlap(lambda spans: render_frame_sharded_device(
        r, cam, rmesh, spans), rmesh.devices)
    ms = time_turns({
        "composed graphs": lambda: sr.render(cam),
        "unsharded": lambda: ref.render(cam),
        "composed host loop": lambda: on_host(r, lambda: sr.render(cam))}, 2)
    replica = ""
    others = [d for d in dict.fromkeys(rmesh.devices) if d != r.device]
    if others:  # a window move copies the active world to each other card
        nbytes = sum(x.numel() * x.element_size() for x in r._wa
                     if isinstance(x, torch.Tensor))
        copy_ms = []
        for _ in range(3):
            sync_all()
            t0 = time.perf_counter()
            for d in others:
                [x.to(d) for x in r._wa if isinstance(x, torch.Tensor)]
            sync_all()
            copy_ms.append((time.perf_counter() - t0) * 1e3)
        replica = (f"; a window move's replicas: {nbytes} B to each of "
                   f"{len(others)} other cards, {np.round(copy_ms, 3).tolist()}"
                   " ms (host clock, synced)")
    log(f"[shard] (d) {tag} composed: LOD0 over the world shard's devices "
        f"(window {sr._window_key}), the camera's rays over {where}: "
        f"{len(path)} path cameras == the unsharded Renderer, 0 pixels "
        f"differ, 0 magenta ({caps} shard-graph captures); a second pass: "
        f"{moves} window moves, no capture, memory_reserved {reserved} "
        f"unchanged; a warm frame silent under set_sync_debug_mode('error') "
        f"up to the screen's copy; overlap {ov['txt']}; captures "
        f"{capture_txt(graphs)}; frame ms in turns: {turns_txt(ms)}"
        f"{replica} ({card_line()})")
    return {"ms": {k: float(np.median(v)) for k, v in ms.items()},
            "overlap": ov["ratio"]}


def check_camera_sharded(rmesh, where: str, tally: dict, stats: dict) -> dict:
    """(e) the rollout's 64 cameras at 256x256 over ``rmesh``, each camera
    block bucketed and marched through a batch graph of its own on its own
    stream: the batch == the unsharded batch == the sharded host loop, 0
    magenta; once more on the host loop (compaction on) with its kernel
    calls (each camera block's march and phase 2) held against their plain
    versions; a warm step with no host read, no capture and
    ``memory_reserved`` flat over warm steps; the blocks' overlap; cams/s
    in turns: sharded graphs, unsharded, the blocks queued on one stream
    (``one_stream``), sharded host loop."""
    from cpuvox_tpu_torch.bench import harness
    from cpuvox_tpu_torch.ops import march_loop
    from cpuvox_tpu_torch.parallel.batch import render_camera_batch

    r = harness.rollout_renderer(ROLLOUT_WH)
    dims = r.device_world.dims
    cams = harness.rollout_cameras(1, N_ROLLOUT_CAMS, ROLLOUT_WH, dims)
    got = shard_counts_run(tally, lambda: render_camera_batch(r, cams,
                                                              rmesh=rmesh))
    graph_launches = march_loop.graph_stats["launches"]
    graphs = shard_graphs(r, "cam")
    blocks = sorted((k[1], k[2] // r.ray_capacity, str(k[4]))
                    for k in r._shard_graphs if k[0] == "cam")
    if not blocks or graph_launches != 2 * rmesh.n_ray_shards:
        raise AssertionError(f"[shard] (e) {graph_launches} graph launches, "
                             f"blocks {blocks}")
    want = render_camera_batch(r, cams)
    compare_screens("[shard] rollout camera-sharded", [got], [want], stats)
    compare_screens("[shard] rollout camera-sharded host loop", [on_host(
        r, lambda: render_camera_batch(r, cams, rmesh=rmesh))], [want],
        stats)
    n_mag = magenta([got])
    if n_mag:
        raise AssertionError(f"[shard] (e) {n_mag} magenta")
    host = dataclasses.replace(r, compact=True)
    with host_loop(host):
        held_run(f"(e) rollout camera-sharded over {where} (host loop)",
                 lambda: render_camera_batch(host, cams, rmesh=rmesh), stats)
    steps = [harness.rollout_cameras(2 + s, N_ROLLOUT_CAMS, ROLLOUT_WH, dims)
             for s in range(SHARD_ROLLOUT_STEPS)]
    warm = warm_checks("rollout camera-sharded",
                       lambda st: render_camera_batch(r, st, rmesh=rmesh),
                       lambda: shard_graphs(r, "cam"), steps[0],
                       render_camera_batch(r, steps[0]), stats, steps)
    ov = overlap(lambda spans: render_camera_batch(r, steps[1], rmesh=rmesh,
                                                   spans=spans),
                 rmesh.devices)

    def run(mesh, loop=False):
        for st in steps:
            if loop:
                on_host(r, lambda: render_camera_batch(r, st, rmesh=mesh))
            else:
                render_camera_batch(r, st, rmesh=mesh)

    def run_one_stream():
        with one_stream(rmesh):
            run(rmesh)

    with one_stream(rmesh):  # its batch graphs captured before the turns
        compare_screens("[shard] rollout camera-sharded one stream", [
            render_camera_batch(r, st, rmesh=rmesh) for st in steps],
            [render_camera_batch(r, st) for st in steps], stats)
    caps = n_captures(graphs)
    ms = time_turns({"sharded graphs": lambda: run(rmesh),
                     "unsharded": lambda: run(None),
                     "sharded one stream": run_one_stream,
                     "sharded host loop": lambda: run(rmesh, True)}, 1)
    if n_captures(graphs) != caps:
        raise AssertionError("[shard] (e) the timed steps captured")
    n = N_ROLLOUT_CAMS * SHARD_ROLLOUT_STEPS
    cps = {k: [n / (t / 1e3) for t in v] for k, v in ms.items()}
    log(f"[shard] (e) rollout{N_ROLLOUT_CAMS} {ROLLOUT_WH[0]}x"
        f"{ROLLOUT_WH[1]} over {where}: the camera-sharded batch, each "
        f"block in its own batch graph on its own stream (slot, bucket, "
        f"device: {blocks}; {graph_launches} graph launches a step) == the "
        f"unsharded batch == the sharded host loop, 0 pixels differ, 0 "
        f"magenta; {warm}; overlap {ov['txt']}; captures "
        f"{capture_txt(graphs)}; cams/s in turns ({n} cameras a run): "
        + "; ".join(f"{k} {np.round(v, 2).tolist()}" for k, v in cps.items())
        + f" ({card_line()})")
    return {"cams_per_sec": {k: float(np.median(v)) for k, v in cps.items()},
            "overlap": ov["ratio"]}


def check_shard(card: str, stats: dict, terrain, terrain_lods, layered,
                layered_lods) -> dict:
    """The multi-device renderer (``parallel/``) on the card, its shards
    ``N_SHARDS`` repeats of it: (a) terrain2048 and (b) layered2048 world
    sharded at the default LOD0 radius and with a strict-subset window, (f)
    the rasterizer's window on a capture of each, (c) the ray-sharded frame
    on both, (d) the composed mode on both, (e) the camera-sharded
    rollout.  Every screen == the unsharded Renderer's, and in one more run
    of each the kernel calls == their plain versions.  The launch counts
    of the sharded runs (not of their comparisons) are the ``shard``
    path's, returned by kernel.  With more than one card, (a), (c), (d)
    and (e) again over the real cards."""
    from cpuvox_tpu_torch.parallel import RenderMesh

    t0 = time.perf_counter()
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
    summary = {}
    for tag, _lods, plain in worlds:
        summary[f"(c) {tag}"] = check_ray_sharded(tag, plain, rmesh, where,
                                                  tally, stats)
    for tag, _lods, plain in worlds:
        summary[f"(d) {tag}"] = check_composed(
            tag, sharded.pop(tag), plain, rmesh, where, tally, stats)
    summary["(e)"] = check_camera_sharded(rmesh, where, tally, stats)
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        cards = [torch.device("cuda", i) for i in range(n_cards)]
        where = f"{n_cards} cards"
        real = RenderMesh.create(cards)
        sr = check_world_shard("terrain2048", terrain_lods, terrain, cards,
                               where, {}, stats)
        for tag, _lods, plain in worlds:
            check_ray_sharded(tag, plain, real, where, {}, stats)
        check_composed("terrain2048", sr, terrain, real, where, {}, stats)
        check_camera_sharded(real, where, {}, stats)
    else:
        log(f"[shard] one card ({card}): (a), (c), (d) and (e) did not run "
            "over several cards")
    if min(tally.get(k, 0) for k in ("roll_chunk", "rasterize_visits",
                                      "reproject_screen",
                                      "reproject_screens")) <= 0:
        raise AssertionError(f"[shard] launches {tally}: a kernel of the "
                             "path did not run")
    log(f"[shard] launches of the sharded runs: {tally}")
    log(f"[shard] summary over {N_SHARDS} shards of {dev}: {json.dumps(summary)} "
        f"({time.perf_counter() - t0:.1f} s for the phase; {card})")
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


def gate_work(cap, gated: dict):
    """Bytes and operations one gate launch needs on this data: the valid
    flag of every step and the other five visit fields of each valid step;
    one 32-byte occupancy row per distinct tile the valid steps within the
    tile budget read; the snapshot (7 words) of each ray with more gated
    cells than its group; a ray's window, narrowing flag and liveness (and
    its index slot); written: the packed group (16 + 1 B a slot), count, cap
    and the snapshot.  About 60 operations a valid step."""
    from cpuvox_tpu_torch.render import raymarch

    visits, g = gated["visits"], gated["g"]
    C, _f, Rk = visits.shape
    GK = g.cells.rows.shape[0]
    valid = visits[:, 5] != 0
    lod = visits[:, 4]
    lodc = lod.clamp(0, 7)
    ti = raymarch._occ_tile_index(cap.wa, lodc, lod, visits[:, 0] >> lod,
                                  visits[:, 1] >> lod)
    new = torch.ones_like(valid)
    new[1:] = ti[1:] != ti[:-1]
    slot = torch.cumsum(new.to(torch.int32), 0) - 1
    rows = ti.clamp(0, cap.wa.occ_tiles.shape[0] - 1)[valid & (slot < C // 8
                                                                + 4)]
    n_valid = int(valid.sum())
    per_ray = 11 + (0 if cap.index is None else 4)
    nbytes = (4 * C * Rk + 20 * n_valid + 32 * torch.unique(rows).numel()
              + 28 * int((g.count > GK).sum()) + per_ray * Rk
              + 17 * GK * Rk + 36 * Rk)
    return nbytes, 60 * n_valid


def rewind_work(cap, gated: dict):
    """Bytes and operations one rewind launch needs: a slot's count, cap and
    the ray's liveness (and index slot); a rewound ray's snapshot, its LOD,
    tdelta and stp read and its DDA state and liveness written; about 20
    operations a slot."""
    Rk = gated["g"].count.shape[0]
    per_ray = 9 + (0 if cap.index is None else 4)
    return per_ray * Rk + 93 * gated["rewound"] + 8, 20 * Rk


def time_gate(cap, gated: dict) -> dict:
    """The gate and rewind kernels' times at the capture's shapes (as
    ``time_kernels`` times the others: per call, the device's own time a
    launch, the plain version, the bound)."""
    from cpuvox_tpu_torch.bench.capture import clone
    from cpuvox_tpu_torch.ops import gate_kernel

    visits, g = gated["visits"], gated["g"]
    GK = g.cells.rows.shape[0]
    counters = torch.zeros(3, dtype=torch.int64, device=visits.device)

    def gate(fn):
        return lambda rs: fn(cap.wa, visits, rs, cap.consts, GK, counters,
                             index=cap.index)

    def rewind(fn):
        return lambda a: fn(*a, gated["rs"], g, index=cap.index)

    def rewind_setup():
        return (clone(gated["dda"]), gated["alive"].clone(),
                torch.zeros((), dtype=torch.int64, device=visits.device),
                counters)

    out = {}
    for name, kern, plain, setup, work in (
            ("gate", gate(gate_kernel.gate), gate(gate_kernel.gate_ref),
             lambda: clone(cap.rs), gate_work(cap, gated)),
            ("gate_rewind", rewind(gate_kernel.rewind),
             rewind(gate_kernel.rewind_ref), rewind_setup,
             rewind_work(cap, gated))):
        time_ms(kern, 2, setup)  # warm
        b_ms, b_by = bound(*work)
        out[name] = {"ms": time_ms(kern, 20, setup),
                     "device_ms": device_ms(kern, setup, 20),
                     "plain_ms": time_ms(plain, 5, setup),
                     "rays": rays_worked(cap), "bound_ms": b_ms,
                     "bound_by": b_by, "bytes": int(work[0]),
                     "operations": int(work[1]), "library_ms": None,
                     "overflow_steps": gated["overflow"],
                     "rewound": gated["rewound"]}
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
    # the three main paths march through the staged graph (compact=True,
    # the Renderer's default on the card); [loop] and a variant of each
    # small frame run the full-width graph (compact=False)
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
    # [loop]: the full-width march, then the staged, a graph launch a frame
    loop: dict = {"kernel": check_loop_kernel(terrain, stats)}
    check_loop(dataclasses.replace(terrain, compact=False), "terrain2048",
               card, stats, loop)
    check_loop_staged(terrain, "terrain2048", card, stats, loop)
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
    check_loop_staged(argb, "terrain2048 ARGB", card, stats, loop)
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
    g_times = time_gate(busiest[0], busiest[2])
    l_times = time_kernels({
        "roll": busiest[0], "raster": busiest[:2],
        "phase2": (p2args, sample_maps(layered, f.tables)),
        "roll_previous": prev_roll["previous design"],
        "dims": dw.dims, "plain_reps": 1})
    check_loop(dataclasses.replace(layered, compact=False), "layered2048",
               card, stats, loop)
    check_loop_staged(layered, "layered2048", card, stats, loop)
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
        "launches": l_launches["march_loop"],
        "max_abs_err": stats["march_loop"]["max_abs_err"],
        "ms": lk["ms"], "device_ms": lk["device_ms"],
        "plain_ms": lk["plain_ms"], "bound_ms": lk["bound_ms"],
        "bound_by": lk["bound_by"], "library_ms": lk["library_ms"],
        "launches_by_path": {
            "terrain2048": t_launches["march_loop"],
            "terrain2048_argb": a_launches["march_loop"],
            "layered2048": l_launches["march_loop"],
            **{f"loop {p}": loop[p]["launches"]["march_loop"]
               for p in LOOP_PATHS},
            "rollout64_256x256": rollout["launches"]["march_loop"],
            "shard": shard["march_loop"]}})
    # the gated march's counts by path, each read from the device after the
    # path's counted runs (``gated_counts``; ``shard`` sums its runs')
    gated_by_path = {
        "layered2048": l_launches["gated"],
        **{f"loop {p}": loop[p]["gated"] for p in LOOP_PATHS},
        **{f"loop {p} staged": loop[p]["staged"]["gated"]
           for p in LOOP_PATHS},
        "shard": {"gate_launches": shard["gate"],
                  "rewind_launches": shard["gate_rewind"],
                  "iterations": shard["gated_iterations"]}}
    for (kname, replaces), t, key in zip(
            GATE_KERNELS, (g_times["gate"], g_times["gate_rewind"]),
            ("gate_launches", "rewind_launches")):
        by_path = {p: c[key] for p, c in gated_by_path.items()}
        its = {p: c["iterations"] for p, c in gated_by_path.items()}
        log(f"[time] {kname} at layered2048's shapes ({t['rays']} rays): "
            f"kernel {t['ms']:.4f} ms a call, {t['device_ms']:.4f} ms on the "
            f"device a launch, plain {t['plain_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {t['bytes']} B, "
            f"{t['operations']} ops); {stats[kname]['mismatches']} "
            f"mismatches against the plain version, tolerance 0; launches "
            f"counted by the kernel on the device, by path, {by_path} (gated "
            f"iterations {its}) ({card})")
        row = {
            "name": kname, "route": "cuda", "source": GATE_SOURCE,
            "replaces": replaces, "launches": by_path["layered2048"],
            "max_abs_err": stats[kname]["max_abs_err"],
            "ms": t["ms"], "device_ms": t["device_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "launches_by_path": by_path,
            "gated_iterations_by_path": its}
        if kname == "gate":
            row["overflow_steps_by_path"] = {
                p: c["overflow_steps"] for p, c in gated_by_path.items()
                if "overflow_steps" in c}
        kernels.append(row)
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
        st = v["staged"]
        log(f"[summary] [loop] {p} staged (widths {st['widths']}) against "
            f"uncompacted, in turns: frame p50 sequential ms staged "
            f"{np.round(st['seq_ms'][True], 3).tolist()}, uncompacted "
            f"{np.round(st['seq_ms'][False], 3).tolist()}; pipelined ms "
            f"staged {np.round(st['pipe_ms'][True], 3).tolist()}, "
            f"uncompacted {np.round(st['pipe_ms'][False], 3).tolist()}; "
            f"staged captures (direction: capture ms, pool bytes) "
            + ", ".join(f"{c['direction']:+d}: {c['capture_ms']:.2f}, "
                        f"{c['pool_bytes']}" for c in st["captures"])
            + f" ({card})")
    log(f"[summary] rollout cams/s (batch march graphs uncompacted, "
        f"staged): "
        f"{rollout['cams_per_sec'][False]}, {rollout['cams_per_sec'][True]}, "
        f"the card's time {rollout['card_ms_per_step']:.3f} ms of a "
        f"{rollout['step_ms']:.3f} ms step (busy share "
        f"{rollout['busy_share']:.4f}; by the profiler "
        f"{rollout['busy_share_profiler']} a step, "
        f"{rollout['busy_share_queued']} queued); dynamic fps exact_lod1 "
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
