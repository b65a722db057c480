"""Drive the PyTorch port's main paths on one CUDA card and check every kernel.

Run from the repository root, on a machine with an NVIDIA H100 (sm_90a) and
``nvcc``:

    python3 chip_smoke.py

Phases; each prints its own lines, and any mismatch or exception exits
non-zero (no phase catches its own failure):

1. device: requires CUDA, prints the card's name and power limit, and holds
   the card's f32 ``/`` and ``sqrt`` against numpy's on a million values;
2. build: compiles the three kernels (``cpuvox_tpu_torch/csrc/*.cu``) and
   prints each one's registers and spills (``cuobjdump -res-usage``);
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
   full width, the sample on that frame's reprojection maps; then a 64^3
   random world at 160x120 against the numpy oracle; one 320x180 frame
   through the kernels, the plain path, the kernels without compaction and
   the kernels with device ray init (bit-equal); the 1920x1080 flythrough
   (24 frames) with launch counts, index rebuilds and mean rays a chunk, a
   magenta check, fps and frame p50, and no torch column fetch on the way;
4. terrain2048 in ARGB mode (``argb_records=True``, with
   ``host_init=False``: device ray init): the records' shape and
   ``max_col_colors``; both rasterizers with MCC 13 on a 1080p chunk
   against their plain version; one 320x180 frame three ways (ARGB
   kernels, ARGB plain, index-mode kernels: equal screens); the 1920x1080
   flythrough (24 frames) with 0 magenta; the same frames through both
   modes in turns
   (each mode's frame p50), and three of them against index mode's screen;
5. the split record layout: a small world of about 128 runs a column, both
   rasterizers at that MAXR against their plain version, one frame against
   the plain path;
6. layered2048, the occupancy-gated march (``bench.py``'s deep, mostly
   empty headline scene): (a) the device world, whose gate must resolve on,
   and device against host init at its dims; (b) the roll at chunk 128 and
   both rasterizers on a packed group of 16 gated cells at MAXR 29, mid-march,
   with the live-ray index and at full width, against their plain versions,
   in both iteration directions; (c) one 320x180 frame five ways, equal
   raybuffers and screens: gated kernels, gated plain versions, dense
   kernels, gated kernels without compaction, gated kernels with device ray
   init; (d) the 1920x1080 flythrough
   (24 frames) with 0 magenta, every kernel launched and busy rays rewound;
7. each kernel's time against its plain version, its bound and, where one
   PyTorch call computes the same function, that call's time, at each
   path's shapes: per call by CUDA events around one Python call, and the
   device's own time a launch (calls queued back to back behind a wait);
   for the rasterizer also the previous kernel design and the torch column
   fetch that feeds it, on the same inputs.

The three flythrough Renderers are created with ``compact=True`` (the march
on a live-ray index; the Renderer's default is the full-width march, which
the oracle check, the split-layout frame and a variant of each small frame
run).  Kernel launch counts are set to 0 just before each flythrough and read just
after it; launches made to compare or time a kernel are not counted.  The
last lines are the card line, one JSON line of kernels, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
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
    ("sample_raybuffer", "cpuvox_tpu_torch/csrc/sample.cu",
     "cpuvox_tpu/ops/reproject_kernel.py:64"),
]
# NVIDIA H100 SXM, published: HBM3 bandwidth and f32 rate outside the tensor
# cores (the kernels do integer and f32 scalar work)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip()


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
    log(f"[split] split record layout (max_runs {dw.max_runs}, meta records "
        f"{tuple(dw.col_rec.shape)}, {dw.runs.shape[0]} run words): "
        f"rasterize_visits == rasterize_chunk == plain at "
        f"MAXR={cap.cells.runs.shape[-1]} on "
        f"{rays_of(cap)} ({written} texels written); "
        f"{SMALL_WH[0]}x{SMALL_WH[1]} frame through the kernels == plain "
        f"path, {int((rb_a > 0).sum())} texels drawn, 0 differ")


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

    _screen, raybuf, _geom = renderer.render_device(path_camera(renderer, 0.35))
    maps = sample_maps(renderer, cap.frame.tables)
    for ri, mask in maps:
        compare("sample_raybuffer",
                [reproject_kernel.sample_raybuffer(raybuf, ri, mask)],
                [reproject_kernel.sample_raybuffer_ref(raybuf, ri, mask)], stats)
    log(f"[{tag}] sample_raybuffer == plain on that frame's maps "
        f"(LR {tuple(maps[0][0].shape)}, TD {tuple(maps[1][0].shape)}, "
        f"raybuffer {tuple(raybuf.shape)})")
    return {"roll": cap, "raster": (cap, written), "sample": (raybuf, maps)}


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


def check_small_frame(renderer, scene: str, variants):
    """One 320x180 frame through each variant: (label, config changes,
    another renderer or None, compact).  Screens must all equal the
    first's, and so must the raybuffers of the variants that share its
    renderer (an index-mode raybuffer holds indices, an ARGB one colors)."""
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
        f"{tuple(outs[0][2].shape)}, 0 texels differ")


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
    it and read just after it, and every torch column fetch counted (the
    march through the kernels must make none)."""
    from cpuvox_tpu_torch.bench.harness import run_flythrough
    from cpuvox_tpu_torch.ops import phase1_kernel, reproject_kernel
    from cpuvox_tpu_torch.ops import roll_kernel
    from cpuvox_tpu_torch.render import raymarch

    counters = (roll_kernel, phase1_kernel, reproject_kernel)
    for m in counters:
        m.launches = 0
    phase1_kernel.chunk_launches = 0
    raymarch.gated_stats.update(iterations=0, rewinds=0)
    raymarch.compact_stats.update(rebuilds=0, chunks=0, ray_slots=0)
    fetch = raymarch._fetch_columns
    fetches = []

    def counted_fetch(*args, **kw):
        fetches.append(1)
        return fetch(*args, **kw)

    raymarch._fetch_columns = counted_fetch
    try:
        metrics = run_flythrough(renderer, n_frames=N_FRAMES, log=log)
    finally:
        raymarch._fetch_columns = fetch
    launches = [m.launches for m in counters]
    gstats = dict(raymarch.gated_stats)
    cstats = dict(raymarch.compact_stats)
    if fetches or phase1_kernel.chunk_launches:
        raise AssertionError(f"{scene}: the march fetched records in torch "
                             f"{len(fetches)} times and launched the previous "
                             f"rasterizer {phase1_kernel.chunk_launches} times")
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
    frames = N_FRAMES + 2  # the harness's two warmup frames count too
    extra = (f"; {gstats['iterations'] / frames:.1f} gated iterations and "
             f"{gstats['rewinds'] / frames:.0f} rays rewound per frame"
             if gated else "")
    extra += (f"; {cstats['rebuilds'] / frames:.1f} index rebuilds a frame, "
              f"mean {cstats['ray_slots'] / cstats['chunks']:.0f} of "
              f"{renderer.ray_capacity} ray slots a chunk")
    log(f"[{scene}] {MAIN_WH[0]}x{MAIN_WH[1]} flythrough, {N_FRAMES} frames "
        f"on {card}: fps {metrics['fps']:.3f}, frame p50 "
        f"{metrics['frame_ms_p50']:.1f} ms (device span p50 "
        f"{metrics['frame_gpu_ms_p50']:.1f} ms), "
        f"{metrics['ray_columns_per_sec']:.0f} ray columns/s, 0 magenta, 0 "
        f"torch column fetches; launches roll {launches[0]}, rasterize "
        f"{launches[1]}, sample {launches[2]}{extra}")
    return dict(zip([k[0] for k in KERNELS], launches)), metrics, gstats


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
    version, bound and the one-call PyTorch equivalent where there is one.
    For the rasterizer also, on the same inputs, the time of the previous
    kernel design (``rasterize_chunk``), of the torch column fetch that
    feeds it (``raymarch.fetch_cells``), and of the two as the march ran
    them."""
    from cpuvox_tpu_torch.bench.capture import clone
    from cpuvox_tpu_torch.ops import phase1_kernel, reproject_kernel
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
    raybuf, maps = caps["sample"]
    maps_long = [(ri.long(), mask != 0) for ri, mask in maps]

    def gather_where(_):
        return [torch.where(m, torch.gather(raybuf, 0, ri), -1)
                for ri, m in maps_long]

    plain_reps = caps.get("plain_reps", 2)
    out = {}
    for name, kern, plain, library, setup, reps, work in (
            ("roll_chunk",
             lambda a: roll_kernel.roll_chunk(*a, *roll_rest, **roll_kw),
             lambda a: roll_kernel.roll_chunk_ref(*a, *roll_rest, **roll_kw),
             None, lambda: (clone(rcap.dda), rcap.alive.clone()),
             (20, plain_reps), roll_work(rcap)),
            ("rasterize_visits",
             lambda rs: phase1_kernel.rasterize_visits(
                 rs, xcap.wa, xcap.src, *rargs, **raster_kw),
             lambda rs: phase1_kernel.rasterize_visits_ref(
                 rs, xcap.wa, xcap.src, *rargs, **raster_kw), None,
             lambda: clone(xcap.rs), (10, 1), raster_work(xcap, written)),
            ("sample_raybuffer",
             lambda _: [reproject_kernel.sample_raybuffer(raybuf, *m)
                        for m in maps],
             lambda _: [reproject_kernel.sample_raybuffer_ref(raybuf, *m)
                        for m in maps], gather_where, lambda: None, (50, 10),
             sample_work(maps))):
        time_ms(kern, 2, setup)  # warm
        ms = time_ms(kern, reps[0], setup)
        dev_ms = device_ms(kern, setup, 10)
        plain_ms = time_ms(plain, reps[1], setup)
        library_ms = None
        if library is not None:
            time_ms(library, 2)
            library_ms = time_ms(library, reps[0])
        b_ms, b_by = bound(*work)
        out[name] = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                     "library_ms": library_ms,
                     "rays": (rays_worked(rcap) if name == "roll_chunk" else
                              rays_worked(xcap)),
                     "bound_ms": b_ms, "bound_by": b_by,
                     "bytes": int(work[0]), "operations": int(work[1])}

    # the previous design on the same inputs: its kernel on the fetched
    # cells, the fetch alone, and the two as the march ran them
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
        short = next((k[0] for k in KERNELS if k[0] in fn), fn)
        log(f"[build] {short}: {fields['REG']} registers, stack "
            f"{fields['STACK']} B, local {fields['LOCAL']} B (spills), "
            f"shared {fields['SHARED']} B")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this check runs only on the card", file=sys.stderr)
        return 2
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

    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    log(f"[build] {len(_build.sources())} kernels (nvcc {' '.join(_build.NVCC_FLAGS)})"
        f" -> {os.path.relpath(lib)} in {time.perf_counter() - t0:.1f} s")
    resource_usage(lib)
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
        ("kernels, device ray init", {"host_init": False}, None, True)])
    t_launches, _m, _g = flythrough(terrain, "terrain", card, gated=False)
    t_caps["dims"] = terrain.device_world.dims
    t_times = time_kernels(t_caps)
    log(f"[terrain] done at {time.perf_counter() - t_start:.1f} s")

    # ---- terrain2048 in ARGB mode: kernel 2 writes the inline colors
    t0 = time.perf_counter()
    # with the rays initialised on the device, so that the flythroughs drive
    # both ray inits through the Renderer
    argb = Renderer.create(
        terrain_lods, dataclasses.replace(main_cfg, argb_records=True,
                                          host_init=False), device=dev,
        compact=True)
    del terrain_lods
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
        ("index-mode kernels", {}, terrain, True)])
    a_launches, _m, _g = flythrough(argb, "argb", card, gated=False)
    check_argb_frames(argb, terrain, card)
    a_caps["dims"] = adw.dims
    a_times = time_kernels(a_caps)
    del argb, a_caps, adw
    torch.cuda.empty_cache()
    log(f"[argb] done at {time.perf_counter() - t_start:.1f} s")

    check_split_layout(dev, stats)

    # ---- layered2048: the occupancy-gated march
    lods = layered2048(log=log)
    t0 = time.perf_counter()
    layered = Renderer.create(lods, main_cfg, device=dev, compact=True)
    dw = layered.device_world
    log(f"[layered] (a) device world up in {time.perf_counter() - t0:.1f} s: "
        f"{dw.lod0_voxels} LOD0 voxels, max_runs {dw.max_runs}, empty_frac "
        f"{dw.empty_frac:.4f}, records {tuple(dw.rec_fwd.shape)}, "
        f"{dw.occ_tiles.shape[0]} tile rows, solid Y {dw.solid_min_y}.."
        f"{dw.solid_max_y}; gate {layered.occupancy_on}, chunk and budget "
        f"{layered.march_params}, group {layered.gated_group_cells}")
    if not layered.occupancy_on:
        raise AssertionError("layered2048's occupancy gate resolved off")
    del lods
    check_device_init(layered, "layered", card)
    g_caps = check_gated_kernels(layered, stats)
    check_small_frame(layered, "layered", [
        ("gated kernels", {}, None, True),
        ("gated plain", {"backend": "xla"}, None, True),
        ("dense kernels", {"occupancy_gate": "off"}, None, True),
        ("gated kernels, no compaction", {}, None, False),
        ("gated kernels, device ray init", {"host_init": False}, None,
         True)])
    l_launches, _m, _g = flythrough(layered, "layered", card, gated=True)
    # time at the captured group with the most gated cells, and the sample
    # on that frame's raybuffer
    busiest = max(g_caps.values(), key=lambda c: int(c[0].cells.valid.sum()))
    _screen, l_raybuf, _geom = layered.render_device(busiest[0].frame.cam)
    l_times = time_kernels({
        "roll": busiest[0], "raster": busiest,
        "sample": (l_raybuf, sample_maps(layered,
                                         busiest[0].frame.tables)),
        "dims": dw.dims, "plain_reps": 1})
    log(f"[layered] done at {time.perf_counter() - t_start:.1f} s")

    kernels = []
    for kname, src, replaces in KERNELS:
        lt, tt, at = l_times[kname], t_times[kname], a_times[kname]
        for path, t in (("terrain2048", tt), ("terrain2048 ARGB", at),
                        ("layered2048", lt)):
            lib_txt = ("none" if t["library_ms"] is None
                       else f"{t['library_ms']:.4f} ms")
            log(f"[time] {kname} at {path}'s shapes ({t['rays']} rays): "
                f"kernel {t['ms']:.4f} ms a call, {t['device_ms']:.4f} ms on "
                f"the device a launch, "
                f"plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
                f"({t['bound_by']}: {t['bytes']} B, {t['operations']} ops), "
                f"library {lib_txt}; {stats[kname]['mismatches']} mismatches "
                f"against the plain version, tolerance 0 ({card})")
            prev = t.get("previous_design")
            if prev:
                log(f"[time] {kname} at {path}'s shapes, the previous design "
                    f"on the same inputs: rasterize_chunk "
                    f"{prev['kernel_device_ms']:.4f} ms + torch column fetch "
                    f"{prev['fetch_device_ms']:.4f} ms on the device "
                    f"(as the march ran them "
                    f"{prev['kernel_and_fetch_device_ms']:.4f} ms on the "
                    f"device, {prev['kernel_and_fetch_ms']:.4f} ms a call): "
                    f"the group kernel's {t['device_ms']:.4f} ms is "
                    f"{prev['device_ratio']:.4f} of it; rasterize_chunk "
                    f"{stats['rasterize_chunk']['mismatches']} mismatches "
                    f"against the plain version, tolerance 0 ({card})")
        kernels.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces, "launches": l_launches[kname],
            "max_abs_err": stats[kname]["max_abs_err"],
            "ms": lt["ms"], "device_ms": lt["device_ms"],
            "plain_ms": lt["plain_ms"],
            "bound_ms": lt["bound_ms"], "bound_by": lt["bound_by"],
            "library_ms": lt["library_ms"],
            "launches_by_path": {"terrain2048": t_launches[kname],
                                 "terrain2048_argb": a_launches[kname],
                                 "layered2048": l_launches[kname]},
            "terrain2048": tt, "terrain2048_argb": at})
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
