"""Drive the PyTorch port's main paths on one CUDA card and check every kernel.

Run from the repository root, on a machine with an NVIDIA H100 (sm_90a) and
``nvcc``:

    python3 chip_smoke.py

Phases; each prints its own lines, and any mismatch or exception exits
non-zero (no phase catches its own failure):

1. device: requires CUDA, prints the card's name and power limit;
2. build: compiles the three kernels (``cpuvox_tpu_torch/csrc/*.cu``) and
   prints each one's registers and spills (``cuobjdump -res-usage``);
3. terrain2048, the dense march (``bench.py``'s default scene, built as
   ``bench.py`` builds it and cached in ``.bench_cache/``): each kernel
   against its plain torch version on the card, bit-exact (tolerance 0, f32
   compared as bits): the roll on an adversarial state and on a 1080p
   frame's mid-march state, the rasterizer on one chunk of that frame
   (raybuffer and the 8 state fields), the sample on that frame's
   reprojection maps; then a 64^3 random world at 160x120 against the numpy
   oracle; one 320x180 frame through the kernels and the plain path
   (bit-equal); the 1920x1080 flythrough (24 frames) with launch counts, a
   magenta check, fps and frame p50;
4. layered2048, the occupancy-gated march (``bench.py``'s deep, mostly
   empty headline scene): (a) the device world, whose gate must resolve on;
   (b) the roll at chunk 128 and the rasterizer on a packed group of 16
   gated cells at MAXR 29, mid-march, against their plain versions, in both
   iteration directions; (c) one 320x180 frame
   three ways, equal raybuffers and screens: gated kernels, gated plain
   versions, dense kernels; (d) the 1920x1080 flythrough (24 frames) with
   0 magenta, every kernel launched and busy rays rewound;
5. each kernel's time against its plain version, its bound and, where one
   PyTorch call computes the same function, that call's time, at each
   path's shapes.

Kernel launch counts are set to 0 just before each flythrough and read just
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
    ("rasterize_chunk", "cpuvox_tpu_torch/csrc/rasterize.cu",
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


def roll_both(dda, alive, *rest):
    """The roll kernel and its plain version on copies of the same state."""
    from cpuvox_tpu_torch.bench.capture import clone
    from cpuvox_tpu_torch.ops import roll_kernel

    got = roll_kernel.roll_chunk(clone(dda), alive.clone(), *rest)
    want = roll_kernel.roll_chunk_ref(clone(dda), alive.clone(), *rest)
    return [*got[0], got[1], got[2]], [*want[0], want[1], want[2]]


def raster_both(cap):
    """The rasterizer kernel and its plain version on copies of a captured
    state; returns (kernel result, plain result)."""
    from cpuvox_tpu_torch.bench.capture import clone
    from cpuvox_tpu_torch.ops import phase1_kernel

    args = (cap.cells, cap.frame.static, cap.consts,
            cap.frame.iteration_direction)
    got = phase1_kernel.rasterize_chunk(clone(cap.rs), *args)
    want = phase1_kernel.rasterize_chunk_ref(clone(cap.rs), *args)
    return got, want


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


def check_terrain_kernels(renderer, stats: dict):
    """Phase 3: each kernel against its plain version on a terrain frame."""
    from cpuvox_tpu_torch.bench.capture import capture
    from cpuvox_tpu_torch.ops import reproject_kernel

    dev = renderer.device
    dims = renderer.device_world.dims
    dda, alive, *rest = adversarial_roll_state(dev)
    compare("roll_chunk", *roll_both(dda, alive, *rest), stats)
    log(f"[terrain] roll_chunk == plain on the adversarial state "
        f"(R={dda.pos.shape[0]}, C={rest[-1]}): 0 of "
        f"{dda.pos.shape[0] * (rest[-1] * 13 + 12)} fields differ")

    cap = capture(renderer, path_camera(renderer, 0.35), k=2)
    R = cap.dda.pos.shape[0]
    compare("roll_chunk", *roll_both(cap.dda, cap.alive, cap.frame.static.dirs,
                                     cap.lod_distances, cap.far, dims,
                                     cap.chunk), stats)
    log(f"[terrain] roll_chunk == plain on a terrain2048 "
        f"{renderer.render_wh[0]}x{renderer.render_wh[1]} frame, chunk 3 "
        f"(R={R}, C={cap.chunk}, {int(cap.alive.sum())} rays marching)")

    got, want = raster_both(cap)
    compare("rasterize_chunk", got, want, stats)
    written = int((want.raybuf >= 0).sum() - (cap.rs.raybuf >= 0).sum())
    log(f"[terrain] rasterize_chunk == plain on that frame's chunk 3: "
        f"raybuffer {tuple(want.raybuf.shape)} + 8 state fields, "
        f"{written} texels written by the chunk, MAXR={cap.cells.runs.shape[-1]}")

    _screen, raybuf, _geom = renderer.render_device(path_camera(renderer, 0.35))
    maps = sample_maps(renderer, cap.frame.tables)
    for ri, mask in maps:
        compare("sample_raybuffer",
                [reproject_kernel.sample_raybuffer(raybuf, ri, mask)],
                [reproject_kernel.sample_raybuffer_ref(raybuf, ri, mask)], stats)
    log(f"[terrain] sample_raybuffer == plain on that frame's maps "
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
    """One 320x180 frame through each config variant; raybuffers and
    screens must all equal the first's."""
    cam = path_camera(renderer, 0.35, SMALL_WH)
    outs = []
    for label, kw in variants:
        cfg = dataclasses.replace(renderer.config, width=SMALL_WH[0],
                                  height=SMALL_WH[1], **kw)
        r = dataclasses.replace(renderer, config=cfg, lod_distances=None)
        t0 = time.perf_counter()
        screen, rb, _ = r.render_device(cam)
        torch.cuda.synchronize()
        outs.append((label, screen, rb, time.perf_counter() - t0,
                     r.occupancy_on))
    for label, screen, rb, _t, _g in outs[1:]:
        compare(f"frame_{scene}_{label}", [screen, rb],
                [outs[0][1], outs[0][2]], {})
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
    for t in (0.35, 0.6):
        cap = capture(renderer, path_camera(renderer, t), k=3)
        d = cap.frame.iteration_direction
        if not cap.gated or cap.chunk != 128:
            raise AssertionError(f"layered2048 did not take the gated march "
                                 f"(gated {cap.gated}, chunk {cap.chunk})")
        compare("roll_chunk", *roll_both(
            cap.dda, cap.alive, cap.frame.static.dirs, cap.lod_distances,
            cap.far, dims, cap.chunk), stats)
        if not int(cap.cells.valid.sum()):
            raise AssertionError(f"direction {d:+d}: the captured group holds "
                                 "no gated cell")
        got, want = raster_both(cap)
        compare("rasterize_chunk", got, want, stats)
        written = int((want.raybuf >= 0).sum() - (cap.rs.raybuf >= 0).sum())
        GK, R, maxr = cap.cells.runs.shape
        log(f"[layered] direction {d:+d} (path t={t}): roll_chunk == plain at "
            f"C={cap.chunk} (R={R}, {int(cap.alive.sum())} rays marching); "
            f"rasterize_chunk == plain on gated group 4 (GK={GK}, MAXR={maxr},"
            f" {int(cap.cells.valid.sum())} gated cells, {written} texels "
            f"written): raybuffer + 8 state fields, 0 elements differ")
        caps[d] = (cap, written)
    if set(caps) != {1, -1}:
        raise AssertionError(f"iteration directions seen: {sorted(caps)}")
    return caps


def flythrough(renderer, scene: str, card: str, gated: bool):
    """A path's 1080p flythrough with the launch counts set to 0 just before
    it and read just after it."""
    from cpuvox_tpu_torch.bench.harness import run_flythrough
    from cpuvox_tpu_torch.ops import phase1_kernel, reproject_kernel
    from cpuvox_tpu_torch.ops import roll_kernel
    from cpuvox_tpu_torch.render import raymarch

    counters = (roll_kernel, phase1_kernel, reproject_kernel)
    for m in counters:
        m.launches = 0
    raymarch.gated_stats.update(iterations=0, rewinds=0)
    metrics = run_flythrough(renderer, n_frames=N_FRAMES, log=log)
    launches = [m.launches for m in counters]
    gstats = dict(raymarch.gated_stats)
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
    log(f"[{scene}] {MAIN_WH[0]}x{MAIN_WH[1]} flythrough, {N_FRAMES} frames "
        f"on {card}: fps {metrics['fps']:.3f}, frame p50 "
        f"{metrics['frame_ms_p50']:.1f} ms (device span p50 "
        f"{metrics['frame_gpu_ms_p50']:.1f} ms), "
        f"{metrics['ray_columns_per_sec']:.0f} ray columns/s, 0 magenta; "
        f"launches roll {launches[0]}, rasterize {launches[1]}, "
        f"sample {launches[2]}{extra}")
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


def roll_work(cap):
    """Bytes and operations of one roll call: the DDA state and alive read
    and written, the directions read, the (C, 13, R) visits written; about
    40 integer/f32 operations a step."""
    R, C = cap.dda.pos.shape[0], cap.chunk
    state = R * (8 * 5 + 4 + 1)  # pos, tmax, tdelta, stp, ids; lod; alive
    return 2 * state + R * 8 + C * 13 * R * 4, 40 * C * R


def raster_work(cap, written: int):
    """Bytes and operations one rasterize call needs on this data: every
    slot's valid flag; each valid cell's fields (ids, lod, n_runs, color
    offset, cmin, cmax) and its n_runs run words; the static planes; the 8
    state fields read and written; each texel it writes.  About 200
    operations a valid cell, 30 a run of a valid cell and 10 a texel."""
    cells = cap.cells
    C, R, _maxr = cells.runs.shape
    state = R * (6 * 4 + 2)
    valid = int(cells.valid.sum())
    runs = int(torch.where(cells.valid, cells.n_runs, 0).sum())
    return (C * R + valid * (8 + 5 * 4) + 4 * runs + R * 36 + 2 * state
            + 4 * written, 200 * valid + 30 * runs + 10 * written)


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


def time_kernels(caps: dict) -> dict:
    """Each kernel's time at a path's shapes: kernel, plain version, bound
    and the one-call PyTorch equivalent where there is one."""
    from cpuvox_tpu_torch.bench.capture import clone
    from cpuvox_tpu_torch.ops import phase1_kernel, reproject_kernel
    from cpuvox_tpu_torch.ops import roll_kernel

    rcap = caps["roll"]
    roll_rest = (rcap.frame.static.dirs, rcap.lod_distances, rcap.far,
                 caps["dims"], rcap.chunk)
    xcap, written = caps["raster"]
    rargs = (xcap.cells, xcap.frame.static, xcap.consts,
             xcap.frame.iteration_direction)
    raybuf, maps = caps["sample"]
    maps_long = [(ri.long(), mask != 0) for ri, mask in maps]

    def gather_where(_):
        return [torch.where(m, torch.gather(raybuf, 0, ri), -1)
                for ri, m in maps_long]

    plain_reps = caps.get("plain_reps", 2)
    out = {}
    for name, kern, plain, library, setup, reps, work in (
            ("roll_chunk", lambda a: roll_kernel.roll_chunk(*a, *roll_rest),
             lambda a: roll_kernel.roll_chunk_ref(*a, *roll_rest), None,
             lambda: (clone(rcap.dda), rcap.alive.clone()), (20, plain_reps),
             roll_work(rcap)),
            ("rasterize_chunk",
             lambda rs: phase1_kernel.rasterize_chunk(rs, *rargs),
             lambda rs: phase1_kernel.rasterize_chunk_ref(rs, *rargs), None,
             lambda: clone(xcap.rs), (10, 1), raster_work(xcap, written)),
            ("sample_raybuffer",
             lambda _: [reproject_kernel.sample_raybuffer(raybuf, *m)
                        for m in maps],
             lambda _: [reproject_kernel.sample_raybuffer_ref(raybuf, *m)
                        for m in maps], gather_where, lambda: None, (50, 10),
             sample_work(maps))):
        time_ms(kern, 2, setup)  # warm
        ms = time_ms(kern, reps[0], setup)
        plain_ms = time_ms(plain, reps[1], setup)
        library_ms = None
        if library is not None:
            time_ms(library, 2)
            library_ms = time_ms(library, reps[0])
        b_ms, b_by = bound(*work)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "bytes": int(work[0]), "operations": int(work[1])}
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

    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    log(f"[build] {len(_build.sources())} kernels (nvcc {' '.join(_build.NVCC_FLAGS)})"
        f" -> {os.path.relpath(lib)} in {time.perf_counter() - t0:.1f} s")
    resource_usage(lib)
    main_cfg = RenderConfig(width=MAIN_WH[0], height=MAIN_WH[1])

    # ---- terrain2048: the dense march
    t0 = time.perf_counter()
    terrain = Renderer.create(terrain2048(log=log), main_cfg, device=dev)
    log(f"[terrain] device world up in {time.perf_counter() - t0:.1f} s "
        f"(max_runs {terrain.device_world.max_runs}, "
        f"{terrain.device_world.lod0_voxels} LOD0 voxels, gate "
        f"{'on' if terrain.occupancy_on else 'off'})")
    if terrain.occupancy_on:
        raise AssertionError("terrain2048's gate resolved on")
    stats: dict = {}
    t_caps = check_terrain_kernels(terrain, stats)
    check_oracle(dev)
    check_small_frame(terrain, "terrain", [("kernels", {}),
                                           ("plain", {"backend": "xla"})])
    t_launches, _m, _g = flythrough(terrain, "terrain", card, gated=False)
    t_caps["dims"] = terrain.device_world.dims
    t_times = time_kernels(t_caps)
    log(f"[terrain] done at {time.perf_counter() - t_start:.1f} s")

    # ---- layered2048: the occupancy-gated march
    lods = layered2048(log=log)
    t0 = time.perf_counter()
    layered = Renderer.create(lods, main_cfg, device=dev)
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
    g_caps = check_gated_kernels(layered, stats)
    check_small_frame(layered, "layered", [
        ("gated kernels", {}), ("gated plain", {"backend": "xla"}),
        ("dense kernels", {"occupancy_gate": "off"})])
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
        lt, tt = l_times[kname], t_times[kname]
        for path, t in (("terrain2048", tt), ("layered2048", lt)):
            lib_txt = ("none" if t["library_ms"] is None
                       else f"{t['library_ms']:.4f} ms")
            log(f"[time] {kname} at {path}'s shapes: kernel {t['ms']:.4f} ms, "
                f"plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
                f"({t['bound_by']}: {t['bytes']} B, {t['operations']} ops), "
                f"library {lib_txt}; {stats[kname]['mismatches']} mismatches "
                f"against the plain version, tolerance 0 ({card})")
        kernels.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces, "launches": l_launches[kname],
            "max_abs_err": stats[kname]["max_abs_err"],
            "ms": lt["ms"], "plain_ms": lt["plain_ms"],
            "bound_ms": lt["bound_ms"], "bound_by": lt["bound_by"],
            "library_ms": lt["library_ms"],
            "launches_by_path": {"terrain2048": t_launches[kname],
                                 "layered2048": l_launches[kname]},
            "terrain2048": tt})
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
