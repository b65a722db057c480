"""Drive the PyTorch port's main path on one CUDA card and check every kernel.

Run from the repository root, on a machine with an NVIDIA H100 (sm_90a) and
``nvcc``:

    python3 chip_smoke.py

Phases; each prints its own lines, and any mismatch or exception exits
non-zero (no phase catches its own failure):

1. device: requires CUDA, prints the card's name and power limit;
2. build: compiles the three kernels (``cpuvox_tpu_torch/csrc/*.cu``);
3. kernels against their plain torch versions on the card, bit-exact
   (tolerance 0, f32 compared as bits): the roll on an adversarial state and
   on a terrain2048 1080p frame's mid-march state, the rasterizer on one
   chunk of that frame (raybuffer and the 8 state fields), the sample on
   that frame's reprojection maps;
4. a 64^3 random world at 160x120 against the numpy oracle;
5. the main path, ``bench.py``'s default scene (terrain2048, built as
   bench.py builds it and cached in ``.bench_cache/``): one 320x180 frame
   through the kernels and through the plain path (bit-equal), then the
   1920x1080 flythrough (24 frames) through the kernels, with launch
   counts, a magenta check, fps and frame p50;
6. each kernel's time against its plain version at the main path's shapes.

The last lines are the card line, one JSON line of kernels, and
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


# ------------------------------------------------------------- scenes


def random_world_64(seed=5, n=6000):
    """A 64^3 random voxel soup (tests/scenes.py::random_world at 64^3) with
    a 6-level LOD chain."""
    from cpuvox_tpu_torch.shared import rle

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


@dataclasses.dataclass
class Capture:
    """A frame's state after ``k`` chunks of the march, and its next chunk."""

    frame: object  # render.frame.FrameSetup
    rs: object  # RasterState after k chunks
    consts: dict
    lod_distances: torch.Tensor
    far: float
    dda: object  # DDAState before the next chunk
    alive: torch.Tensor  # march-alive before the next chunk
    cells: object  # CellFields of the next chunk
    chunk: int


def clone(nt):
    return type(nt)(*(t.clone() for t in nt))


def capture(renderer, cam, k: int) -> Capture:
    """March ``k`` chunks of one frame through the kernels, then roll the
    next chunk and fetch its cells (the same steps as raymarch.march)."""
    from cpuvox_tpu_torch.ops import phase1_kernel, roll_kernel
    from cpuvox_tpu_torch.render import raymarch as rm

    f = renderer.frame_setup(cam)
    dev = renderer.device
    dims = renderer.device_world.dims
    chunk, _ = renderer.march_params
    rs = rm.init_raster_state(f.static, max(renderer.render_wh))
    consts = rm.raster_consts(dims[1], f.cam_data.position[1],
                              *renderer.solid_bounds, device=dev)
    ld = torch.from_numpy(f.cam_data.lod_distances).to(dev)
    far = float(np.float32(f.cam_data.far_clip))
    dda, alive = f.dda, f.alive0
    for i in range(k + 1):
        alive = alive & rs.alive
        before = clone(dda), alive.clone()
        dda, alive, visits = roll_kernel.roll_chunk(dda, alive, f.static.dirs,
                                                    ld, far, dims, chunk)
        cells = rm.chunk_cells(renderer._wa, visits, f.iteration_direction)
        if i < k:
            rs = phase1_kernel.rasterize_chunk(rs, cells, f.static, consts,
                                               f.iteration_direction)
    return Capture(f, rs, consts, ld, far, before[0], before[1], cells, chunk)


# ------------------------------------------------------------- phases


def check_kernels(renderer, stats: dict):
    """Phase 3: each kernel against its plain version on the card."""
    from cpuvox_tpu_torch.ops import phase1_kernel, reproject_kernel, roll_kernel
    from cpuvox_tpu_torch.render import reproject
    from cpuvox_tpu_torch.shared import bench_path

    dev = renderer.device
    dims = renderer.device_world.dims

    def roll_both(dda, alive, *rest):
        got = roll_kernel.roll_chunk(clone(dda), alive.clone(), *rest)
        want = roll_kernel.roll_chunk_ref(clone(dda), alive.clone(), *rest)
        return [*got[0], got[1], got[2]], [*want[0], want[1], want[2]]

    dda, alive, *rest = adversarial_roll_state(dev)
    compare("roll_chunk", *roll_both(dda, alive, *rest), stats)
    log(f"[kernels] roll_chunk == plain on the adversarial state "
        f"(R={dda.pos.shape[0]}, C={rest[-1]}): 0 of "
        f"{dda.pos.shape[0] * (rest[-1] * 13 + 12)} fields differ")

    cam = bench_path.benchmark_camera(0.35 * bench_path.BENCH_CLIP_LENGTH,
                                      dims, renderer.render_wh)
    cap = capture(renderer, cam, k=2)
    R = cap.dda.pos.shape[0]
    compare("roll_chunk", *roll_both(cap.dda, cap.alive, cap.frame.static.dirs,
                                     cap.lod_distances, cap.far, dims,
                                     cap.chunk), stats)
    log(f"[kernels] roll_chunk == plain on a terrain2048 "
        f"{renderer.render_wh[0]}x{renderer.render_wh[1]} frame, chunk 3 "
        f"(R={R}, C={cap.chunk}, {int(cap.alive.sum())} rays marching)")

    args = (cap.cells, cap.frame.static, cap.consts,
            cap.frame.iteration_direction)
    got = phase1_kernel.rasterize_chunk(clone(cap.rs), *args)
    want = phase1_kernel.rasterize_chunk_ref(clone(cap.rs), *args)
    compare("rasterize_chunk", got, want, stats)
    written = int((want.raybuf >= 0).sum() - (cap.rs.raybuf >= 0).sum())
    log(f"[kernels] rasterize_chunk == plain on that frame's chunk 3: "
        f"raybuffer {tuple(want.raybuf.shape)} + 8 state fields, "
        f"{written} texels written by the chunk, MAXR={cap.cells.runs.shape[-1]}")

    _screen, raybuf, _geom = renderer.render_device(cam)
    w, h = renderer.render_wh
    seg_id, ray_idx = reproject.segment_ray_index(cap.frame.tables, w, h, dev)
    maps = [(ray_idx, (seg_id >= 2).to(torch.int32)),
            (ray_idx.t().contiguous(), (seg_id < 2).to(torch.int32).t().contiguous())]
    for ri, mask in maps:
        compare("sample_raybuffer",
                [reproject_kernel.sample_raybuffer(raybuf, ri, mask)],
                [reproject_kernel.sample_raybuffer_ref(raybuf, ri, mask)], stats)
    log(f"[kernels] sample_raybuffer == plain on that frame's maps "
        f"(LR {tuple(maps[0][0].shape)}, TD {tuple(maps[1][0].shape)}, "
        f"raybuffer {tuple(raybuf.shape)})")
    return cap, raybuf, maps


def check_oracle(device):
    """Phase 4: the port on the card against the numpy oracle."""
    from cpuvox_tpu_torch.render.frame import Renderer
    from cpuvox_tpu_torch.shared import RenderConfig, colors, oracle
    from cpuvox_tpu_torch.shared import camera as cm
    from cpuvox_tpu_torch.shared import segments as sg

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
    log(f"[oracle] port (kernels, {device}) == numpy oracle on a 64^3 random "
        f"world at {wh[0]}x{wh[1]}: td {td.shape}, lr {lr.shape}, screen "
        f"{screen.shape}, {drawn} non-sky pixels, 0 texels differ (oracle "
        f"{t_oracle:.1f} s)")


def check_small_frame(renderer):
    """Phase 5a: one 320x180 frame, kernels against the plain path."""
    from cpuvox_tpu_torch.shared import bench_path

    def at(backend):
        cfg = dataclasses.replace(renderer.config, width=SMALL_WH[0],
                                  height=SMALL_WH[1], backend=backend)
        return dataclasses.replace(renderer, config=cfg, lod_distances=None)

    cam = bench_path.benchmark_camera(0.35 * bench_path.BENCH_CLIP_LENGTH,
                                      renderer.device_world.dims, SMALL_WH)
    t0 = time.perf_counter()
    ks, krb, _ = at("pallas").render_device(cam)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ps, prb, _ = at("xla").render_device(cam)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    compare("frame_320x180", [ks, krb], [ps, prb], {})
    log(f"[main] terrain2048 {SMALL_WH[0]}x{SMALL_WH[1]}: kernel path == plain "
        f"path (screen {tuple(ks.shape)}, raybuffer {tuple(krb.shape)}); "
        f"{t1 - t0:.2f} s vs {t2 - t1:.2f} s for one cold frame")


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


def time_kernels(renderer, cap: Capture, raybuf, maps) -> dict:
    """Phase 6: kernel vs plain time at the main path's shapes."""
    from cpuvox_tpu_torch.ops import phase1_kernel, reproject_kernel, roll_kernel

    dims = renderer.device_world.dims
    roll_rest = (cap.frame.static.dirs, cap.lod_distances, cap.far, dims,
                 cap.chunk)

    def roll_setup():
        return clone(cap.dda), cap.alive.clone()

    def raster_setup():
        return clone(cap.rs)

    rargs = (cap.cells, cap.frame.static, cap.consts,
             cap.frame.iteration_direction)
    out = {}
    for name, kern, plain, setup, reps in (
            ("roll_chunk", lambda a: roll_kernel.roll_chunk(*a, *roll_rest),
             lambda a: roll_kernel.roll_chunk_ref(*a, *roll_rest),
             roll_setup, (20, 3)),
            ("rasterize_chunk",
             lambda rs: phase1_kernel.rasterize_chunk(rs, *rargs),
             lambda rs: phase1_kernel.rasterize_chunk_ref(rs, *rargs),
             raster_setup, (10, 2)),
            ("sample_raybuffer",
             lambda _: [reproject_kernel.sample_raybuffer(raybuf, *m)
                        for m in maps],
             lambda _: [reproject_kernel.sample_raybuffer_ref(raybuf, *m)
                        for m in maps], lambda: None, (50, 10))):
        time_ms(kern, 2, setup)  # warm
        time_ms(plain, 1, setup)
        out[name] = (time_ms(kern, reps[0], setup), time_ms(plain, reps[1], setup))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this check runs only on the card", file=sys.stderr)
        return 2
    from cpuvox_tpu_torch.bench.harness import run_flythrough, terrain2048
    from cpuvox_tpu_torch.ops import _build, phase1_kernel, reproject_kernel
    from cpuvox_tpu_torch.ops import roll_kernel
    from cpuvox_tpu_torch.render.frame import Renderer
    from cpuvox_tpu_torch.shared import RenderConfig

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

    lods = terrain2048(log=log)
    t0 = time.perf_counter()
    renderer = Renderer.create(lods, RenderConfig(width=MAIN_WH[0],
                                                  height=MAIN_WH[1]), device=dev)
    log(f"[world] device world up in {time.perf_counter() - t0:.1f} s "
        f"(max_runs {renderer.device_world.max_runs}, "
        f"{renderer.device_world.lod0_voxels} LOD0 voxels)")

    stats: dict = {}
    cap, raybuf, maps = check_kernels(renderer, stats)
    check_oracle(dev)
    check_small_frame(renderer)

    counters = (roll_kernel, phase1_kernel, reproject_kernel)
    for m in counters:
        m.launches = 0
    metrics = run_flythrough(renderer, n_frames=N_FRAMES, log=log)
    launches = [m.launches for m in counters]
    if metrics["magenta_pixels"]:
        raise AssertionError(f"{metrics['magenta_pixels']} magenta pixels in "
                             "the flythrough")
    if min(launches) <= 0:
        raise AssertionError(f"a kernel did not run on the main path: "
                             f"launches {launches}")
    log(f"[main] terrain2048 {MAIN_WH[0]}x{MAIN_WH[1]} flythrough, "
        f"{N_FRAMES} frames on {card}: fps {metrics['fps']:.3f}, frame p50 "
        f"{metrics['frame_ms_p50']:.1f} ms (device span p50 "
        f"{metrics['frame_gpu_ms_p50']:.1f} ms), "
        f"{metrics['ray_columns_per_sec']:.0f} ray columns/s, 0 magenta; "
        f"launches roll {launches[0]}, rasterize {launches[1]}, "
        f"sample {launches[2]}")

    times = time_kernels(renderer, cap, raybuf, maps)
    kernels = []
    for (kname, src, replaces), n in zip(KERNELS, launches):
        ms, plain_ms = times[kname]
        log(f"[time] {kname}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms per "
            f"call at the main path's shapes; {stats[kname]['mismatches']} "
            f"mismatches against the plain version, tolerance 0 ({card})")
        kernels.append({"name": kname, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": n,
                        "max_abs_err": stats[kname]["max_abs_err"],
                        "ms": ms, "plain_ms": plain_ms})
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
