"""One run of one cell: the world, the Renderer, the warm-up, the timed
window, the per-layer readings of a traced run and, once the window has
closed, the comparison with the plain reference.

The window drives the traffic's entry: ``render_device`` (frame i
dispatched, then frame i-1 waited for) or ``render`` (the screen on the
host before the next camera), or for a camera-batch mix
``render_camera_batch`` (``run_batch``: a step of many agents' cameras,
waited for or dispatched ahead).  Nothing in it builds or captures: every
variant the path needs was rendered in set-up, and a capture inside the
window fails the run.
"""
from __future__ import annotations

import gc
import subprocess
import sys
import time

import numpy as np

from voxbench import program, stats, traffic
from voxbench import spec as bspec
from voxbench.reference import check
from voxbench.reference import frame as rf
from voxbench.reference import rows
from voxbench.reference.colors import DEBUG_MAGENTA
from voxbench.trace import BatchSpans, Keep, KeepBatch, Spans, Trace
from voxbench.traffic import Flythrough
from voxbench.worldgen import cache as world_cache

BANNED = ("jax", "jaxlib", "flax", "cpuvox_tpu")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (``cpuvox_tpu_torch`` is neither)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


class Sampler:
    """A reservoir of ``k`` of the window's frames, drawn from the seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.slots = int(k), {}
        self._rng = np.random.default_rng([int(seed), 1])

    def offer(self, j: int):
        """The slot frame ``j`` takes, or None."""
        if j < self.k:
            return j
        s = int(self._rng.integers(0, j + 1))
        return s if s < self.k else None

    def kept(self) -> list[dict]:
        return sorted(self.slots.values(), key=lambda x: x["j"])


def phase2_bytes(mapping, raw, width: int, height: int, index_mode: bool) -> int:
    """The bytes a frame's phase 2 needs: the screen written once, each
    raybuffer texel the pixels sample read once and, in index mode, each
    color word those texels name read once."""
    row, texel = mapping
    hit = row >= 0
    P = raw.shape[1]
    ids = np.unique(row[hit] * P + texel[hit])
    n = 4 * width * height + 4 * ids.size
    if index_mode:
        idx = raw.reshape(-1)[ids]
        n += 4 * np.unique(idx[idx >= 0]).size
    return int(n)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else "?"
    except (OSError, subprocess.SubprocessError):
        return "?"


def run_cell(cell: bspec.Cell, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda",
             metrics_dir: str | None = None,
             cache_dir: str | None = None, fault=None) -> dict:
    """Runs the cell and returns the result line's object.  ``fault``, for
    the tests, is called on the Renderer before the window to break the
    timed path underneath."""
    import torch

    cfg, tr = cell.config, cell.traffic
    if tr["entry"] == "render_camera_batch":
        return run_batch(cell, seed, seconds, trace, t_start, device,
                         metrics_dir, cache_dir, fault)
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if tr["entry"] not in ("render", "render_device"):
        raise ValueError(f"unknown entry {tr['entry']!r}")
    waited = tr["entry"] == "render"

    world_path, lods, r = world_and_renderer(cfg, tr, device, cache_dir)
    dims = lods[0].dims
    fly = Flythrough(tr, dims, seed)

    def step(pose):
        cam = program.camera(pose, tr)
        return r.render(cam) if waited else r.render_device(cam)

    t_w = time.perf_counter()
    for pose in fly.warmup():
        step(pose)
        sync()
    log(f"[setup] warm-up of {len(fly.warmup())} frames in "
        f"{time.perf_counter() - t_w:.2f} s")
    if fault is not None:
        fault(r)
    captures0 = program.captures(r)
    spans = Spans(r) if trace and cuda else None
    iters0 = program.rasterizer_iterations() if trace and cuda else None
    sync()
    if spans:
        spans.anchor()
    sampler = Sampler(tr["check_frames"], seed)
    handed, done = [], []
    screen = rb = prev = None
    first_ev = 0

    t0 = time.perf_counter()
    setup_s = t0 - t_start
    if spans:
        spans.window_t0 = t0
        first_ev = len(spans.events)
    t_end = t0 + seconds
    j = 0
    while True:
        now = time.perf_counter()
        if now >= t_end:
            break
        pose = fly.pose(j)
        cam = program.camera(pose, tr)
        slot = sampler.offer(j)
        handed.append(now)
        rb = None
        if waited:
            if slot is None:
                screen = r.render(cam)
            else:
                with Keep(r) as k:
                    screen = r.render(cam)
                rb = k.raybuf
            done.append(time.perf_counter())
        else:
            screen, rb, _ = r.render_device(cam)
            if not cuda:
                done.append(time.perf_counter())
            else:
                ev = torch.cuda.Event()
                ev.record()
                if prev is not None:
                    w0 = time.perf_counter()
                    prev.synchronize()
                    done.append(time.perf_counter())
                    if spans:
                        spans.mark("wait", w0, done[-1])
                prev = ev
        if slot is not None:
            sampler.slots[slot] = {"j": j, "pose": pose, "screen": screen,
                                   "raybuf": rb}
        j += 1
    if prev is not None:
        prev.synchronize()
        done.append(time.perf_counter())
    t1 = done[-1]
    sync()
    memory_peak = int(torch.cuda.max_memory_allocated(r.device)) if cuda else 0
    if program.captures(r) != captures0:
        raise RuntimeError("a march graph was captured inside the window")
    log(f"[window] {len(done)} screens in {t1 - t0:.3f} s "
        f"({len(done) / (t1 - t0):.2f} /s), set-up {setup_s:.2f} s")

    e2e = {"fps": stats.rate(len(done), t0, t1),
           "frame_ms_p95": 1e3 * stats.percentile(stats.intervals(done, t0), 95),
           "latency_ms_p95": 1e3 * stats.percentile(
               stats.latencies(handed, done), 95),
           "setup_s": setup_s}

    tr_out, breakdown = None, None
    if trace:
        tr_out = Trace(frames=len(done), window_s=t1 - t0)
        if spans:
            spans.fill(tr_out, first_ev)
            breakdown = {"device_ops": spans.device_ops(first_ev),
                         "idle_gaps": spans.idle_gaps(first_ev)}
            spans.remove()
        iters1 = program.rasterizer_iterations() if cuda else None
        if iters0 is not None and iters1 is not None:
            tr_out.iterations = iters1 - iters0

    index_mode = not r.argb_on
    kept = sampler.kept()
    s = kb = None
    for k in kept:
        s, kb = k.pop("screen"), k.pop("raybuf")
        k["screen"] = (s if isinstance(s, np.ndarray)
                       else s.cpu().numpy()).view(np.uint32)
        k["argb"] = program.raybuffer_argb(r, kb)
        k["raw"] = kb.cpu().numpy()
    del r, spans, rb, screen, prev, sampler, s, kb
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    wh = rf.render_wh(tr["width"], tr["height"], cfg["render"]["render_scale"])
    lod_far = rf.lod_distances(fly.warmup()[0], cfg["render"], wh, max(dims))
    rng = np.random.default_rng([int(seed), 2])
    geoms = [rf.geometry(k["pose"], cfg["render"], wh, lod_far) for k in kept]
    picks = [check.pick_rays(g, tr["check_rays"], rng) for g in geoms]
    ref_rows = rows.rows(world_path, lods, [
        (g, [(si, i) for si, i, _ in p]) for g, p in zip(geoms, picks)])
    numbers = []
    for k, g, rays, ref in zip(kept, geoms, picks, ref_rows):
        mapping = rf.pixel_texels(g)
        numbers.append(check.frame_numbers(lods, g, k["screen"], k["argb"],
                                           rays, mapping=mapping,
                                           ref_rows=ref))
        if tr_out is not None:
            tr_out.phase2_bytes.append(phase2_bytes(
                mapping, k["raw"], tr["width"], tr["height"], index_mode))
    log(f"[check] {len(kept)} frames, {sum(n['rays_checked'] for n in numbers)}"
        f" rays against the reference in {time.perf_counter() - t_ref:.1f} s")

    return result(cell, trace, metrics_dir, e2e, tr_out, breakdown, cuda,
                  memory_peak, len(handed), numbers)


def run_batch(cell: bspec.Cell, seed: int, seconds: float, trace: bool,
              t_start: float, device: str = "cuda",
              metrics_dir: str | None = None, cache_dir: str | None = None,
              fault=None) -> dict:
    """``run_cell`` for a camera-batch mix (``"entry":
    "render_camera_batch"``): a step is ``cameras_per_step`` agents'
    cameras (``traffic.Agents``) through ``render_camera_batch``, handed in
    a closed loop, one CUDA event a step; ``"waited"`` waits for step t's
    event before it hands over step t+1, ``"ahead"`` hands over step t+1
    before it waits for step t.  The screens stay on the card.  ``fps`` is
    screens (cameras times steps completed) over the window's seconds; the
    tails are a step's: ``latency_ms_p95`` from its cameras handed over to
    its event done, ``frame_ms_p95`` from one step's completion to the
    next.  A traced run's ``Trace`` holds a step a frame.  ``fault``, for
    the tests, is called on the Renderer before the window; a callable it
    returns is called once the window has closed, to undo it."""
    import torch

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg, tr = cell.config, cell.traffic
    traffic.require(tr, traffic.BATCH_KEYS)
    ahead = tr["dispatch"] == "ahead"

    world_path, lods, r = world_and_renderer(cfg, tr, device, cache_dir)
    agents = traffic.Agents(tr, lods[0], seed)
    n = agents.n

    def cams(poses):
        return [program.camera(p, tr) for p in poses]

    warm = agents.warmup(program.bucket_size)
    t_w = time.perf_counter()
    for poses in warm:
        program.camera_batch(r, cams(poses))
        sync()
    log(f"[setup] warm-up of {len(warm)} steps of {n} cameras in "
        f"{time.perf_counter() - t_w:.2f} s")
    undo = fault(r) if fault is not None else None
    captures0 = program.captures(r)
    spans = BatchSpans(r) if trace and cuda else None
    render = spans.render if spans else program.camera_batch
    iters0 = program.rasterizer_iterations() if trace and cuda else None
    sync()
    if spans:
        spans.anchor()
    sampler = Sampler(tr["check_steps"], seed)
    handed, done = [], []
    screens = prev = keep = None
    first_step = 0

    t0 = time.perf_counter()
    setup_s = t0 - t_start
    if spans:
        first_step = len(spans.steps)
    t_end = t0 + seconds
    j = 0
    while True:
        now = time.perf_counter()
        if now >= t_end:
            break
        poses = agents.step(j)
        step_cams = cams(poses)
        slot = sampler.offer(j)
        handed.append(now)
        if slot is None:
            screens = render(r, step_cams)
        else:
            with KeepBatch(r) as keep:
                screens = render(r, step_cams)
        if not cuda:
            done.append(time.perf_counter())
        else:
            ev = torch.cuda.Event()
            ev.record()
            wait = prev if ahead else ev
            if wait is not None:
                w0 = time.perf_counter()
                wait.synchronize()
                done.append(time.perf_counter())
                if spans:
                    spans.mark("wait", w0, done[-1])
            prev = ev if ahead else None
        if slot is not None:
            sampler.slots[slot] = {"j": j, "poses": poses, "screens": screens,
                                   "blocks": keep.blocks(n)}
        j += 1
    if prev is not None:
        prev.synchronize()
        done.append(time.perf_counter())
    t1 = done[-1]
    sync()
    memory_peak = int(torch.cuda.max_memory_allocated(r.device)) if cuda else 0
    if program.captures(r) != captures0:
        raise RuntimeError("a march graph was captured inside the window")
    log(f"[window] {len(done)} steps of {n} cameras in {t1 - t0:.3f} s "
        f"({n * len(done) / (t1 - t0):.2f} screens/s), set-up {setup_s:.2f} s")

    e2e = {"fps": stats.rate(n * len(done), t0, t1),
           "frame_ms_p95": 1e3 * stats.percentile(stats.intervals(done, t0), 95),
           "latency_ms_p95": 1e3 * stats.percentile(
               stats.latencies(handed, done), 95),
           "setup_s": setup_s}

    tr_out, breakdown = None, None
    if trace:
        tr_out = Trace(frames=len(done), window_s=t1 - t0)
        if spans:
            spans.fill(tr_out, first_step)
            breakdown = {"device_ops": spans.device_ops(first_step),
                         "idle_gaps": spans.idle_gaps(first_step)}
            spans.remove()
        iters1 = program.rasterizer_iterations() if cuda else None
        if iters0 is not None and iters1 is not None:
            tr_out.iterations = iters1 - iters0
    if callable(undo):
        undo()

    index_mode = not r.argb_on
    R1, P = r.ray_capacity, max(r.render_wh)
    kept = sampler.kept()
    for k in kept:
        s = k.pop("screens")
        k["screens"] = s.cpu().numpy().view(np.uint32)
        blocks = k.pop("blocks")
        k["argb"] = [None if b is None else program.raybuffer_argb(r, b)
                     for b in blocks]
        k["raw"] = [None if b is None or tr_out is None else b.cpu().numpy()
                    for b in blocks]
    del r, spans, screens, prev, keep, sampler, render
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    numbers = batch_numbers(cell, seed, lods, world_path, kept,
                            warm[0][0], R1, P, index_mode, tr_out)
    return result(cell, trace, metrics_dir, e2e, tr_out, breakdown, cuda,
                  memory_peak, n * len(handed), numbers)


def batch_numbers(cell: bspec.Cell, seed: int, lods, world_path: str, kept,
                  first_pose: dict, R1: int, P: int, index_mode: bool,
                  tr_out=None) -> list[dict]:
    """The compared numbers of the kept steps, a screen each: in each step
    ``check_cameras`` cameras drawn from the seed have ``check_rays`` rays
    each held against the oracle (``texels_off``), and every camera's screen
    is held against the reference's reprojection of its own raybuffer block
    (``pixels_off``) and for magenta.  A camera whose block the hook never
    saw is judged on an unwritten (magenta) block.  The LOD distances are
    ``first_pose``'s, the first camera the Renderer set up.  With
    ``tr_out``, each step's phase-2 bytes over all its cameras go into
    it."""
    tr, render = cell.traffic, cell.config["render"]
    t_ref = time.perf_counter()
    wh = rf.render_wh(tr["width"], tr["height"], render["render_scale"])
    lod_far = rf.lod_distances(first_pose, render, wh, max(lods[0].dims))
    rng = np.random.default_rng([int(seed), 2])
    rng_cam = np.random.default_rng([int(seed), 3])
    geoms, picks, jobs = [], [], []
    for k in kept:
        n = len(k["poses"])
        geoms.append([rf.geometry(p, render, wh, lod_far) for p in k["poses"]])
        chosen = rng_cam.choice(n, size=min(int(tr["check_cameras"]), n),
                                replace=False)
        picks.append({int(i): check.pick_rays(geoms[-1][i], tr["check_rays"],
                                              rng) for i in sorted(chosen)})
        jobs += [(geoms[-1][i], [(si, ri) for si, ri, _ in rays])
                 for i, rays in picks[-1].items()]
    ref_rows = iter(rows.rows(world_path, lods, jobs))
    unwritten = np.full((R1, P), DEBUG_MAGENTA, np.uint32)
    numbers = []
    for k, gs, pk in zip(kept, geoms, picks):
        nbytes = 0
        for i, g in enumerate(gs):
            mapping = rf.pixel_texels(g)
            argb = k["argb"][i]
            rays = pk.get(i, [])
            numbers.append(check.frame_numbers(
                lods, g, k["screens"][i], unwritten if argb is None else argb,
                rays, mapping=mapping, ref_rows=next(ref_rows) if rays else []))
            if tr_out is not None and k["raw"][i] is not None:
                nbytes += phase2_bytes(mapping, k["raw"][i], tr["width"],
                                       tr["height"], index_mode)
        if tr_out is not None:
            tr_out.phase2_bytes.append(nbytes)
    log(f"[check] {len(kept)} steps, {len(numbers)} screens, "
        f"{sum(n['rays_checked'] for n in numbers)} rays against the "
        f"reference in {time.perf_counter() - t_ref:.1f} s")
    return numbers


def world_and_renderer(cfg: dict, tr: dict, device: str,
                       cache_dir: str | None):
    """The configuration's world (built on a cache miss), its cache file
    and a Renderer over it at the traffic's screen size: (world path, LOD
    chain, Renderer)."""
    world_path = world_cache.path(cfg, cache_dir or world_cache.CACHE_DIR)
    lods = world_cache.world(cfg, cache_dir or world_cache.CACHE_DIR, log=log)
    if lods[0].voxel_count != cfg.get("lod0_voxels", lods[0].voxel_count):
        raise RuntimeError(f"{cfg['name']}: {lods[0].voxel_count} LOD0 voxels, "
                           f"the configuration states {cfg['lod0_voxels']}")
    t_w = time.perf_counter()
    r = program.renderer(lods, cfg, tr, device)
    if program.gate_on(r) != cfg["gate_resolves"]:
        raise RuntimeError(f"{cfg['name']}: the occupancy gate resolved "
                           f"{program.gate_on(r)}, the configuration says "
                           f"{cfg['gate_resolves']}")
    log(f"[setup] Renderer on {device} in {time.perf_counter() - t_w:.2f} s")
    return world_path, lods, r


def result(cell: bspec.Cell, trace: bool, metrics_dir, e2e: dict, tr_out,
           breakdown, cuda: bool, memory_peak: int, attempted: int,
           numbers: list) -> dict:
    """The result line's object: the cell's end-to-end metrics (untraced)
    or the per-layer ones its readers find in ``tr_out`` (traced), the
    device, the screens attempted and failed, and last the compared numbers
    of the screens checked."""
    import torch

    correct, numbers_out = check.judge(numbers)
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = bspec.reader(m["name"], metrics_dir).read(tr_out)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": memory_peak}
    if cuda:
        dev["card"] = card_line()
    if tr_out is not None and tr_out.busy_ms:
        dev["busy_s"] = sum(tr_out.busy_ms) / 1e3
        dev["window_s"] = tr_out.window_s
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": sum(1 for n in numbers
                         if n["texels_off"] or n["pixels_off"] or n["magenta_pixels"]),
           "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["check"] = numbers_out
    return out


def check_lines(numbers: dict) -> list[str]:
    """The compared numbers, each beside its limit."""
    return [f"check {k}: {v['value']} (limit {v['op']} {v['limit']})"
            for k, v in numbers.items()]
