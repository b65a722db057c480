"""One run of one cell: the world, the Renderer, the warm-up, the timed
window, the per-layer readings of a traced run and, once the window has
closed, the comparison with the plain reference.

The window drives the traffic's entry: ``render_device`` (frame i
dispatched, then frame i-1 waited for) or ``render`` (the screen on the
host before the next camera).  Nothing in it builds or captures: every
variant the path needs was rendered in set-up, and a capture inside the
window fails the run.
"""
from __future__ import annotations

import gc
import subprocess
import sys
import time

import numpy as np

from voxbench import program, stats
from voxbench import spec as bspec
from voxbench.reference import check
from voxbench.reference import frame as rf
from voxbench.reference import rows
from voxbench.trace import Keep, Spans, Trace
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

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg, tr = cell.config, cell.traffic
    if tr["entry"] not in ("render", "render_device"):
        raise ValueError(f"unknown entry {tr['entry']!r}")
    waited = tr["entry"] == "render"

    world_path = world_cache.path(cfg, cache_dir or world_cache.CACHE_DIR)
    lods = world_cache.world(cfg, cache_dir or world_cache.CACHE_DIR, log=log)
    if lods[0].voxel_count != cfg.get("lod0_voxels", lods[0].voxel_count):
        raise RuntimeError(f"{cfg['name']}: {lods[0].voxel_count} LOD0 voxels, "
                           f"the configuration states {cfg['lod0_voxels']}")
    dims = lods[0].dims
    t_w = time.perf_counter()
    r = program.renderer(lods, cfg, tr, device)
    if program.gate_on(r) != cfg["gate_resolves"]:
        raise RuntimeError(f"{cfg['name']}: the occupancy gate resolved "
                           f"{program.gate_on(r)}, the configuration says "
                           f"{cfg['gate_resolves']}")
    log(f"[setup] Renderer on {device} in {time.perf_counter() - t_w:.2f} s")
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
    correct, numbers_out = check.judge(numbers)
    log(f"[check] {len(kept)} frames, {sum(n['rays_checked'] for n in numbers)}"
        f" rays against the reference in {time.perf_counter() - t_ref:.1f} s")

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
    out = {"correct": bool(correct), "attempted": len(handed),
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
