"""The port's benchmark entry: ``bench.py`` on a CUDA card.

    python -m cpuvox_tpu_torch.bench

Prints one JSON line a metric on standard output, in ``bench.py``'s keys
(``metric``, ``value``, ``unit``, ``vs_baseline``, then the mode's extras,
``card`` among them: the card's name and power limit as ``nvidia-smi``
reads them); logs go to standard error.  It needs a CUDA card and has no CPU
mode: with no card it prints the labeled failure record and exits 1, before
any world is built.  It writes no ``BENCHMARK.json``.

Modes, by ``BENCH_SCENE`` (``bench.py``'s names; the metrics as ``bench.py``
names them):

- ``terrain2048`` (the default), ``terrain1024``, ``layered2048``,
  ``layered1024``, ``layered`` (= 1024), ``town<N>`` (the procedural town of
  ``bench/meshes.py`` converted on the card; N 2048) and ``mill<N>`` (the
  repository's ``datasets/mill.obj`` converted on the card where the file
  exists, else the failure record; N 256, as ``bench.py``): the world,
  built or loaded from ``.bench_cache/<scene>.world``; ``Renderer.create``;
  the verify gate; the flythrough (``bench/harness.run_flythrough``):
  ``fps_<scene>_<W>x<H>``;
- ``rollout<N>`` (N 64): ``rollout<N>_cams_per_sec_256x256``;
- ``dynamic<N>`` (N 512): ``fps_dynamic<N>_1280x720_rebuild_per_frame``;
- ``interactive_<scene>`` (``mill1024``; any scene of the first item):
  ``interactive_step_ms_p50_<scene>_<W>x<H>`` at 320x180 and 1920x1080;
- ``convert_<scene>`` (``town2048``; ``town<N>`` or ``mill<N>``): the
  conversion cold, then steady: ``convert_<scene>_seconds_steady_state``.

Knobs, ``bench.py``'s names and defaults: ``BENCH_WH`` (1920x1080),
``BENCH_FRAMES`` (24), ``BENCH_CHUNK`` and ``BENCH_MAX_CHUNKS`` (0: the
Renderer's choice), ``BENCH_OCC`` (auto), ``BENCH_VERIFY`` (1),
``BENCH_DEADLINE_S`` (1500 s from the process's start); and the port's
``BENCH_COMPACT`` (unset: the Renderer's default, which on the card is
the staged march graph, stages of halving width on a live-ray index
packed on the card; ``0`` the full-width graph, ``1`` the staged one: the
flythrough, the rollout and the dynamic world; run the two settings in
turns to compare them) and ``BENCH_EXACT_LOD1=1`` (the dynamic world's
voxel-exact LOD1).

The flythrough's ``value`` is the sequential fps, and its record carries
both of ``bench.py``'s passes (``bench.py:406-413``): ``fps_seq``, a sync
after each frame, and ``fps_pipe``, frame i dispatched before frame i-1 is
waited for (``bench/harness.run_flythrough``; the default Renderer's frame
reads nothing from the device, staged or not, so the host's work on a
frame overlaps the card's on the one before).  Before the flythrough the
verify gate (``bench.py:177-200``) renders one camera through the kernels
and through the plain versions and refuses to report where the screens or
the raybuffers differ.  Any exception, and any magenta (unwritten) pixel,
prints ``{"metric": "<metric>_failed", "value": 0.0, ..., "error": ...}``
and exits 1.  ``bench.py`` labels every failure ``fps_<scene>_failed``;
here ``<metric>`` is the mode's own metric without its resolution
(``fps_terrain2048``, ``rollout64_cams_per_sec``, ``fps_dynamic512``,
``interactive_step_ms_p50_mill1024``,
``convert_town2048_seconds_steady_state``), in the mode's unit.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import signal
import subprocess
import sys
import time
import traceback
from typing import NamedTuple

import torch

# bench.py:22-51: a wall-clock deadline from the process's start, and a
# SIGALRM watchdog a stage budgets against it with
T_START = time.time()
DEADLINE = T_START + float(os.environ.get("BENCH_DEADLINE_S", "1500"))


def remaining() -> float:
    return DEADLINE - time.time()


class StageTimeout(Exception):
    pass


@contextlib.contextmanager
def stage_budget(seconds: float, name: str):
    """SIGALRM watchdog for a bench stage: raises ``StageTimeout(name)``
    after ``seconds``, once control is back in Python (a launch or a sync
    that hangs is not cut short).  Main thread only."""
    def handler(signum, frame):
        raise StageTimeout(name)

    old = signal.signal(signal.SIGALRM, handler)
    signal.alarm(max(1, int(seconds)))
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def emit(record: dict) -> None:
    """One record, one JSON line on standard output."""
    print(json.dumps(record), flush=True)


def card_line() -> str:
    """``nvidia-smi``'s name and power limit, one card's to a ``; ``."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return "; ".join(r.stdout.strip().splitlines())


REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the reference's own mesh, where the reference keeps it
MILL_OBJ = os.path.join(REPO, "datasets", "mill.obj")
MESH_SCENE = re.compile(r"(town|mill)(\d*)")
MESH_DEFAULT_DIM = {"town": 2048, "mill": 256}  # mill: bench.py:134
ROLLOUT_WH = (256, 256)
DYNAMIC_WH = (1280, 720)
INTERACTIVE_WHS = ((320, 180), (1920, 1080))
VERIFY_MIN_S = 360  # bench.py:391: the gate needs this much of the deadline
# the camera the gate renders, at this fraction of the path (bench.py:189)
VERIFY_PATH_T = 0.35


@dataclasses.dataclass(frozen=True)
class Knobs:
    """The environment's settings of a run (``bench.py``'s names)."""

    wh: tuple[int, int] = (1920, 1080)
    frames: int = 24
    chunk: int = 0
    max_chunks: int = 0
    occ: str = "auto"
    verify: bool = True
    compact: bool | None = None  # None: the Renderer's own setting
    exact_lod1: bool = False

    @classmethod
    def from_env(cls, env=os.environ) -> "Knobs":
        w, h = (int(x) for x in env.get("BENCH_WH", "1920x1080").split("x"))
        return cls(wh=(w, h), frames=int(env.get("BENCH_FRAMES", "24")),
                   chunk=int(env.get("BENCH_CHUNK", "0")),
                   max_chunks=int(env.get("BENCH_MAX_CHUNKS", "0")),
                   occ=env.get("BENCH_OCC", "auto"),
                   verify=env.get("BENCH_VERIFY", "1") == "1",
                   compact={"1": True, "0": False}.get(
                       env.get("BENCH_COMPACT", "")),
                   exact_lod1=env.get("BENCH_EXACT_LOD1", "0") == "1")


class Mode(NamedTuple):
    """What a ``BENCH_SCENE`` runs and the records it prints."""

    kind: str  # flythrough, rollout, dynamic, interactive or convert
    world: str  # the scene of its world, or the rollout's or dynamic's N
    metrics: tuple[str, ...]  # the metric names, in the order printed
    failed: str  # the failure record's metric
    unit: str


def mesh_scene(scene: str) -> tuple[str, int] | None:
    """(``town`` or ``mill``, max_dimension) of a mesh scene, else None."""
    m = MESH_SCENE.fullmatch(scene)
    if m is None:
        return None
    return m[1], int(m[2] or MESH_DEFAULT_DIM[m[1]])


def _check_world(scene: str) -> str:
    from cpuvox_tpu_torch.bench import harness

    if scene not in harness.SCENE_BUILDS and mesh_scene(scene) is None:
        raise ValueError(
            f"unknown scene {scene!r}: one of {sorted(harness.SCENE_BUILDS)}, "
            "town<N> or mill<N>")
    return scene


def parse_mode(scene: str, wh=(1920, 1080)) -> Mode:
    """The mode of ``BENCH_SCENE`` ``scene`` (``bench.py:334-357``'s
    dispatch) at the flythrough's resolution ``wh``."""
    if scene.startswith("interactive"):
        world = _check_world(scene[12:] or "mill1024")
        p = f"interactive_step_ms_p50_{world}"
        return Mode("interactive", world,
                    tuple(f"{p}_{w}x{h}" for w, h in INTERACTIVE_WHS),
                    f"{p}_failed", "ms")
    if scene.startswith("convert"):
        world = scene[8:] or "town2048"
        if mesh_scene(world) is None:
            raise ValueError(f"convert_{world}: a conversion takes a mesh "
                             "scene, town<N> or mill<N>")
        m = f"convert_{world}_seconds_steady_state"
        return Mode("convert", world, (m,), f"{m}_failed", "s")
    if scene.startswith("rollout"):
        n = int(scene[7:] or "64")
        p = f"rollout{n}_cams_per_sec"
        return Mode("rollout", str(n), (f"{p}_{ROLLOUT_WH[0]}x"
                                        f"{ROLLOUT_WH[1]}",),
                    f"{p}_failed", "cams/s")
    if scene.startswith("dynamic"):
        n = int(scene[7:] or "512")
        p = f"fps_dynamic{n}"
        return Mode("dynamic", str(n), (f"{p}_{DYNAMIC_WH[0]}x{DYNAMIC_WH[1]}"
                                        "_rebuild_per_frame",),
                    f"{p}_failed", "fps")
    world = _check_world(scene)
    return Mode("flythrough", world, (f"fps_{world}_{wh[0]}x{wh[1]}",),
                f"fps_{world}_failed", "fps")


def mesh_obj(kind: str) -> str:
    """The .obj of a mesh scene: the procedural town, written to
    .bench_cache/town.obj, or the repository's mill.obj, which must exist
    (no other mesh stands in for it)."""
    from cpuvox_tpu_torch.bench import harness

    if kind == "town":
        return harness.town_obj(log=log)
    if not os.path.exists(MILL_OBJ):
        raise FileNotFoundError(
            f"{os.path.relpath(MILL_OBJ, REPO)} is not in the repository; "
            "BENCH_SCENE=town<N> runs the procedural town")
    return MILL_OBJ


def world_lods(scene: str):
    """The LOD chain of a flythrough scene, cached in
    .bench_cache/<scene>.world (``bench.py:106-174``): a procedural world
    built on the host, or a mesh converted on the card at 6 LODs."""
    from cpuvox_tpu_torch.bench import harness

    if scene in harness.SCENE_BUILDS:
        return harness.scene_world(scene, log=log)

    def convert():
        from cpuvox_tpu_torch.assets.pipeline import convert_obj_to_world

        kind, max_dim = mesh_scene(scene)
        return convert_obj_to_world(mesh_obj(kind), max_dimension=max_dim,
                                    lod_levels=6, device="cuda")

    return harness._cached(scene, convert, log)


def _differ(a: torch.Tensor, b: torch.Tensor) -> int:
    """Elements that differ; every one where the shapes differ."""
    if a.shape != b.shape:
        return max(a.numel(), b.numel())
    return int((a != b).sum())


def verify_backends(renderer) -> None:
    """Refuse to benchmark kernels that diverge from the plain path on the
    card (``bench.py:177-200``): one camera of the path rendered through
    the kernels and through the plain versions (``backend="xla"``, the same
    device world), the screens and the raybuffers compared element for
    element.  A difference prints ``BACKEND_DIVERGENCE`` and exits 1."""
    from cpuvox_tpu_torch.bench.path import BENCH_CLIP_LENGTH, benchmark_camera

    cfg = renderer.config
    cam = benchmark_camera(VERIFY_PATH_T * BENCH_CLIP_LENGTH,
                           renderer.device_world.dims,
                           (cfg.width, cfg.height))
    t0 = time.time()
    s_fast, rb_fast, _ = renderer.render_device(cam)
    plain = dataclasses.replace(
        renderer, config=dataclasses.replace(cfg, backend="xla"))
    s_ref, rb_ref, _ = plain.render_device(cam)
    screen, raybuf = _differ(s_fast, s_ref), _differ(rb_fast, rb_ref)
    log(f"backend verify ({cfg.backend} vs xla, on the device): {screen} "
        f"screen pixels and {raybuf} raybuffer texels differ "
        f"({time.time() - t0:.1f} s)")
    if screen or raybuf:
        emit({"metric": "BACKEND_DIVERGENCE", "value": screen + raybuf,
              "unit": "pixels", "vs_baseline": 0.0, "screen_pixels": screen,
              "raybuffer_texels": raybuf})
        raise SystemExit(1)


def _no_magenta(n: int, what: str) -> None:
    if n:
        raise RuntimeError(f"{n} magenta (unwritten) pixels in {what}")


def run_flythrough_mode(mode: Mode, k: Knobs) -> list[dict]:
    """``bench.py:359-427``: the world, the Renderer, the verify gate
    (skipped with less than ``VERIFY_MIN_S`` of the deadline left), the
    flythrough."""
    from cpuvox_tpu_torch.bench import harness
    from cpuvox_tpu_torch.config import RenderConfig
    from cpuvox_tpu_torch.render.frame import Renderer

    lods = world_lods(mode.world)
    cfg = RenderConfig(width=k.wh[0], height=k.wh[1], chunk_steps=k.chunk,
                       max_march_chunks=k.max_chunks, occupancy_gate=k.occ)
    t0 = time.time()
    renderer = Renderer.create(lods, cfg, compact=k.compact)
    torch.cuda.synchronize()
    log(f"device world uploaded in {time.time() - t0:.1f} s (max_runs "
        f"{renderer.device_world.max_runs}, gate "
        f"{'on' if renderer.occupancy_on else 'off'})")

    verify = "ok"
    if renderer.kernels and k.verify:
        if remaining() < VERIFY_MIN_S:
            verify = "skipped_deadline"
            log(f"verify SKIPPED: {remaining():.0f} s left of the deadline")
        else:
            try:
                with stage_budget(remaining() - 180, "verify"):
                    verify_backends(renderer)
            except StageTimeout:
                verify = "timeout"
                log("verify timed out; going on to the frames")

    with stage_budget(max(120, remaining() - 30), "flythrough"):
        m = harness.run_flythrough(renderer, n_frames=k.frames, log=log)
    _no_magenta(m["magenta_pixels"], "the flythrough")
    fps = m["fps"]
    rec = {"metric": mode.metrics[0], "value": round(fps, 3), "unit": "fps",
           "vs_baseline": round(fps / 60.0, 4),
           "fps_seq": round(m["fps_seq"], 3),
           "fps_pipe": round(m["fps_pipe"], 3),
           "frame_ms_p50": round(m["frame_ms_p50"], 3),
           "ray_columns_per_sec": round(m["ray_columns_per_sec"]),
           "world_voxels_lod0": m["world_voxels_lod0"],
           "world_voxels_all_lods": m["world_voxels"],
           "n_frames": m["n_frames"],
           "frame_gpu_ms_p50": round(m["frame_gpu_ms_p50"], 3),
           "magenta_pixels": m["magenta_pixels"]}
    if verify != "ok":
        rec["verify"] = verify
    return [rec]


def run_rollout_mode(mode: Mode, k: Knobs) -> list[dict]:
    """``bench.py:203-251``: steps of N cameras at 256x256."""
    from cpuvox_tpu_torch.bench import harness

    r = harness.rollout_renderer(ROLLOUT_WH, compact=k.compact)
    m = harness.run_rollout(r, n_cams=int(mode.world), log=log)
    _no_magenta(m["magenta_pixels"], "the rollout")
    cps = m["cams_per_sec"]
    return [{"metric": mode.metrics[0], "value": round(cps, 2),
             "unit": "cams/s", "vs_baseline": round(cps / 60.0, 4),
             "n_steps": m["n_steps"], "magenta_pixels": 0}]


def run_dynamic_mode(mode: Mode, k: Knobs) -> list[dict]:
    """``bench.py:254-282``: the dynamic terrain rebuilt and rendered a
    frame at 1280x720."""
    from cpuvox_tpu_torch.bench import harness

    terrain = harness.dynamic_terrain(size=int(mode.world), wh=DYNAMIC_WH,
                                      exact_lod1=k.exact_lod1,
                                      compact=k.compact)
    m = harness.run_dynamic(terrain, log=log)
    _no_magenta(m["magenta_pixels"], "the dynamic frames")
    fps = m["fps"]
    return [{"metric": mode.metrics[0], "value": round(fps, 3), "unit": "fps",
             "vs_baseline": round(fps / 60.0, 4), "n_frames": m["n_frames"],
             "magenta_pixels": 0}]


def run_interactive_mode(mode: Mode, k: Knobs) -> list[dict]:
    """``bench.py:285-316``: an ``InteractiveSession`` a resolution on the
    scene's world, each step waiting for its frame; the step p50."""
    from cpuvox_tpu_torch.bench import harness

    out = harness.run_interactive(world_lods(mode.world),
                                  whs=INTERACTIVE_WHS, log=log)
    recs = []
    for name, (w, h) in zip(mode.metrics, INTERACTIVE_WHS):
        m = out[f"{w}x{h}"]
        _no_magenta(m["magenta_pixels"], f"the {w}x{h} steps")
        p50 = m["step_ms_p50"]
        recs.append({"metric": name, "value": round(p50, 3), "unit": "ms",
                     "vs_baseline": round(16.7 / p50, 4),
                     "fps": round(m["fps"], 2), "n_steps": m["n_steps"],
                     "magenta_pixels": 0})
    return recs


def run_convert_mode(mode: Mode, k: Knobs) -> list[dict]:
    """The mesh converted on the card twice (``harness.run_convert``); the
    second conversion's seconds.  ``vs_baseline`` is the reference's 30 s
    for its mill, as the JAX package's records took it
    (``BENCH_EXTRA_r03.json:31``)."""
    from cpuvox_tpu_torch.bench import harness

    kind, max_dim = mesh_scene(mode.world)
    m, _lods = harness.run_convert(mesh_obj(kind), max_dim=max_dim,
                                   lod_levels=6, log=log)
    s = m["seconds_steady"]
    return [{"metric": mode.metrics[0], "value": round(s, 4), "unit": "s",
             "vs_baseline": round(30.0 / s, 4),
             "seconds_cold": round(m["seconds_cold"], 4),
             "lod0_voxels": m["lod0_voxels"]}]


RUNNERS = {"flythrough": run_flythrough_mode, "rollout": run_rollout_mode,
           "dynamic": run_dynamic_mode, "interactive": run_interactive_mode,
           "convert": run_convert_mode}


def main() -> int:
    scene = os.environ.get("BENCH_SCENE", "terrain2048")
    failed, unit = f"fps_{scene}_failed", "fps"
    try:
        knobs = Knobs.from_env()
        mode = parse_mode(scene, knobs.wh)
        failed, unit = mode.failed, mode.unit
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device (torch.cuda.is_available() is "
                               "False): the bench runs only on the card")
        card = card_line()
        log(f"[bench] {scene} ({mode.kind}) on {card} | torch "
            f"{torch.__version__} cuda {torch.version.cuda}")
        for rec in RUNNERS[mode.kind](mode, knobs):
            emit({**rec, "card": card})
    except Exception as e:  # noqa: BLE001 -- always leave a labeled record
        log(traceback.format_exc())
        emit({"metric": failed, "value": 0.0, "unit": unit,
              "vs_baseline": 0.0, "error": f"{type(e).__name__}: {e}"[:300]})
        return 1
    return 0
