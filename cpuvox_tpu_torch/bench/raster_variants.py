"""Time variants of the rasterize kernel's design constants on a CUDA card.

    python -m cpuvox_tpu_torch.bench.raster_variants

Run from the repository root.  Each variant is the kernel library built from
``csrc/`` with one constant of ``csrc/rasterize.cu`` changed (``kGroup``, the
lanes a ray; ``kSerialRuns``, the runs a column up to which a world's cells
are swept serially), into ``csrc/build/variants/``.  Every variant is held against the
plain version on the captured states (tolerance 0) and timed on the device
(``chip_smoke.device_ms``, the best of three), beside the previous kernel
design, at the 1080p shapes ``chip_smoke.py`` times: a terrain2048 chunk on
a live-ray index and at full width, and a layered2048 gated group in each
iteration direction.  The last line of stdout is one JSON object.
"""
from __future__ import annotations

import ctypes
import glob
import json
import os
import re
import shutil
import subprocess
import sys

import torch

# (label, constants of csrc/rasterize.cu to set): the built design first
VARIANTS = [
    ("as built", {}),
    ("kGroup 8", {"kGroup": 8}),
    ("kGroup 32", {"kGroup": 32}),
    ("serial sweep in every world", {"kSerialRuns": 64}),
    ("parallel sweep in every world", {"kSerialRuns": 0}),
]


def build_variants(out_dir: str) -> dict:
    """Build every variant's library in parallel; returns label -> path."""
    from cpuvox_tpu_torch.ops import _build

    shutil.rmtree(out_dir, ignore_errors=True)
    procs = {}
    for i, (label, consts) in enumerate(VARIANTS):
        d = os.path.join(out_dir, str(i))
        os.makedirs(d)
        for src in glob.glob(os.path.join(_build.CSRC, "*.cu*")):
            with open(src) as f:
                txt = f.read()
            for name, value in consts.items():
                txt, n = re.subn(rf"constexpr int {name} = -?\d+;",
                                 f"constexpr int {name} = {value};", txt)
                if src.endswith("rasterize.cu") and n != 1:
                    raise RuntimeError(f"{name} not found in {src}")
            with open(os.path.join(d, os.path.basename(src)), "w") as f:
                f.write(txt)
        lib = os.path.join(d, "lib.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib,
               *sorted(glob.glob(os.path.join(d, "*.cu")))]
        procs[label] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT,
                                              text=True))
    libs = {}
    for label, (lib, p) in procs.items():
        out = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {label}:\n{out}")
        libs[label] = lib
    return libs


def registers(lib: str) -> str:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-res-usage", lib], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    m = re.search(r"rasterize_visits_kernel.*?\n\s*REG:(\d+) STACK:(\d+)",
                  out)
    return f"{m.group(1)} registers, stack {m.group(2)} B" if m else "?"


def use(lib: str) -> None:
    """Make the ops wrappers call into ``lib``."""
    from cpuvox_tpu_torch.ops import _build

    _build._lib = ctypes.CDLL(lib)
    _build._lib.cpuvox_error_string.argtypes = [ctypes.c_int]
    _build._lib.cpuvox_error_string.restype = ctypes.c_char_p
    _build._functions.clear()


def main() -> int:
    if not torch.cuda.is_available():
        print("raster_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from cpuvox_tpu_torch.bench.capture import capture, clone
    from cpuvox_tpu_torch.bench.harness import layered2048, terrain2048
    from cpuvox_tpu_torch.config import RenderConfig
    from cpuvox_tpu_torch.ops import _build, phase1_kernel
    from cpuvox_tpu_torch.render.frame import Renderer

    card = cs.card_line()
    print(card, flush=True)
    libs = build_variants(os.path.join(_build.BUILD_DIR, "variants"))
    for label, lib in libs.items():
        print(f"{label}: {registers(lib)}", flush=True)
    use(libs[VARIANTS[0][0]])
    dev = torch.device("cuda", 0)
    cfg = RenderConfig(width=cs.MAIN_WH[0], height=cs.MAIN_WH[1])
    caps = []
    r = Renderer.create(terrain2048(log=print), cfg, device=dev)
    cam = cs.path_camera(r, 0.35)
    caps.append(("terrain2048, live-ray index",
                 cs.capture_compacted(r, cam, k=2)[0]))
    caps.append(("terrain2048, full width",
                 capture(r, cam, k=2, compact=False)))
    del r
    r = Renderer.create(layered2048(log=print), cfg, device=dev)
    for t in (0.35, 0.6):
        cap = cs.capture_compacted(r, cs.path_camera(r, t), k=3)[0]
        caps.append((f"layered2048, direction "
                     f"{cap.frame.iteration_direction:+d}", cap))
    del r
    wants = [phase1_kernel.rasterize_visits_ref(
        clone(cap.rs), cap.wa, cap.src, cap.frame.static, cap.consts,
        cap.frame.iteration_direction, index=cap.index) for _, cap in caps]

    def timed(fn, cap):
        cs.time_ms(fn, 2, lambda: clone(cap.rs))  # warm
        return min(cs.device_ms(fn, lambda: clone(cap.rs), 10)
                   for _ in range(3))

    result = {"card": card, "ms": {}}
    for label, lib in libs.items():
        use(lib)
        for (name, cap), want in zip(caps, wants):
            args = (cap.frame.static, cap.consts,
                    cap.frame.iteration_direction)

            def fn(rs, cap=cap, args=args):
                phase1_kernel.rasterize_visits(rs, cap.wa, cap.src, *args,
                                               index=cap.index)

            got = clone(cap.rs)
            fn(got)
            cs.compare(f"{label}, {name}", got, want, {})
            ms = timed(fn, cap)
            result["ms"][f"{label} | {name}"] = ms
            print(f"[variant] {label:26s} {name:30s} {ms:.4f} ms on the "
                  f"device a launch, 0 elements differ ({card})", flush=True)
    use(libs[VARIANTS[0][0]])
    for name, cap in caps:
        args = (cap.frame.static, cap.consts, cap.frame.iteration_direction)

        def old(rs, cap=cap, args=args):
            phase1_kernel.rasterize_chunk(rs, cap.cells, *args,
                                          index=cap.index)

        ms = timed(old, cap)
        result["ms"][f"previous design | {name}"] = ms
        print(f"[variant] {'previous design':26s} {name:30s} {ms:.4f} ms on "
              f"the device a launch ({card})", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
