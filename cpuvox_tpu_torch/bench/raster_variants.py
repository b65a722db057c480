"""Time variants of the rasterize kernel's design constants on a CUDA card.

    python -m cpuvox_tpu_torch.bench.raster_variants

Run from the repository root.  Each variant is the kernel library built from
``csrc/`` with one constant of ``csrc/rasterize.cu`` changed (``kGroup``, the
lanes a ray; ``kSerialRuns``, the runs a column up to which a world's cells
are swept serially), into ``csrc/build/variants/`` (``bench/variants.py``).
Every variant is held against the plain version on the captured states
(tolerance 0) and timed on the device
(``chip_smoke.device_ms``, the best of three), beside the previous kernel
design, at the 1080p shapes ``chip_smoke.py`` times: a terrain2048 chunk on
a live-ray index and at full width, and a layered2048 gated group in each
iteration direction.  The last line of stdout is one JSON object.
"""
from __future__ import annotations

import json
import os
import sys

import torch

from cpuvox_tpu_torch.bench.variants import build_variants, registers, use

# (label, constants of csrc/rasterize.cu to set): the built design first
VARIANTS = [
    ("as built", {}),
    ("kGroup 8", {"kGroup": 8}),
    ("kGroup 32", {"kGroup": 32}),
    ("serial sweep in every world", {"kSerialRuns": 64}),
    ("parallel sweep in every world", {"kSerialRuns": 0}),
]


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
    libs = build_variants(os.path.join(_build.BUILD_DIR, "variants"),
                          VARIANTS, "rasterize.cu")
    for label, lib in libs.items():
        print(f"{label}: {registers(lib, 'rasterize_visits_kernel')}",
              flush=True)
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
