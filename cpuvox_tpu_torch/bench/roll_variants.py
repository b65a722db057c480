"""Time variants of the roll kernel's design on a CUDA card.

    python -m cpuvox_tpu_torch.bench.roll_variants

Run from the repository root.  Each variant is ``csrc/roll.cu`` built with
some of its constants changed (``bench/variants.py``) into
``csrc/build/variants/``: ``kBlock``, the threads a block; ``kLodRegisters``
0, the LOD distance loaded from memory on every step; the previous design,
both as they were before (``PREVIOUS_DESIGN``); and, as diagnostics that
no path runs, each of the two without its visit stores (``kStoreVisits``
0), which splits a launch's time between the step chain and the stores.
Every variant but the diagnostics is held against the plain version
(tolerance 0: visits, DDA state and alive); the diagnostics only in the
state.  Each is timed on the device (``chip_smoke.device_ms``, the best of
three) at the 1080p shapes ``chip_smoke.py`` captures: a terrain2048 chunk
(C 32) on a live-ray index and at full width, a layered2048 gated iteration
(C 128) on a live-ray index and at full width.  The last line of stdout is
one JSON object.
"""
from __future__ import annotations

import json
import os
import sys

import torch

from cpuvox_tpu_torch.bench.variants import build_variants, registers, use

# csrc/roll.cu's constants as its first design had them
PREVIOUS_DESIGN = {"kBlock": 128, "kLodRegisters": 0}
NO_STORES = {"kStoreVisits": 0}
# (label, constants of csrc/roll.cu to set): the built design first
VARIANTS = [
    ("as built", {}),
    ("kBlock 64", {"kBlock": 64}),
    ("kBlock 128", {"kBlock": 128}),
    ("LOD distance loaded every step", {"kLodRegisters": 0}),
    ("previous design", PREVIOUS_DESIGN),
    ("as built, no visit stores", NO_STORES),
    ("previous design, no visit stores", {**PREVIOUS_DESIGN, **NO_STORES}),
]
SOURCES = ["roll.cu", "error.cu"]


def build(out_dir: str, variants=VARIANTS) -> dict:
    """Build roll-only libraries of ``variants``; label -> path."""
    return build_variants(out_dir, variants, "roll.cu", SOURCES)


def main() -> int:
    if not torch.cuda.is_available():
        print("roll_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from cpuvox_tpu_torch.bench.capture import capture, clone
    from cpuvox_tpu_torch.bench.harness import layered2048, terrain2048
    from cpuvox_tpu_torch.config import RenderConfig
    from cpuvox_tpu_torch.ops import _build, roll_kernel
    from cpuvox_tpu_torch.render.frame import Renderer

    card = cs.card_line()
    print(card, flush=True)
    libs = build(os.path.join(_build.BUILD_DIR, "variants"))
    for label, lib in libs.items():
        print(f"{label}: {registers(lib, 'roll_chunk_kernel')}", flush=True)
    dev = torch.device("cuda", 0)
    cfg = RenderConfig(width=cs.MAIN_WH[0], height=cs.MAIN_WH[1])
    caps = []  # captured through the main library (the roll's variants
    # hold only the roll)
    for scene, build_lods, t, k in (("terrain2048", terrain2048, 0.35, 2),
                                    ("layered2048", layered2048, 0.35, 3)):
        r = Renderer.create(build_lods(log=print), cfg, device=dev)
        cam = cs.path_camera(r, t)
        dims = r.device_world.dims
        cap = cs.capture_compacted(r, cam, k=k)[0]
        caps.append((f"{scene}, C {cap.chunk}, live-ray index", cap, dims))
        cap = capture(r, cam, k=k, compact=False)
        caps.append((f"{scene}, C {cap.chunk}, full width", cap, dims))
        del r
    wants = [roll_kernel.roll_chunk_ref(
        clone(cap.dda), cap.alive.clone(), cap.frame.static.dirs,
        cap.lod_distances, cap.far, dims, cap.chunk, index=cap.index)
        for _, cap, dims in caps]

    result = {"card": card, "ms": {}}
    for label, lib in libs.items():
        use(lib)
        diagnostic = "no visit stores" in label
        for (name, cap, dims), want in zip(caps, wants):
            rest = (cap.frame.static.dirs, cap.lod_distances, cap.far, dims,
                    cap.chunk)

            def fn(a, rest=rest, cap=cap):
                return roll_kernel.roll_chunk(*a, *rest, index=cap.index)

            def setup(cap=cap):
                return clone(cap.dda), cap.alive.clone()

            dda, alive, visits = fn(setup())
            got, ref = [*dda, alive], [*want[0], want[1]]
            if not diagnostic:
                got, ref = got + [visits], ref + [want[2]]
            cs.compare(f"{label}, {name}", got, ref, {})
            cs.time_ms(fn, 2, setup)  # warm
            ms = min(cs.device_ms(fn, setup, 10) for _ in range(3))
            result["ms"][f"{label} | {name}"] = ms
            print(f"[variant] {label:34s} {name:40s} {ms:.4f} ms on the "
                  f"device a launch, 0 elements differ"
                  f"{' (state only)' if diagnostic else ''} ({card})",
                  flush=True)
    use(_build.build())
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
