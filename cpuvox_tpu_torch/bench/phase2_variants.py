"""Time the fused phase-2 kernel, its diagnostics and its previous design
on a CUDA card.

    python -m cpuvox_tpu_torch.bench.phase2_variants

Run from the repository root.  The kernel (``csrc/reproject.cu``) is built
as it is and with each diagnostic constant at 0 (``bench/variants.py``,
into ``csrc/build/variants/``): ``kIndexMath`` 0 puts a fixed map in place
of the per-pixel index math, ``kGather`` 0 skips the raybuffer reads, so
that a launch's time splits between the two.  The diagnostics give wrong
screens and run on no path.  The kernel as built is held against its plain
version (tolerance 0).  Beside them, on the same inputs, the previous
design: the two sample passes on the maps torch computes, and the whole
torch phase 2 around them (``reproject_kernel.reproject_screen_two_pass``).
Device times are ``chip_smoke.device_ms``, the best of three; the torch
phase 2 waits on its table copies, so it is timed a call.  The frames are
terrain2048's at 1080p: the benchmark path's camera at 0.35 (one segment),
the same view rendered at scale 0.5 and upscaled, and a camera looking
down at 60 degrees (the vanishing point on the screen: four segments).
The last line of stdout is one JSON object.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys

import torch

from cpuvox_tpu_torch.bench.variants import build_variants, use

# (label, constants of csrc/reproject.cu to set): the built design first
VARIANTS = [
    ("as built", {}),
    ("no index math (diagnostic)", {"kIndexMath": 0}),
    ("no gather (diagnostic)", {"kGather": 0}),
]
SOURCES = ["reproject.cu", "error.cu"]


def main() -> int:
    if not torch.cuda.is_available():
        print("phase2_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from cpuvox_tpu_torch.bench.harness import terrain2048
    from cpuvox_tpu_torch.config import RenderConfig
    from cpuvox_tpu_torch.ops import _build, reproject_kernel as rk
    from cpuvox_tpu_torch.render import camera as cm
    from cpuvox_tpu_torch.render.frame import Renderer

    card = cs.card_line()
    print(card, flush=True)
    libs = build_variants(os.path.join(_build.BUILD_DIR, "variants"),
                          VARIANTS, "reproject.cu", SOURCES)
    dev = torch.device("cuda", 0)
    cfg = RenderConfig(width=cs.MAIN_WH[0], height=cs.MAIN_WH[1])
    r = Renderer.create(terrain2048(log=print), cfg, device=dev)
    half = dataclasses.replace(r, config=dataclasses.replace(
        cfg, render_scale=0.5), lod_distances=None)
    steep = cm.Camera(position=(1024.0, 120.0, 700.0), pitch_deg=-60.0,
                      yaw_deg=30.0, screen=cs.MAIN_WH)
    frames = []  # (name, reproject_screen's arguments, the sample's maps)
    for name, renderer, cam in (
            ("path t=0.35", r, cs.path_camera(r, 0.35)),
            ("path t=0.35, scale 0.5", half, cs.path_camera(half, 0.35)),
            ("looking down 60 degrees", r, steep)):
        f = renderer.frame_setup(cam)
        args = renderer.phase2_args(f, renderer.march(f))
        segments = int(f.tables["active"].sum())
        frames.append((f"{name} ({segments} segment"
                       f"{'s' if segments > 1 else ''})", args,
                       cs.sample_maps(renderer, f.tables)))

    def best_device_ms(fn):
        cs.time_ms(fn, 2)  # warm
        return min(cs.device_ms(fn, lambda: None, 20) for _ in range(3))

    result = {"card": card, "ms": {}}
    for label, lib in libs.items():
        use(lib)
        for name, args, _maps in frames:
            def fn(_, args=args):
                return rk.reproject_screen(*args)

            if label == VARIANTS[0][0]:
                cs.compare(f"{label}, {name}", [fn(None)],
                           [rk.reproject_screen_ref(*args)], {})
            ms = best_device_ms(fn)
            result["ms"][f"{label} | {name}"] = ms
            print(f"[variant] {label:28s} {name:40s} {ms:.4f} ms on the "
                  f"device a launch ({card})", flush=True)
    use(_build.build())
    for name, args, maps in frames:
        raybuf = args[0]
        ms = best_device_ms(lambda _: [rk.sample_raybuffer(raybuf, *m)
                                       for m in maps])
        call_ms = cs.time_ms(lambda _: rk.reproject_screen_two_pass(*args),
                             20)
        result["ms"][f"previous design, two sample passes | {name}"] = ms
        result["ms"][f"previous design, torch phase 2 a call | {name}"] = (
            call_ms)
        print(f"[variant] {'previous design':28s} {name:40s} {ms:.4f} ms on "
              f"the device (two sample passes), the torch phase 2 around "
              f"them {call_ms:.4f} ms a call ({card})", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
