"""Headless demo app on a torch device — the frame-driver equivalent of the
reference's UnityManager (load/convert worlds, render modes, resolution
scaling, flythrough; UnityManager.cs), and the port's counterpart of
``demo.py``.

Usage:
  python -m cpuvox_tpu_torch.demo --frames 8 --out frames           # orbit the town
  python -m cpuvox_tpu_torch.demo --world file.world --mode raybuffer-topdown
  python -m cpuvox_tpu_torch.demo --obj model.obj --max-dim 256 --save model.world
  python -m cpuvox_tpu_torch.demo --scene terrain --flythrough --frames 24
  python -m cpuvox_tpu_torch.demo --obj model.obj --device cpu      # no card
  python -m cpuvox_tpu_torch.demo --scene terrain --world-shard --tile-cols 128
  python -m cpuvox_tpu_torch.demo --scene terrain --frames 24 --profile

Render modes mirror the reference's keys 1/2/3 (screen buffer / raw raybuffer
views, UnityManager.cs:126-146); frames are written as PPM (plus PNG when PIL
is present).  The town is the procedural mesh of ``bench/meshes.py``; the
reference's mill.obj is not in the repository.
"""
import argparse
import os
import sys
import time

MILL = "datasets/mill.obj"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", choices=["town", "mill", "terrain"],
                    default="town")
    ap.add_argument("--obj", help=".obj to convert (overrides --scene)")
    ap.add_argument("--world", help=".world file to load (overrides --scene)")
    ap.add_argument("--save", help="save converted world to this .world path")
    ap.add_argument("--max-dim", type=int, default=256)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=360)
    ap.add_argument("--res-scale", type=float, default=1.0,
                    help="resolution multiplier (keys 4/5 in the reference)")
    ap.add_argument("--mode", default="screen",
                    choices=["screen", "raybuffer-topdown",
                             "raybuffer-leftright"])
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--interactive", action="store_true",
                    help="live terminal loop (WASD + arrows; reference key "
                         "1-3 render modes; UnityManager.Update equivalent)")
    ap.add_argument("--flythrough", action="store_true",
                    help="use the benchmark path instead of an orbit")
    ap.add_argument("--backend", default="kernels", choices=["kernels", "xla"],
                    help="the hand-written kernels, or their plain torch "
                         "versions (xla)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the conversion and the renderer")
    ap.add_argument("--world-shard", action="store_true",
                    help="stripe LOD0 over every CUDA device (over --device "
                         "when it names one) and render through the "
                         "camera-local window exchange "
                         "(parallel/world_shard.py)")
    ap.add_argument("--tile-cols", type=int, default=256,
                    help="world-shard tile side in columns (power of two)")
    ap.add_argument("--lod-error", type=float, default=1.0)
    ap.add_argument("--out", default="demo_frames")
    ap.add_argument("--profile", action="store_true",
                    help="print each phase's time, and write the recorder's "
                    "Chrome trace (host spans, sampled march-graph spans) "
                    "to OUT/trace.json")
    return ap.parse_args(argv)


def build_world(args):
    if args.world:
        from cpuvox_tpu_torch.world.save import load_world

        return load_world(args.world)
    if args.scene == "terrain" and not args.obj:
        from cpuvox_tpu_torch.models.procedural import heightmap_world

        return heightmap_world(dims=(512, 128, 512), seed=7, shell_depth=6)
    obj = args.obj
    if obj is None and args.scene == "mill":
        raise FileNotFoundError(
            f"--scene mill converts the reference's {MILL}, which is not in "
            "this repository: pass it with --obj, or use --scene town")
    if obj is None:
        from cpuvox_tpu_torch.bench.meshes import write_town_obj

        os.makedirs(args.out, exist_ok=True)
        obj = os.path.join(args.out, "town.obj")
        write_town_obj(obj)
    from cpuvox_tpu_torch.assets.pipeline import convert_obj_to_world

    return convert_obj_to_world(obj, max_dimension=args.max_dim,
                                save_path=args.save, verbose=True,
                                device=args.device)


def main(argv=None):
    args = parse_args(argv)
    if args.world_shard and args.interactive:
        # the JAX demo fails here too: its InteractiveSession reads
        # renderer.device_world, which a ShardedRenderer does not have
        raise NotImplementedError(
            "--world-shard with --interactive is not ported: the JAX "
            "package's InteractiveSession cannot drive its ShardedRenderer "
            "either")
    os.makedirs(args.out, exist_ok=True)

    import numpy as np

    from cpuvox_tpu_torch.bench.path import BENCH_CLIP_LENGTH, benchmark_camera
    from cpuvox_tpu_torch.config import RenderConfig
    from cpuvox_tpu_torch.parallel.mesh import RenderMesh
    from cpuvox_tpu_torch.render import camera as cm
    from cpuvox_tpu_torch.render.frame import Renderer
    from cpuvox_tpu_torch.utils.colors import to_rgb_image, write_ppm
    from cpuvox_tpu_torch.utils.profiling import FrameProfiler

    prof = FrameProfiler(args.device)
    if args.profile:
        prof.start_device_trace(args.out)
    lods = build_world(args)
    dims = lods[0].dims
    w, h = args.width, args.height
    # reference keys 4/5: render low-res through the fake camera, display
    # native
    cfg = RenderConfig(width=w, height=h, render_scale=args.res_scale,
                       lod_error=args.lod_error, backend=args.backend)
    with prof.scope("create-renderer"):
        if args.world_shard:
            from cpuvox_tpu_torch.parallel.world_shard import ShardedRenderer

            # every CUDA device for a bare "cuda", else the one named
            devices = (None if args.device == "cuda" else [args.device])
            mesh = RenderMesh.create(devices)
            renderer = ShardedRenderer(lods, mesh, cfg,
                                       tile_cols=args.tile_cols)
        else:
            renderer = Renderer.create(lods, cfg, device=args.device)

    if args.interactive:
        from cpuvox_tpu_torch.frontend.interactive import (InteractiveSession,
                                                           run_terminal)

        run_terminal(InteractiveSession.create(lods, cfg, renderer=renderer))
        return

    def camera_at(i):
        if args.flythrough:
            t = BENCH_CLIP_LENGTH * i / max(args.frames - 1, 1)
            return benchmark_camera(t, dims, (w, h))
        ang = 360.0 * i / args.frames
        rad = 0.9 * max(dims[0], dims[2])
        pos = (dims[0] / 2 + rad * np.sin(np.deg2rad(ang)), dims[1] * 0.8,
               dims[2] / 2 - rad * np.cos(np.deg2rad(ang)))
        return cm.Camera(position=pos, pitch_deg=25.0, yaw_deg=ang,
                         screen=(w, h))

    for i in range(args.frames):
        cam = camera_at(i)
        t0 = time.perf_counter()
        with prof.scope("render"):
            if args.mode == "screen":
                img = renderer.render(cam)
            else:
                _, (td, lr, *_r) = renderer.render(cam, return_raybuffers=True)
                img = td if args.mode == "raybuffer-topdown" else lr
        dt = time.perf_counter() - t0
        path = os.path.join(args.out, f"frame_{i:03d}.ppm")
        with prof.scope("write"):
            write_ppm(path, to_rgb_image(np.asarray(img)[::-1]))
            try:
                from PIL import Image

                Image.open(path).save(path.replace(".ppm", ".png"))
            except ImportError:
                pass
        print(f"frame {i}: {dt * 1e3:.1f} ms -> {path}", file=sys.stderr)

    if args.profile:
        print(prof.report(), file=sys.stderr)
        print(f"trace -> {prof.stop_device_trace()}", file=sys.stderr)


if __name__ == "__main__":
    main()
