"""Faults planted in the timed path underneath a run, each of which has to
make ``correct`` come out false (one card: no exchange between cards to
leave out).  A camera-batch cell takes its own three (``BATCH_FAULTS``),
of the same names.

    python3 voxbench/faults.py --workload <name> --seeds <n> [<n> ...] --seconds <s>

runs the cell once a fault and a seed, at the cell's own size, with the
harness's look for a card skipped, and prints one JSON line a run with the
numbers that decided ``correct``.  The CPU tests plant the same faults at a
test's size (``tests/test_voxbench_faults.py``).
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def stale(r):
    """A frame that returns the state it had: every call answers with one
    frame rendered before the window."""
    from voxbench import path, program

    first = r.render_device(program.camera(
        path.benchmark_pose(0.1, r.device_world.dims),
        {"width": r.config.width, "height": r.config.height}))
    r.render_device = lambda cam: first


def half_rays(r):
    """Half of each frame's rays left out: their rows keep the skybox."""
    cls = type(r)

    def march(f, *a, **k):
        rb = cls.march(r, f, *a, **k).clone()
        rb[rb.shape[0] // 2:] = 0
        return rb

    r.march = march


def pixel(r):
    """An answer altered where it is produced: one pixel of phase 2's screen."""
    cls = type(r)

    def phase2(f, rb):
        out = cls.phase2(r, f, rb).clone()
        h, w = out.shape
        out[h // 2, w // 2] ^= 1
        return out

    r.phase2 = phase2


FAULTS = {"stale": stale, "half_rays": half_rays, "pixel": pixel}


def _marches(r, make):
    """Puts ``make(f)`` in the place of each march a camera batch's group can
    take (``march_batch_graph`` on the graph route, ``march_rays`` off it)."""
    for name in ("march_batch_graph", "march_rays"):
        setattr(r, name, make(getattr(r, name)))


def stale_step(r):
    """A step that returns the state it had: every group's march answers
    with the raybuffer of one camera rendered before the window, repeated
    over the group's cameras."""
    from voxbench import path, program
    from voxbench.trace import KeepBatch

    cam = program.camera(
        path.benchmark_pose(0.1, r.device_world.dims),
        {"width": r.config.width, "height": r.config.height})
    with KeepBatch(r) as k:
        program.camera_batch(r, [cam])
    first = k.blocks(1)[0].clone()

    def make(_inner):
        def march(static, *a, **kw):
            return first.repeat(static.dirs.shape[0] // first.shape[0], 1)
        return march

    _marches(r, make)


def half_rays_step(r):
    """Half of each step's rays left out: every other raybuffer row of each
    group keeps the skybox, so every camera loses half its rays."""
    def make(inner):
        def march(*a, **kw):
            rb = inner(*a, **kw).clone()
            rb[1::2] = 0
            return rb
        return march

    _marches(r, make)


def pixel_step(r):
    """An answer altered where it is produced: one pixel of the first screen
    of each direction group's phase 2 (one or two screens a step).  Returns
    its undo."""
    from voxbench import program

    def make(inner):
        def phase2_group(*a, **kw):
            out = inner(*a, **kw).clone()
            _b, h, w = out.shape
            out[0, h // 2, w // 2] ^= 1
            return out
        return phase2_group

    return program.hook_batch("phase2_group", make)


BATCH_FAULTS = {"stale": stale_step, "half_rays": half_rays_step,
                "pixel": pixel_step}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--faults", nargs="+", default=sorted(FAULTS))
    args = ap.parse_args(argv)
    from voxbench import harness, spec

    cell = spec.cell(spec.load(ROOT), args.workload)
    faults = (BATCH_FAULTS if cell.traffic["entry"] == "render_camera_batch"
              else FAULTS)
    for name in args.faults:
        for seed in args.seeds:
            res = harness.run_cell(cell, seed, args.seconds, False,
                                   time.perf_counter(), fault=faults[name])
            print(json.dumps({"workload": args.workload, "fault": name,
                              "seed": seed, "correct": res["correct"],
                              "failed": res["failed"],
                              "check": res["check"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
