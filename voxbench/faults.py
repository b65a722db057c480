"""Faults planted in the timed path underneath a run, each of which has to
make ``correct`` come out false (one card: no exchange between cards to
leave out).

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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--faults", nargs="+", default=sorted(FAULTS))
    args = ap.parse_args(argv)
    from voxbench import harness, spec

    cell = spec.cell(spec.load(ROOT), args.workload)
    for name in args.faults:
        for seed in args.seeds:
            res = harness.run_cell(cell, seed, args.seconds, False,
                                   time.perf_counter(), fault=FAULTS[name])
            print(json.dumps({"workload": args.workload, "fault": name,
                              "seed": seed, "correct": res["correct"],
                              "failed": res["failed"],
                              "check": res["check"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
