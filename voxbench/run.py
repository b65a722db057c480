"""The benchmark of ``cpuvox_tpu_torch`` on one CUDA card: one run of one cell.

    python3 voxbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the program.  ``--trace 0`` prints
the cell's end-to-end metrics, ``--trace 1`` its per-layer metrics, each on
the last line of standard output as one JSON object; the numbers that decide
``correct`` are the last lines of standard error and the ``check`` key, last
in that object.  Exits 2, with no result, without the CUDA cards the cell
asks for, and 3 if JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".voxbench_cache")
# every build and kernel cache at a fixed path inside the checkout
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "nv")
os.environ["USE_FLAX"] = "0"
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from voxbench import spec

    cell = spec.cell(spec.load(ROOT), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"voxbench: {args.workload} needs {cell.chips} CUDA card(s), "
              f"found {n}", file=sys.stderr)
        return 2
    from voxbench import harness

    res = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           T_START)
    found = harness.banned_modules()
    if found:
        print(f"voxbench: the run loaded {found}", file=sys.stderr)
        return 3
    for line in harness.check_lines(res["check"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
