"""Standalone .obj -> .world converter on a torch device.

    python -m cpuvox_tpu_torch.assets.convert_cli mill.obj out.world \
        --max-dim 2048 [--host] [--repeat] [--device cpu]

The counterpart of ``cpuvox_tpu/assets/convert_cli.py``, in process: torch
has int64 and f64 on every device, so the conversion needs no process mode
of its own.  This is the reference's multi-core conversion (one Task per
core, WordBuilder.cs:41-96) as device offload: the voxelizer's candidates
and the LOD chain run on the card (``assets/pipeline.py``).
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("obj_path")
    ap.add_argument("save_path")
    ap.add_argument("--max-dim", type=int, default=1024)
    ap.add_argument("--lod-levels", type=int, default=6)
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--host", action="store_true",
                    help="use the numpy voxelizer and chain instead of torch")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the conversion (default cuda)")
    ap.add_argument("--repeat", action="store_true",
                    help="convert twice and report both wall times: the "
                         "first pays the device's start-up, the second is "
                         "the steady-state pipeline time")
    a = ap.parse_args(argv)

    from cpuvox_tpu_torch.assets.pipeline import convert_obj_to_world

    device = None if a.host else a.device
    for label in ("", " (steady-state)")[:2 if a.repeat else 1]:
        t0 = time.perf_counter()
        convert_obj_to_world(a.obj_path, max_dimension=a.max_dim,
                             lod_levels=a.lod_levels, save_path=a.save_path,
                             verbose=a.verbose, device=device)
        print(f"convert wall{label}: {time.perf_counter() - t0:.1f}s",
              file=sys.stderr)


if __name__ == "__main__":
    main()
