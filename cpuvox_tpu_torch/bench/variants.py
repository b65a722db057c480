"""Kernel libraries built with changed design constants, for timing on a
CUDA card (``bench/raster_variants.py``, ``bench/roll_variants.py``,
``chip_smoke.py``).

A variant is the kernel sources of ``csrc/`` copied with some
``constexpr int`` constants of one source set to other values, built by
``nvcc`` with the library's own flags into a directory of its own, all
variants at once.  ``use`` points the ops wrappers at one of them.
"""
from __future__ import annotations

import ctypes
import glob
import os
import re
import shutil
import subprocess


def build_variants(out_dir: str, variants, target: str,
                   sources: list[str] | None = None) -> dict:
    """Build each (label, {constant: value}) of ``variants`` into
    ``out_dir``, the constants set in the source ``target`` (a file name in
    ``csrc/``), from ``sources`` (file names; all ``*.cu`` if None), all
    in parallel; returns label -> library path."""
    from cpuvox_tpu_torch.ops import _build

    shutil.rmtree(out_dir, ignore_errors=True)
    procs = {}
    for i, (label, consts) in enumerate(variants):
        d = os.path.join(out_dir, str(i))
        os.makedirs(d)
        for src in glob.glob(os.path.join(_build.CSRC, "*.cu*")):
            with open(src) as f:
                txt = f.read()
            if os.path.basename(src) == target:
                for name, value in consts.items():
                    txt, n = re.subn(rf"constexpr int {name} = -?\d+;",
                                     f"constexpr int {name} = {value};", txt)
                    if n != 1:
                        raise RuntimeError(f"{name} not found in {target}")
            with open(os.path.join(d, os.path.basename(src)), "w") as f:
                f.write(txt)
        names = sources or [os.path.basename(p) for p in
                            glob.glob(os.path.join(d, "*.cu"))]
        lib = os.path.join(d, "lib.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib,
               *sorted(os.path.join(d, n) for n in names)]
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


def registers(lib: str, kernel: str) -> str:
    """``kernel``'s registers and stack in ``lib``, as cuobjdump reads them."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-res-usage", lib], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    m = re.search(rf"{kernel}.*?\n\s*REG:(\d+) STACK:(\d+)", out)
    return f"{m.group(1)} registers, stack {m.group(2)} B" if m else "?"


def use(lib: str) -> None:
    """Make the ops wrappers call into ``lib``."""
    from cpuvox_tpu_torch.ops import _build

    _build._lib = ctypes.CDLL(lib)
    _build._lib.cpuvox_error_string.argtypes = [ctypes.c_int]
    _build._lib.cpuvox_error_string.restype = ctypes.c_char_p
    _build._functions.clear()
