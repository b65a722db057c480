"""ctypes binding for the native asset-IO runtime (cpuvox_tpu_torch/csrc/voxio.cpp).

Builds libvoxio.so on first use (g++, cached under cpuvox_tpu_torch/csrc/build/)
and exposes the fast .obj parser; cpuvox_tpu_torch.assets.obj falls back to the
pure-python parser when the toolchain is unavailable.

A copy of ``cpuvox_tpu/assets/native.py`` over the port's copy of the C++
source.  One difference: the library is compiled to a temporary name and
renamed into place, so that two processes building it at once (test workers)
never load a half-written file.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

import numpy as np

_lock = threading.Lock()
_lib = None
_build_failed = False

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "csrc")


def _load():
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        so = os.path.join(_CSRC, "build", "libvoxio.so")
        src = os.path.join(_CSRC, "voxio.cpp")
        try:
            if (not os.path.exists(so)
                    or os.path.getmtime(so) < os.path.getmtime(src)):
                os.makedirs(os.path.dirname(so), exist_ok=True)
                fd, tmp = tempfile.mkstemp(suffix=".so",
                                           dir=os.path.dirname(so))
                os.close(fd)
                try:
                    subprocess.run(
                        ["g++", "-O3", "-march=native", "-std=c++17",
                         "-shared", "-fPIC", src, "-o", tmp],
                        check=True, capture_output=True, timeout=120)
                    os.replace(tmp, so)
                finally:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
            lib = ctypes.CDLL(so)
        except (OSError, subprocess.SubprocessError):
            _build_failed = True
            return None
        lib.voxio_obj_parse.restype = ctypes.c_void_p
        lib.voxio_obj_parse.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.voxio_obj_vertex_count.restype = ctypes.c_long
        lib.voxio_obj_vertex_count.argtypes = [ctypes.c_void_p]
        for name in ("voxio_obj_error", "voxio_obj_mtllib", "voxio_obj_materials"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_char_p
            fn.argtypes = [ctypes.c_void_p]
        lib.voxio_obj_fill.restype = None
        lib.voxio_obj_fill.argtypes = [ctypes.c_void_p] + [
            np.ctypeslib.ndpointer(dt, flags="C_CONTIGUOUS")
            for dt in (np.float32, np.uint8, np.float32, np.int32)]
        lib.voxio_obj_close.restype = None
        lib.voxio_obj_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def parse_obj(path: str, swap_yz: bool = False):
    """Parse an .obj natively.

    Returns (positions (n,3) f32, colors (n,4) u8, uvs (n,2) f32, mats (n,) i32,
    mtllib str, material_names list[str]) or None when the native lib is
    unavailable.  Raises on file errors.
    """
    lib = _load()
    if lib is None:
        return None
    h = lib.voxio_obj_parse(path.encode(), 1 if swap_yz else 0)
    try:
        err = lib.voxio_obj_error(h).decode()
        if err:
            raise OSError(f"{path}: {err}")
        n = lib.voxio_obj_vertex_count(h)
        positions = np.empty((n, 3), np.float32)
        colors = np.empty((n, 4), np.uint8)
        uvs = np.empty((n, 2), np.float32)
        mats = np.empty((n,), np.int32)
        if n:
            lib.voxio_obj_fill(h, positions, colors, uvs, mats)
        mtllib = lib.voxio_obj_mtllib(h).decode()
        names = lib.voxio_obj_materials(h).decode()
        return positions, colors, uvs, mats, mtllib, \
            (names.split("\n") if names else [])
    finally:
        lib.voxio_obj_close(h)
