"""Build the CUDA kernels on first use and bind them with ctypes.

All ``cpuvox_tpu_torch/csrc/*.cu`` sources compile into one shared library
with a plain C interface (no PyTorch headers: seconds, not minutes), one
``nvcc`` a source, all started together, then one link.  The library lands
in ``csrc/build/``, named by a hash of the sources, so an edited source is
rebuilt and an unchanged one is reused.
Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` raises on a non-zero code.  The march's
kernels take a timer buffer (``csrc/timer.cuh``): the one ``timing`` hands
them while a Renderer's frame graph is captured, else none.

Nothing here runs at import: the CPU-only test machine has no ``nvcc``.
"""
from __future__ import annotations

import contextlib
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
COMPILE_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-fmad=false", "-Xcompiler", "-fPIC"]
NVCC_FLAGS = [*COMPILE_FLAGS, "-shared"]  # sources straight to a library

_lock = threading.Lock()
_lib = None
_functions: dict[str, ctypes._CFuncPtr] = {}
_timer = None  # the timer buffer of ``timing``, or None


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(glob.glob(os.path.join(CSRC, "*.cu*"))):
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libcpuvox_kernels_{h.hexdigest()[:12]}.so")


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands side by side; raise if any fails."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    failed = []
    for cmd, p in procs:
        out = p.communicate()[0]
        if p.returncode:
            failed.append(f"nvcc failed ({p.returncode}):\n{' '.join(cmd)}\n"
                          f"{out}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> str:
    """Compile the kernels if this source set has not been built yet;
    returns the library path."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        objs = [os.path.join(tmp, os.path.basename(src) + ".o")
                for src in sources()]
        _run_all([[_nvcc(), *COMPILE_FLAGS, "-c", "-o", obj, src]
                  for obj, src in zip(objs, sources())])
        lib = os.path.join(tmp, "lib.so")
        _run_all([[_nvcc(), *NVCC_FLAGS, "-o", lib, *objs]])
        os.replace(lib, out)  # atomic: a concurrent build sees all or nothing
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(build())
            _lib.cpuvox_error_string.argtypes = [ctypes.c_int]
            _lib.cpuvox_error_string.restype = ctypes.c_char_p
        return _lib


def function(name: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry point ``name`` with its argument types declared."""
    fn = _functions.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _functions[name] = fn
    return fn


def check(code: int, name: str) -> None:
    if code != 0:
        msg = library().cpuvox_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code}: {msg}")


def stream_ptr(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def counted() -> bool:
    """Whether a launch just made counts: not while the current stream is
    being captured into a CUDA graph, where the call records the launch
    (the graph's launches are counted on the device, ``ops/march_loop``)."""
    import torch

    return not torch.cuda.is_current_stream_capturing()


@contextlib.contextmanager
def timing(timer):
    """Hand ``timer`` (an int64 tensor, ``csrc/timer.cuh``; None: none) to
    the roll, rasterizer and control kernels launched inside: the march
    graph's bodies as they are captured."""
    global _timer
    prev, _timer = _timer, timer
    try:
        yield
    finally:
        _timer = prev


def timer_ptr():
    """The data pointer of ``timing``'s buffer, or None."""
    return None if _timer is None else _timer.data_ptr()


def require(t, dtype, shape=None, name="tensor"):
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (and
    ``shape``); returns its data pointer."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    return t.data_ptr()
