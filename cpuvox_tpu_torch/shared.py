"""The host-side numpy modules the port shares with the JAX package.

Every module named here is plain numpy and imports no jax, so the port runs
on a machine without jax.  Port code and ``chip_smoke.py`` import them from
this one place, which keeps the shared boundary visible.

``cpuvox_tpu/bench/__init__.py`` imports the JAX harness, so the benchmark
path (``cpuvox_tpu/bench/path.py``, numpy only) is loaded from its file
without running that package ``__init__``.
"""
from __future__ import annotations

import importlib.util
import os

from cpuvox_tpu import config  # noqa: F401
from cpuvox_tpu.config import RenderConfig  # noqa: F401
from cpuvox_tpu.models import procedural  # noqa: F401
from cpuvox_tpu.render import camera, device, oracle, segments  # noqa: F401
from cpuvox_tpu.utils import colors  # noqa: F401
from cpuvox_tpu.world import rle, save  # noqa: F401


def _load_bench_path():
    import cpuvox_tpu

    path = os.path.join(os.path.dirname(cpuvox_tpu.__file__), "bench", "path.py")
    spec = importlib.util.spec_from_file_location(
        "cpuvox_tpu_torch._bench_path", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


bench_path = _load_bench_path()
