"""The plain reference's raybuffer rows of many rays, worked out in worker
processes once the window has closed.

The scalar oracle takes some tens of milliseconds a ray at 1080p on a 2048
world, so the check's hundreds of rays a frame, and the control's every
ray, are spread over ``workers`` processes.  Each worker is started fresh
(``spawn``: nothing of the parent's CUDA state or threads) and loads the
world from the cache file the run read, so nothing of the program reaches
it.  A pool is always shut down and waited for before ``rows`` returns.
A worker imports the script that started the process, as ``spawn`` does,
so a script that calls ``rows`` keeps its entry under ``if __name__ ==
"__main__"`` (``run.py``, ``control.py`` and ``faults.py`` do).
"""
from __future__ import annotations

import concurrent.futures
import multiprocessing
import os

import numpy as np

from . import frame as rf

F32 = np.float32
# a ray the low precision cannot finish raises one of these: it gives no row
LOW_PRECISION_FAULTS = (OverflowError, ValueError, IndexError, ZeroDivisionError)

_LODS = None


def workers() -> int:
    """One worker a core the process may use, less one, at most eight."""
    try:
        n = len(os.sched_getaffinity(0))
    except AttributeError:
        n = os.cpu_count() or 1
    return max(1, min(8, n - 1))


def _init(world_path: str):
    global _LODS
    from voxbench.worldgen import cache

    _LODS = cache.load(world_path)


def _rows(job):
    g, rays, dtype = job
    out = []
    for si, i in rays:
        if dtype == F32:
            out.append(rf.ray_row(_LODS, g, si, i, dtype))
            continue
        try:
            out.append(rf.ray_row(_LODS, g, si, i, dtype))
        except LOW_PRECISION_FAULTS:
            out.append(None)
    return out


def rows(world_path: str, lods, jobs, dtype=F32, n_workers: int | None = None,
         chunk: int = 8) -> list[list]:
    """Each job's rows: ``jobs`` is a list of (geometry, [(segment, ray),
    ...]); the result, a list a job, holds each ray's row (uint32 ARGB), or
    None where a precision below float32 could not finish the ray.  With
    one worker, or few rays, the rows are worked out in this process from
    ``lods``; else the workers load ``world_path``."""
    n_workers = workers() if n_workers is None else n_workers
    n_rays = sum(len(r) for _, r in jobs)
    if n_workers <= 1 or n_rays <= 2 * chunk:
        global _LODS
        held, _LODS = _LODS, lods
        try:
            return [_rows((g, r, dtype)) for g, r in jobs]
        finally:
            _LODS = held
    parts, owner = [], []
    for j, (g, r) in enumerate(jobs):
        for k in range(0, len(r), chunk):
            parts.append((g, r[k:k + chunk], dtype))
            owner.append(j)
    out = [[] for _ in jobs]
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=n_workers, mp_context=ctx, initializer=_init,
            initargs=(world_path,)) as pool:
        for j, got in zip(owner, pool.map(_rows, parts)):
            out[j].extend(got)
    return out
