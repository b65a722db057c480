"""Kernel 1: the content-independent DDA chunk roll (``csrc/roll.cu``).

Replaces ``cpuvox_tpu/ops/roll_kernel.py::roll_chunk_pallas``.  One CUDA
thread per ray, in blocks of one warp, keeps the DDA state and the LOD
distances (up to ``MAX_LODS``; more are read from memory every step) in
registers for the chunk's C steps and writes the visit list as (C, 13, R)
int32, f32 fields as their bits:

  [0] pos_x   [1] pos_z   [2] ids0   [3] ids1   [4] lod   [5] valid
  [6] pre_pos_x [7] pre_pos_z [8] pre_tmax_x [9] pre_tmax_z
  [10] pre_ids0 [11] pre_ids1 [12] pre_lod

``roll_chunk`` takes the plain version for CPU tensors and launches the kernel
for CUDA tensors.  The kernel updates the DDA state and ``alive`` in place
(saving a copy of the state per chunk) and returns them.

With a live-ray ``index`` (ascending int32 (Rk,)) thread t rolls ray
``index[t]``: the state stays in place at full width R, the visits are
(C, 13, Rk), and a ray outside the index is not touched.  This is the port's
form of the reference's staged compaction (``raymarch.py:1593-1605``): no
array is sorted or cut, the kernel gathers its own rays.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from cpuvox_tpu_torch.render import raymarch as rm

from . import _build

launches = 0  # kernel launches since the last reset (plain calls not counted)

# csrc/roll.cu's kMaxLods: the LOD distances it holds in registers; a frame
# of more launches the kernel's memory form
MAX_LODS = 8

roll_chunk_ref = rm._roll_chunk

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 9 + [_I, ctypes.c_float, _I, _I, _I, _P, _I, _P, _P]


def roll_chunk(dda: rm.DDAState, alive, dirs, lod_distances, far_clip, dims,
               chunk: int, index=None):
    """Roll every ray (or the rays of ``index``) ``chunk`` cells; same
    signature and result as ``raymarch._roll_chunk``: (dda, alive, visits
    (chunk, 13, Rk) int32)."""
    global launches
    if not dda.pos.is_cuda:
        return roll_chunk_ref(dda, alive, dirs, lod_distances, far_clip, dims,
                              chunk, index=index)
    R = dda.pos.shape[0]
    Rk = R if index is None else index.shape[0]
    g = _build.require
    ptrs = [
        g(dda.pos, torch.int32, (R, 2), "pos"),
        g(dda.tmax, torch.float32, (R, 2), "tmax"),
        g(dda.tdelta, torch.float32, (R, 2), "tdelta"),
        g(dda.stp, torch.int32, (R, 2), "stp"),
        g(dda.ids, torch.float32, (R, 2), "ids"),
        g(dda.lod, torch.int32, (R,), "lod"),
        g(alive, torch.bool, (R,), "alive"),
        g(dirs, torch.float32, (R, 2), "dirs"),
        g(lod_distances, torch.float32, None, "lod_distances"),
    ]
    nld = lod_distances.numel()
    if nld < 1:
        raise ValueError("the roll needs at least one LOD distance")
    p_index = (None if index is None
               else g(index, torch.int32, (Rk,), "index"))
    visits = torch.empty((chunk, rm.NVF, Rk), dtype=torch.int32,
                         device=dda.pos.device)
    fn = _build.function("cpuvox_roll_chunk", _ARGTYPES)
    code = fn(*ptrs, nld, float(np.float32(far_clip)),
              int(dims[0]), int(dims[2]), chunk, p_index, Rk,
              visits.data_ptr(), _build.stream_ptr(visits))
    _build.check(code, "cpuvox_roll_chunk")
    if _build.counted():
        launches += 1
    return dda, alive, visits
