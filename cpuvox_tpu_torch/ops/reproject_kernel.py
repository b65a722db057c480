"""Kernel 3: the phase-2 raybuffer sample (``csrc/sample.cu``).

Replaces ``cpuvox_tpu/ops/reproject_kernel.py::sample_raybuffer``: one CUDA
thread per output element, ``out[i, j] = rb[clamp(ri[i, j]), j]`` where
``mask[i, j]`` is set, else -1.  Any (NI, NJ) with NJ <= PL is accepted: the
(8, 128) padding was a TPU tiling rule.  ``reproject_sample`` runs the two
passes of ``reproject_kernel.py:104-124``: left/right segments sample
texel = x, top/down segments texel = y through the transposed maps.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0  # kernel launches since the last reset (plain calls not counted)

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _I, _I, _P, _P, _I, _I, _P, _P]


def sample_raybuffer_ref(rb, ri, mask):
    """The plain torch version: (R, PL) x (NI, NJ) x (NI, NJ) -> (NI, NJ)."""
    R = rb.shape[0]
    cols = torch.arange(ri.shape[1], device=rb.device)
    vals = rb[ri.clamp(0, R - 1).long(), cols[None, :]]
    return torch.where(mask != 0, vals, -1)


def sample_raybuffer(rb, ri, mask):
    """``out[i, j] = rb[ri[i, j], j]`` where ``mask`` is set, else -1."""
    global launches
    if not rb.is_cuda:
        return sample_raybuffer_ref(rb, ri, mask)
    R, PL = rb.shape
    NI, NJ = ri.shape
    if NJ > PL:
        raise ValueError(f"sample width {NJ} exceeds the raybuffer's {PL}")
    g = _build.require
    p_rb = g(rb, torch.int32, (R, PL), "rb")
    p_ri = g(ri, torch.int32, (NI, NJ), "ri")
    p_m = g(mask, torch.int32, (NI, NJ), "mask")
    out = torch.empty((NI, NJ), dtype=torch.int32, device=rb.device)
    fn = _build.function("cpuvox_sample_raybuffer", _ARGTYPES)
    code = fn(p_rb, R, PL, p_ri, p_m, NI, NJ, out.data_ptr(),
              _build.stream_ptr(out))
    _build.check(code, "cpuvox_sample_raybuffer")
    launches += 1
    return out


def _two_passes(sample, raybuf_idx, seg_id, ray_idx):
    lr = sample(raybuf_idx, ray_idx, (seg_id >= 2).to(torch.int32))
    td = sample(raybuf_idx, ray_idx.t().contiguous(),
                (seg_id < 2).to(torch.int32).t().contiguous())
    return torch.where(seg_id >= 2, lr, td.t())


def reproject_sample(raybuf_idx, seg_id, ray_idx):
    """Both reprojection passes through the kernel wrapper: the (H, W) int32
    sampled color-index screen (``reproject_kernel.py:104``; no padding, so
    no crop to width and height)."""
    return _two_passes(sample_raybuffer, raybuf_idx, seg_id, ray_idx)


def reproject_sample_ref(raybuf_idx, seg_id, ray_idx):
    """``reproject_sample`` through the plain sample."""
    return _two_passes(sample_raybuffer_ref, raybuf_idx, seg_id, ray_idx)
