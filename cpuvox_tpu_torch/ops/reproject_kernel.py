"""Kernel 3: phase 2, the screen from the raybuffer (``csrc/reproject.cu``).

Replaces ``cpuvox_tpu/ops/reproject_kernel.py::sample_raybuffer`` and the
XLA steps around it in the reference's frame.  ``reproject_screen`` is the
frame's (``Renderer.phase2``): one CUDA launch that computes each output
pixel's render pixel (the nearest upscale), its segment and raybuffer row
(``render/reproject.py::segment_ray_index``), samples the raybuffer and, in
index mode, resolves the color (``raymarch.resolve_colors``).  The segment
tables ride in the kernel's parameters: nothing is copied to the card.  Its
plain version, ``reproject_screen_ref``, runs those steps in eager torch.

``reproject_screens`` is phase 2 for a batch of cameras whose rays sit in
consecutive blocks of one raybuffer (``parallel/batch.py``): one launch for
all of them, the camera as the grid's third axis, the segment tables of
every camera copied to the card once as a (B, 36) int32 array
(``SegmentTables`` words).  Its plain version, ``reproject_screens_ref``,
is ``reproject_screen_ref`` a camera at a time.

``sample_raybuffer`` is the previous design's kernel, off every path and
timed against the fused kernel by ``chip_smoke.py`` (and, with the torch
steps around it, ``reproject_screen_two_pass``): one CUDA thread per element,
``out[i, j] = rb[clamp(ri[i, j]), j]`` where ``mask[i, j]`` is set, else
-1, on maps that torch computes (``reproject_sample`` runs its two passes,
``reproject_kernel.py:104-124``: left/right segments sample texel = x,
top/down segments texel = y through the transposed maps).  Any (NI, NJ)
with NJ <= PL is accepted: the (8, 128) padding was a TPU tiling rule.

Each wrapper takes its plain version for CPU tensors and launches its
kernel for CUDA tensors.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from cpuvox_tpu_torch.render import raymarch as rm
from cpuvox_tpu_torch.render import reproject

from . import _build

# kernel launches since the last reset (plain calls not counted): the fused
# phase-2 kernel's, its batched variant's, and the previous design's
launches = 0
screens_launches = 0
sample_launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_SAMPLE_ARGTYPES = [_P, _I, _I, _P, _P, _I, _I, _P, _P]


class SegmentTables(ctypes.Structure):
    """``csrc/reproject.cu``'s ``SegmentTables``, passed by value."""

    _fields_ = ([(k, ctypes.c_float * 4)
                 for k in ("ax", "ay", "bx", "by", "cx", "cy")]
                + [(k, ctypes.c_int * 4)
                   for k in ("ray_count", "ray_base", "active")])


_SCREEN_ARGTYPES = [_P, _I, _I, SegmentTables, _I, _I, _I, _I, _I, _P, _I,
                    _I, _P, _P]
_SCREENS_ARGTYPES = [_P, _I, _I, _I, _P, _I, _I, _I, _I, _P, _I, _I, _P, _P]


def segment_tables(tables) -> SegmentTables:
    """``reproject_tables``' arrays as the kernel's struct: the f32 words as
    they are, the ints and the active flags as int32."""
    a, b, c = (np.asarray(tables[k], np.float32)
               for k in ("tri_a", "tri_b", "tri_c"))
    floats = {"ax": a[:, 0], "ay": a[:, 1], "bx": b[:, 0], "by": b[:, 1],
              "cx": c[:, 0], "cy": c[:, 1]}
    ints = {k: np.asarray(tables[k]).astype(np.int32)
            for k in ("ray_count", "ray_base", "active")}
    return SegmentTables(
        **{k: (ctypes.c_float * 4)(*v.tolist()) for k, v in floats.items()},
        **{k: (ctypes.c_int * 4)(*v.tolist()) for k, v in ints.items()})


def segment_tables_words(tables_list) -> np.ndarray:
    """The cameras' ``SegmentTables`` as a (B, 36) int32 array, each row the
    struct's words in order (the f32 tables as their bits)."""
    tri = np.stack([np.stack([t[k] for k in ("tri_a", "tri_b", "tri_c")])
                    for t in tables_list]).astype(np.float32)  # (B, 3, 4, 2)
    floats = tri.transpose(0, 1, 3, 2).reshape(len(tables_list), 24)
    ints = np.stack([np.concatenate([np.asarray(t[k]).astype(np.int32)
                                     for k in ("ray_count", "ray_base",
                                               "active")])
                     for t in tables_list])
    return np.concatenate([floats.view(np.int32), ints], axis=1)


def _torch_phase2(sample_kernel: bool, raybuf, tables, rw, rh, width,
                  height, colors, skybox):
    screen = reproject.reproject(raybuf, tables, rw, rh, skybox=skybox,
                                 kernels=sample_kernel)
    if colors is not None:
        screen = rm.resolve_colors(screen, colors)
    if (width, height) != (rw, rh):
        dev = screen.device
        ys = (torch.arange(height, dtype=torch.int64, device=dev) * rh) // height
        xs = (torch.arange(width, dtype=torch.int64, device=dev) * rw) // width
        screen = screen[ys][:, xs]
    return screen


def reproject_screen_ref(raybuf, tables, rw: int, rh: int, width: int,
                         height: int, colors=None, skybox: int = 0):
    """Phase 2 in plain torch: the (rh, rw) reprojection of the (R, P)
    raybuffer (``render/reproject.py::reproject`` with the plain sample; all
    ``skybox`` when no segment is active), in index mode (``colors`` given)
    the color resolve, and the nearest upscale to (height, width)
    (``cpuvox_tpu/render/frame.py:117-123``).  Returns (height, width)
    int32 ARGB bits."""
    return _torch_phase2(False, raybuf, tables, rw, rh, width, height,
                         colors, skybox)


def reproject_screen_two_pass(raybuf, tables, rw: int, rh: int, width: int,
                              height: int, colors=None, skybox: int = 0):
    """The previous design of phase 2, off every path: ``reproject_screen_ref``
    with the two-pass sample kernel in place of the plain sample."""
    return _torch_phase2(True, raybuf, tables, rw, rh, width, height, colors,
                         skybox)


def _check_sizes(P: int, rw: int, rh: int, width: int, height: int):
    if max(rw, rh) > P:
        raise ValueError(f"render size {rw}x{rh} exceeds the raybuffer's "
                         f"{P} texels")
    if max(width * rw, height * rh) >= 2**31:
        raise ValueError(f"the upscale {rw}x{rh} -> {width}x{height} "
                         "overflows the kernel's int32 pixel map")


def _color_args(colors):
    if colors is None:
        return None, 0
    return _build.require(colors, torch.int32, None, "colors"), colors.shape[0]


def reproject_screen(raybuf, tables, rw: int, rh: int, width: int,
                     height: int, colors=None, skybox: int = 0, out=None):
    """``reproject_screen_ref`` in one launch of the fused kernel; into
    ``out`` ((height, width) int32) where given."""
    global launches
    if not raybuf.is_cuda:
        return reproject_screen_ref(raybuf, tables, rw, rh, width, height,
                                    colors, skybox)
    R, P = raybuf.shape
    _check_sizes(P, rw, rh, width, height)
    g = _build.require
    p_rb = g(raybuf, torch.int32, (R, P), "raybuf")
    p_colors, n_colors = _color_args(colors)
    if out is None:
        out = torch.empty((height, width), dtype=torch.int32,
                          device=raybuf.device)
    g(out, torch.int32, (height, width), "out")
    fn = _build.function("cpuvox_reproject_screen", _SCREEN_ARGTYPES)
    code = fn(p_rb, R, P, segment_tables(tables),
              int(np.asarray(tables["active"]).any()), rw, rh, width, height,
              p_colors, n_colors, int(skybox), out.data_ptr(),
              _build.stream_ptr(out))
    _build.check(code, "cpuvox_reproject_screen")
    launches += 1
    return out


def reproject_screens_ref(raybuf, tables_list, R1: int, rw: int, rh: int,
                          width: int, height: int, colors=None,
                          skybox: int = 0):
    """Phase 2 of B cameras whose rays are the consecutive R1-row blocks of
    ``raybuf``: ``reproject_screen_ref`` a camera at a time, (B, height,
    width) int32 ARGB bits."""
    return torch.stack([
        reproject_screen_ref(raybuf[b * R1:(b + 1) * R1], t, rw, rh, width,
                             height, colors, skybox)
        for b, t in enumerate(tables_list)])


def reproject_screens(raybuf, tables_list, R1: int, rw: int, rh: int,
                      width: int, height: int, colors=None, skybox: int = 0):
    """``reproject_screens_ref`` in one launch of the batched kernel."""
    global screens_launches
    if not raybuf.is_cuda:
        return reproject_screens_ref(raybuf, tables_list, R1, rw, rh, width,
                                     height, colors, skybox)
    B = len(tables_list)
    P = raybuf.shape[1]
    _check_sizes(P, rw, rh, width, height)
    g = _build.require
    p_rb = g(raybuf, torch.int32, (B * R1, P), "raybuf")
    p_colors, n_colors = _color_args(colors)
    # one copy of every camera's tables, from pinned memory so that it does
    # not wait for the card
    words = torch.from_numpy(segment_tables_words(tables_list)).pin_memory(
    ).to(raybuf.device, non_blocking=True)
    out = torch.empty((B, height, width), dtype=torch.int32,
                      device=raybuf.device)
    fn = _build.function("cpuvox_reproject_screens", _SCREENS_ARGTYPES)
    code = fn(p_rb, R1, P, B, words.data_ptr(), rw, rh, width, height,
              p_colors, n_colors, int(skybox), out.data_ptr(),
              _build.stream_ptr(out))
    _build.check(code, "cpuvox_reproject_screens")
    screens_launches += 1
    return out


def reproject_screens_per_camera(raybuf, tables_list, R1: int, rw: int,
                                 rh: int, width: int, height: int,
                                 colors=None, skybox: int = 0):
    """``reproject_screens`` as B launches of the fused single-camera kernel
    (tables by value), each into its camera's slice of the output."""
    if not raybuf.is_cuda:
        return reproject_screens_ref(raybuf, tables_list, R1, rw, rh, width,
                                     height, colors, skybox)
    out = torch.empty((len(tables_list), height, width), dtype=torch.int32,
                      device=raybuf.device)
    for b, t in enumerate(tables_list):
        reproject_screen(raybuf[b * R1:(b + 1) * R1], t, rw, rh, width,
                         height, colors, skybox, out=out[b])
    return out


def sample_raybuffer_ref(rb, ri, mask):
    """The plain torch version: (R, PL) x (NI, NJ) x (NI, NJ) -> (NI, NJ)."""
    R = rb.shape[0]
    cols = torch.arange(ri.shape[1], device=rb.device)
    vals = rb[ri.clamp(0, R - 1).long(), cols[None, :]]
    return torch.where(mask != 0, vals, -1)


def sample_raybuffer(rb, ri, mask):
    """``out[i, j] = rb[ri[i, j], j]`` where ``mask`` is set, else -1."""
    global sample_launches
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
    fn = _build.function("cpuvox_sample_raybuffer", _SAMPLE_ARGTYPES)
    code = fn(p_rb, R, PL, p_ri, p_m, NI, NJ, out.data_ptr(),
              _build.stream_ptr(out))
    _build.check(code, "cpuvox_sample_raybuffer")
    sample_launches += 1
    return out


def _two_passes(sample, raybuf_idx, seg_id, ray_idx):
    lr = sample(raybuf_idx, ray_idx, (seg_id >= 2).to(torch.int32))
    td = sample(raybuf_idx, ray_idx.t().contiguous(),
                (seg_id < 2).to(torch.int32).t().contiguous())
    return torch.where(seg_id >= 2, lr, td.t())


def reproject_sample(raybuf_idx, seg_id, ray_idx):
    """Both reprojection passes through the previous design's kernel: the
    (H, W) int32 sampled color-index screen (``reproject_kernel.py:104``; no
    padding, so no crop to width and height)."""
    return _two_passes(sample_raybuffer, raybuf_idx, seg_id, ray_idx)


def reproject_sample_ref(raybuf_idx, seg_id, ray_idx):
    """``reproject_sample`` through the plain sample."""
    return _two_passes(sample_raybuffer_ref, raybuf_idx, seg_id, ray_idx)
