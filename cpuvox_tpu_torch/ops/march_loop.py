"""Kernel 4: the march loop's control (``csrc/march_loop.cu``), and the
CUDA graph of a frame's march that it drives.

Replaces the condition of the JAX march's ``lax.while_loop``
(``cpuvox_tpu/render/raymarch.py:928-930``, and ``:1542``/``:1583`` for the
gated march): one block folds ``alive &= rs_alive``, reduces "any ray
alive", counts the iteration and, inside a graph, sets the WHILE node's
condition ``any && i < max_chunks``.  ``loop_control`` launches it eagerly
(for the comparisons with the plain version, ``loop_control_ref``, the
torch expression of ``raymarch.loop_control``); ``MarchGraphExec`` builds
the parent graph around two graphs torch captured
(``render/march_graph.py``) and launches it.

Launch counts: ``launches`` counts the wrapper's eager launches of the
control kernel.  Inside a march graph the kernels run without their
wrappers, so the graphs count on the device: ``graph_stats`` holds the
graph launches and the loop iterations they ran (read from the device only
when asked), and ``kernel_launches`` adds them to the wrappers' counts (an
iteration launches the roll, the rasterizer and the control kernel once
each; a graph launch one more control kernel, the check before the first
iteration).  A wrapper called while its stream is being captured does not
count: that call records a launch, it makes none.
"""
from __future__ import annotations

import ctypes

import torch

from cpuvox_tpu_torch.render import raymarch as rm

from . import _build

launches = 0  # eager launches of the control kernel (plain calls not counted)
# march-graph launches and the loop iterations they ran, since the last reset
graph_stats = rm.MarchStats(launches=0, iterations=0)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LOOP_ARGTYPES = [_P, _P, _I, _P, _I, _I, _P, _P]
_CREATE_ARGTYPES = [_P, _P, _P, _P, _I, _P, _I, ctypes.POINTER(_P)]


def loop_control_ref(alive, rs_alive, counter, max_chunks: int,
                     first: bool = False):
    """The plain version, in place: ``alive &= rs_alive``; the counter set
    to 0 (``first``) or advanced by one; returns the condition of the next
    iteration as a () int32 tensor."""
    if first:
        counter.fill_(-1)
    a, i, cond = rm.loop_control(alive, rs_alive, counter, max_chunks)
    alive.copy_(a)
    counter.copy_(i)
    return cond.to(torch.int32)


def loop_control(alive, rs_alive, counter, max_chunks: int,
                 first: bool = False):
    """One eager launch of the control kernel on (R,) bool ``alive`` and
    ``rs_alive`` and a () int32 ``counter``; same result as
    ``loop_control_ref``."""
    global launches
    if not alive.is_cuda:
        return loop_control_ref(alive, rs_alive, counter, max_chunks, first)
    R = alive.shape[0]
    g = _build.require
    cond = torch.empty((), dtype=torch.int32, device=alive.device)
    fn = _build.function("cpuvox_march_loop", _LOOP_ARGTYPES)
    code = fn(g(alive, torch.bool, (R,), "alive"),
              g(rs_alive, torch.bool, (R,), "rs_alive"), R,
              g(counter, torch.int32, (), "counter"), int(max_chunks),
              int(first), cond.data_ptr(), _build.stream_ptr(alive))
    _build.check(code, "cpuvox_march_loop")
    if _build.counted():
        launches += 1
    return cond


class MarchGraphExec:
    """The instantiated graph of a frame's march: the captured ``prologue``
    (a ``torch.cuda.CUDAGraph`` made with ``keep_graph=True``), the control
    kernel, and a WHILE node over the captured ``body`` and the control
    kernel, on the state's ``alive``, ``rs_alive`` and () int32
    ``counter``.  The captures must outlive it (their private pool holds
    the body's temporaries); it keeps them.  Raises if the graph cannot be
    built or instantiated."""

    def __init__(self, prologue, body, alive, rs_alive, counter,
                 max_chunks: int):
        R = alive.shape[0]
        g = _build.require
        self._keep = (prologue, body, alive, rs_alive, counter)
        self._exec = _P()
        self._destroy = _build.function("cpuvox_march_graph_destroy", [_P])
        fn = _build.function("cpuvox_march_graph_create", _CREATE_ARGTYPES)
        code = fn(prologue.raw_cuda_graph(), body.raw_cuda_graph(),
                  g(alive, torch.bool, (R,), "alive"),
                  g(rs_alive, torch.bool, (R,), "rs_alive"), R,
                  g(counter, torch.int32, (), "counter"), int(max_chunks),
                  ctypes.byref(self._exec))
        _build.check(code, "cpuvox_march_graph_create")

    def launch(self, stream) -> None:
        """One frame's march on ``stream`` (a ``torch.cuda.Stream``)."""
        fn = _build.function("cpuvox_march_graph_launch", [_P, _P])
        _build.check(fn(self._exec, stream.cuda_stream),
                     "cpuvox_march_graph_launch")

    def __del__(self):
        if getattr(self, "_exec", None):
            self._destroy(self._exec)
            self._exec = _P()


def kernel_launches() -> dict:
    """The march's and phase 2's kernel launches since the last
    ``reset_launches``: the wrappers' counts plus what the march graphs ran
    on the device (one read of the device if a graph ran)."""
    from . import phase1_kernel, reproject_kernel, roll_kernel

    it = graph_stats["iterations"]
    return {"roll_chunk": roll_kernel.launches + it,
            "rasterize_visits": phase1_kernel.launches + it,
            "reproject_screen": reproject_kernel.launches,
            "reproject_screens": reproject_kernel.screens_launches,
            "march_loop": launches + graph_stats["launches"] + it}


def reset_launches() -> None:
    """Set every kernel launch count to 0."""
    global launches
    from . import phase1_kernel, reproject_kernel, roll_kernel

    roll_kernel.launches = phase1_kernel.launches = 0
    reproject_kernel.launches = reproject_kernel.screens_launches = 0
    phase1_kernel.chunk_launches = reproject_kernel.sample_launches = 0
    launches = 0
    graph_stats.update(launches=0, iterations=0)
