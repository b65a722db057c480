"""Kernel 4: the march loop's control (``csrc/march_loop.cu``), and the
CUDA graph of a frame's march that it drives.

Replaces the condition of the JAX march's ``lax.while_loop``
(``cpuvox_tpu/render/raymarch.py:928-930``, ``:1542``/``:1583`` for the
gated march and ``:1126-1129`` for a stage of the staged march): one block
folds ``alive &= rs_alive``, counts the live rays, advances the iteration
counter (or sets it to 0 before the first iteration, or leaves it before a
later stage), writes it to a stage's slot of an exit buffer and, inside a
graph, sets the WHILE node's condition ``count > threshold && i <
max_chunks``.  ``loop_control`` launches it eagerly (for the comparisons
with the plain version, ``loop_control_ref``, the torch expression of
``raymarch.loop_control``); ``MarchGraphExec`` builds the parent graph
around the graphs torch captured (``render/march_graph.py``: the prologue,
a body a stage and a pack between two stages) and launches it.

Launch counts: ``launches`` counts the wrapper's eager launches of the
control kernel.  Inside a march graph the kernels run without their
wrappers, so the graphs count on the device: ``graph_stats`` holds the
graph launches, the stage checks they made (one a stage: the check before
its first iteration) and the loop iterations they ran (read from the
device only when asked), and ``kernel_launches`` adds them to the
wrappers' counts (an iteration launches the roll, the rasterizer and the
control kernel once each).  ``stage_stats`` holds the iterations by stage
width.  A wrapper called while its stream is being captured does not
count: that call records a launch, it makes none.  A Renderer's frame
graph also times its kernels on sampled frames (``csrc/timer.cuh``,
``render/march_graph.py``); ``globaltimer_anchor`` maps the card's clock
onto the host's.
"""
from __future__ import annotations

import ctypes
import time

import torch

from cpuvox_tpu_torch.render import raymarch as rm

from . import _build

launches = 0  # eager launches of the control kernel (plain calls not counted)
# march-graph launches, their stage checks and the loop iterations they ran,
# since the last reset
graph_stats = rm.MarchStats(launches=0, checks=0, iterations=0)

# the control kernel's modes (csrc/march_loop.cu)
FIRST, NEXT, CHECK = 0, 1, 2

_P = ctypes.c_void_p
_I = ctypes.c_int
_LOOP_ARGTYPES = [_P, _P, _I, _P, _I, _I, _I, _P, _P, _P]
_CREATE_ARGTYPES = [_P, _I, _P, _P, _P, _P, _P, _I, _P, _I, _P, _P,
                    ctypes.POINTER(_P)]


class StageStats:
    """The iterations march graphs ran at each stage width since the last
    ``reset``: device sums a schedule (one a stream, ``raymarch.
    device_sum``), added from a graph's exit buffer without a read, read
    when asked (``dict(stage_stats.read())``, width -> iterations, summed
    over the schedules and streams)."""

    def __init__(self):
        self._acc: dict[tuple, tuple] = {}

    def add(self, widths: tuple, exits) -> None:
        """A frame's exit buffer ((n,) int32, the counter at each stage's
        exit) for its stage ``widths``."""
        acc = rm.device_sum(self._acc, tuple(widths), exits, len(widths))
        acc += exits
        acc[1:] -= exits[:-1]

    def read(self) -> dict:
        out: dict[int, int] = {}
        for (widths, _dev, _s), (acc, stream) in self._acc.items():
            for w, n in zip(widths, rm.read_sum(acc, stream)):
                out[w] = out.get(w, 0) + int(n)
        return dict(sorted(out.items(), reverse=True))

    def reset(self) -> None:
        self._acc.clear()


stage_stats = StageStats()


def _mode(first: bool, check: bool) -> int:
    if first and check:
        raise ValueError("the control is either the first check or a check")
    return FIRST if first else CHECK if check else NEXT


def loop_control_ref(alive, rs_alive, counter, max_chunks: int,
                     first: bool = False, threshold: int = 0,
                     check: bool = False, exit_out=None):
    """The plain version, in place: ``alive &= rs_alive``; the counter set
    to 0 (``first``), left as it is (``check``) or advanced by one; the
    counter copied to ``exit_out`` (a () int32 tensor) where given; returns
    the condition ``count(alive) > threshold & counter < max_chunks`` as a
    () int32 tensor."""
    mode = _mode(first, check)
    if mode == FIRST:
        counter.fill_(-1)
    elif mode == CHECK:
        counter.sub_(1)
    a, i, cond = rm.loop_control(alive, rs_alive, counter, max_chunks,
                                 threshold)
    alive.copy_(a)
    counter.copy_(i)
    if exit_out is not None:
        exit_out.copy_(i)
    return cond.to(torch.int32)


def loop_control(alive, rs_alive, counter, max_chunks: int,
                 first: bool = False, threshold: int = 0,
                 check: bool = False, exit_out=None):
    """One eager launch of the control kernel on (R,) bool ``alive`` and
    ``rs_alive``, a () int32 ``counter`` and ``exit_out`` (a () int32
    tensor, or None); same result as ``loop_control_ref``."""
    global launches
    if not alive.is_cuda:
        return loop_control_ref(alive, rs_alive, counter, max_chunks, first,
                                threshold, check, exit_out)
    R = alive.shape[0]
    g = _build.require
    cond = torch.empty((), dtype=torch.int32, device=alive.device)
    fn = _build.function("cpuvox_march_loop", _LOOP_ARGTYPES)
    code = fn(g(alive, torch.bool, (R,), "alive"),
              g(rs_alive, torch.bool, (R,), "rs_alive"), R,
              g(counter, torch.int32, (), "counter"), int(max_chunks),
              _mode(first, check), int(threshold),
              None if exit_out is None
              else g(exit_out, torch.int32, (), "exit_out"),
              cond.data_ptr(), _build.stream_ptr(alive))
    _build.check(code, "cpuvox_march_loop")
    if _build.counted():
        launches += 1
    return cond


class MarchGraphExec:
    """The instantiated graph of a frame's march: the captured ``prologue``,
    then for each stage its check, a WHILE node over its captured body and
    the control kernel, and the captured pack into the next stage's index
    (``torch.cuda.CUDAGraph``s made with ``keep_graph=True``; ``packs`` one
    fewer than ``bodies``), on the state's ``alive``, ``rs_alive`` and ()
    int32 ``counter``, each stage's threshold (``thresholds``: the next
    stage's width, 0 for the last) and the (stages,) int32 ``exits``; its
    control kernels get ``timer`` (``csrc/timer.cuh``; None: untimed).  The
    captures must outlive it (their private pool holds the bodies'
    temporaries); it keeps them.  Raises if the graph cannot be built or
    instantiated."""

    def __init__(self, prologue, bodies, packs, thresholds, alive, rs_alive,
                 counter, max_chunks: int, exits, timer=None):
        n = len(bodies)
        if len(packs) != n - 1 or len(thresholds) != n or n < 1:
            raise ValueError(f"{n} bodies, {len(packs)} packs and "
                             f"{len(thresholds)} thresholds")
        R = alive.shape[0]
        g = _build.require
        self._keep = (prologue, bodies, packs, alive, rs_alive, counter,
                      exits, timer)
        self._exec = _P()
        self._destroy = _build.function("cpuvox_march_graph_destroy", [_P])
        fn = _build.function("cpuvox_march_graph_create", _CREATE_ARGTYPES)
        c_bodies = (_P * n)(*(b.raw_cuda_graph() for b in bodies))
        c_packs = (_P * max(n - 1, 1))(*(p.raw_cuda_graph() for p in packs))
        c_thr = (_I * n)(*(int(t) for t in thresholds))
        code = fn(prologue.raw_cuda_graph(), n, c_bodies, c_packs, c_thr,
                  g(alive, torch.bool, (R,), "alive"),
                  g(rs_alive, torch.bool, (R,), "rs_alive"), R,
                  g(counter, torch.int32, (), "counter"), int(max_chunks),
                  g(exits, torch.int32, (n,), "exits"),
                  None if timer is None else g(timer, torch.int64, None,
                                               "timer"),
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


def globaltimer_anchor(device) -> tuple[int, int]:
    """(host ns, card ns): ``time.perf_counter_ns()`` and the card's
    ``%globaltimer`` at one moment, the host's the midpoint of a one-thread
    launch that reads the card's, after a sync.  Syncs."""
    out = torch.zeros((), dtype=torch.int64, device=device)
    fn = _build.function("cpuvox_globaltimer", [_P, _P])
    torch.cuda.synchronize(device)
    t0 = time.perf_counter_ns()
    _build.check(fn(out.data_ptr(), _build.stream_ptr(out)),
                 "cpuvox_globaltimer")
    torch.cuda.synchronize(device)
    t1 = time.perf_counter_ns()
    return (t0 + t1) // 2, int(out.item())


def globaltimer_steps(device, n: int = 256) -> list:
    """The card's ``%globaltimer`` as one thread sees it change, ``n``
    steps in ns: its update granularity.  Syncs."""
    out = torch.zeros(n + 1, dtype=torch.int64, device=device)
    fn = _build.function("cpuvox_globaltimer_steps", [_P, _I, _P])
    _build.check(fn(out.data_ptr(), n, _build.stream_ptr(out)),
                 "cpuvox_globaltimer_steps")
    return out.diff().tolist()


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
            "march_loop": launches + graph_stats["checks"] + it}


def reset_launches() -> None:
    """Set every kernel launch count to 0."""
    global launches
    from . import phase1_kernel, reproject_kernel, roll_kernel

    roll_kernel.launches = phase1_kernel.launches = 0
    reproject_kernel.launches = reproject_kernel.screens_launches = 0
    phase1_kernel.chunk_launches = reproject_kernel.sample_launches = 0
    launches = 0
    graph_stats.update(launches=0, checks=0, iterations=0)
    stage_stats.reset()
