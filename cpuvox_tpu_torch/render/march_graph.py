"""A single-camera frame's march as one CUDA graph launch.

The port of the JAX package's in-graph march: there the march is a
``lax.while_loop`` whose condition lives on the device
(``cpuvox_tpu/render/raymarch.py:928-957``, and ``:1542``/``:1583`` for the
gated march), or with its staged live-ray compaction
(``phase1_pallas``, ``:1010-1024``, ``:1085-1092``, ``:1583-1605``) a
while_loop a stage width, so a frame never asks the host and the harness
can dispatch frame i before it waits for frame i-1
(``cpuvox_tpu/bench/harness.py:46-71``).  Here the loop is a CUDA graph
with a conditional WHILE node a stage whose condition a hand-written
kernel sets (``csrc/march_loop.cu``).

A ``MarchGraph`` belongs to a Renderer (``Renderer.march`` on a CUDA
Renderer with the kernels; a camera batch's march, ``parallel/batch.py``,
on such a Renderer in a graph of its own at the group's bucketed ray
count; each ray shard or camera block of ``parallel/`` in one of its own,
with a stream of its own, ``Renderer.shard_graph``).  It holds static
buffers at the frame's ray count: the rays
(``RayStatic``), the loop's state (``raymarch.MarchState``: the DDA, the
liveness, the raster state, the iteration counter, the rewind count), the
per-ray camera height the rasterizer and the gate read, and a live-ray
index buffer a stage width below the full one.  A variant is an iteration
direction, the dense or the gated march, and a stage schedule: the full
width alone (the uncompacted march), or ``raymarch.stage_widths`` (the
compacted one).  For each variant it captures with
``torch.cuda.CUDAGraph(keep_graph=True)``, after one eager warm iteration a
stage on dead rays:

- the prologue: the raster state reset from the rays, the rewind and
  gate counts 0;
- a body a stage: one iteration without its control (``raymarch.
  march_body`` or ``gated_body``) on the stage's index buffer (none at the
  full width) with the next state written back into the buffers
  (``raymarch.write_state``);
- a pack between two stages (``pack``): the live rays, then dead ones,
  each in ascending order, scattered by a cumsum rank into the next
  stage's index buffer (``raymarch.stage_index``'s result, with no sort
  and no host read);

and ``ops/march_loop.MarchGraphExec`` instantiates the parent graph: the
prologue, then a stage at a time the control kernel (the check before the
stage's first iteration: no iteration runs when no more rays live than the
next stage holds), a WHILE node over the body and the control kernel,
which folds ``alive &= rs.alive``, counts the iteration and the live rays
and sets the condition, and the pack.  The device counter runs on across
the stages and enforces the budget, so a staged frame runs the iterations
an uncompacted one does; each stage writes the counter at its exit into
the variant's ``exits`` buffer.  All the variants of a MarchGraph capture
into one private pool: they never run at once, and a body's temporaries
are dead by its end.

A frame copies its rays into the buffers (device-to-device, no host read),
fills the camera height (a camera batch copies a height a ray, and its
quotient by the world's height, both made with its rays), launches the
graph, adds the iteration, stage, rewind and gate counts to the stats on
the device, and fills the skybox into a new tensor, so the raybuffer it
returns does not alias the buffers that the next frame overwrites.  Phase
2 follows as an eager launch on the same stream.  ``march`` runs on the
current stream, and the counts go into that stream's accumulators
(``raymarch.device_sum``).  A shard graph (``own_stream``) has a stream of
its own that its callers make current, so the graphs of several shards run
at once on one card, each march of one graph in order on its stream; their
private pools are apart.

What a capture bakes in is the variant's key: the world arrays (the same
object), the chunk, the budget, the gated group, the LOD distances, the
far clip and the dims.  The captures read the Renderer's own world arrays
until it swaps them (a dynamic world rebuilt every frame, a world-sharded
window); from the first swap on they read copies the MarchGraph owns,
refreshed in place from each new set of the same layout (``world``), so a
swap costs a copy a table and no capture.  A failed capture,
instantiation or launch raises.

A Renderer's frame graph (``timed``) also holds a timer buffer
(``csrc/timer.cuh``) that its roll, rasterizer and control kernels are
given at capture: before each launch the frame's buffer is set for a
sampled or an unsampled frame (``utils/profiling.Recorder.device_row``)
and, after a sampled one, copied into the frame's row of the recorder's
device ring, each a device-to-device copy in stream order; a batch or
shard graph is untimed.  Each capture is a ``graph_capture`` process span
of the recorder, with the numbers it adds to ``captures``.

On a CPU device the same buffers, stages, packs and in-place iteration run
with the host reading each condition (``march``): the plain version of the
graph, which the CPU tests hold against the functional ``march_step`` /
``gated_step`` loop, the host loop and the JAX package.
"""
from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from cpuvox_tpu_torch.utils import profiling

from . import raymarch as rm


def _same_layout(a: rm.WorldArrays, b: rm.WorldArrays) -> bool:
    """Whether ``b`` can be copied into ``a``'s tensors: the same tensor
    shapes, types and devices, the same host fields."""
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
            if not (isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor)
                    and x.shape == y.shape and x.dtype == y.dtype
                    and x.device == y.device):
                return False
        elif x != y:
            return False
    return True


class _Variant(NamedTuple):
    """One captured variant: the settings it baked in, its loop's
    ``MarchArgs`` (the world arrays among them), its stage widths, the
    (stages,) int32 buffer of the counter at each stage's exit, and the
    instantiated graph (None on a CPU device)."""

    key: tuple
    args: rm.MarchArgs
    widths: tuple
    exits: torch.Tensor
    exec: object = None


def thresholds(widths) -> list:
    """Each stage's loop threshold: the next stage's width, 0 for the
    last (``raymarch.py:1126-1129``)."""
    return [*widths[1:], 0]


class MarchGraph:
    """Static buffers for ``R`` rays of ``P`` texels on ``device``, and
    the captured march of each variant over them."""

    def __init__(self, R: int, P: int, world_max_y, solid_bounds, device,
                 own_stream: bool = False, timed: bool = False):
        dev = torch.device(device)
        f32, i32 = torch.float32, torch.int32

        def z(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.device = dev
        self.static = rm.RayStatic(
            dirs=z((R, 2), f32), plane_bottom=z((R, 3), f32),
            plane_top=z((R, 3), f32), plane_dir=z((R, 3), f32),
            orig_min=z(R, i32), orig_max=z(R, i32))
        dda = rm.DDAState(pos=z((R, 2), i32), tmax=z((R, 2), f32),
                          tdelta=z((R, 2), f32), stp=z((R, 2), i32),
                          ids=z((R, 2), f32), lod=z(R, i32))
        self.state = rm.march_state(dda, z(R, torch.bool),
                                    rm.init_raster_state(self.static, P))
        # a camera height a ray, filled each frame: a capture holds pointers
        smin, smax = solid_bounds
        self.consts = rm.raster_consts(world_max_y, np.zeros(R, np.float32),
                                       smin, smax, dev)
        self.world_max_y = np.float32(world_max_y)
        self.variants: dict[tuple, _Variant] = {}
        # a stage's live-ray index buffer by width, one slot more (the
        # pack's discard), and the ray numbers the pack scatters
        self._index: dict[int, torch.Tensor] = {}
        self._rays = torch.arange(R, dtype=i32, device=dev)
        # the Renderer's world arrays last seen, and those the captures read
        self._wa_in = self._wa_cap = None
        # one line a capture: variant, warm, capture and instantiate ms,
        # the private pool's growth in bytes
        self.captures: list[dict] = []
        self.pool = (torch.cuda.graph_pool_handle() if dev.type == "cuda"
                     else None)
        # a shard graph's stream, on which its callers queue its marches
        # and world copies (``parallel/``); None: the caller's current one
        self.stream = (torch.cuda.Stream(dev)
                       if own_stream and dev.type == "cuda" else None)
        # a frame graph's timer buffer (None: untimed), its starts as an
        # unsampled and a sampled frame, whether it holds a sampled one,
        # and the card's clock's offset to the host's (at the first capture)
        self.timer = self._timer_init = None
        self._sampled = False
        self.clock_offset_ns = None
        if timed and dev.type == "cuda":
            self._timer_init = profiling.timer_init(dev)
            self.timer = self._timer_init[0].clone()

    @property
    def shape(self) -> tuple[int, int]:
        return tuple(self.state.rs.raybuf.shape)

    def load(self, static: rm.RayStatic, dda: rm.DDAState, alive0,
             cam_y, cam_y_norm=None) -> None:
        """A frame's rays and camera height into the buffers: ``cam_y`` the
        camera's height, or for a batch of cameras (R,) tensors of a ray's
        camera height and its ``cam_y_norm`` (``device_init.
        init_rays_batch``)."""
        for d, x in zip(self.static, static):
            d.copy_(x)
        for d, x in zip(self.state.dda, dda):
            d.copy_(x)
        self.state.alive.copy_(alive0)
        if cam_y_norm is not None:
            self.consts["cam_y"].copy_(cam_y)
            self.consts["cam_y_norm"].copy_(cam_y_norm)
            return
        cy = np.float32(cam_y)
        self.consts["cam_y"].fill_(float(cy))
        # an f32 divide, as raster_consts computes it
        self.consts["cam_y_norm"].fill_(float(cy / self.world_max_y))

    def prologue(self) -> None:
        rm.reset_raster_state(self.state.rs, self.static)
        self.state.rewound.zero_()
        self.state.gate_counts.zero_()

    def index(self, width: int):
        """The live-ray index buffer of a stage ``width`` rays wide (int32
        (width,)), or None for the full width."""
        if width == self._rays.shape[0]:
            return None
        buf = self._index.get(width)
        if buf is None:  # distinct rays until the first pack
            buf = self._index[width] = torch.arange(
                width + 1, dtype=torch.int32, device=self.device)
        return buf[:width]

    def body(self, a: rm.MarchArgs, index=None) -> None:
        body = rm.gated_body if a.group_cells else rm.march_body
        rm.write_state(self.state, body(a, self.state, index))

    def pack(self, width: int) -> None:
        """The next stage's index (``index(width)``) from the liveness: a
        live ray goes to its rank among the live rays, a dead one after all
        of them to its rank among the dead, and a rank at or past ``width``
        to the discarded slot; ``raymarch.stage_index`` is its plain
        version."""
        self.index(width)
        alive = self.state.alive
        live = torch.cumsum(alive, 0, dtype=torch.int32)  # live rays <= r
        dest = torch.where(alive, live - 1, live[-1:] + self._rays - live)
        self._index[width].scatter_(0, dest.clamp_(max=width).long(),
                                    self._rays)

    def control(self, a: rm.MarchArgs, first: bool, threshold: int = 0,
                check: bool = False, exit_out=None):
        from cpuvox_tpu_torch.ops import march_loop

        s = self.state
        return march_loop.loop_control(s.alive, s.rs.alive, s.i,
                                       a.max_chunks, first=first,
                                       threshold=threshold, check=check,
                                       exit_out=exit_out)

    def world(self, wa: rm.WorldArrays) -> rm.WorldArrays:
        """The world arrays the captures read for the Renderer's ``wa``:
        ``wa`` itself until the Renderer swaps it; then a copy the graph
        owns, refreshed in place (in stream order) from each new ``wa`` of
        the same layout, and copied anew for a new layout."""
        if wa is not self._wa_in:
            if self._wa_in is None:
                self._wa_cap = wa
            elif (self._wa_cap is not self._wa_in
                  and _same_layout(self._wa_cap, wa)):
                for d, x in zip(self._wa_cap, wa):
                    if isinstance(d, torch.Tensor):
                        d.copy_(x)
            else:
                self._wa_cap = rm.WorldArrays(*(
                    x.clone() if isinstance(x, torch.Tensor) else x
                    for x in wa))
            self._wa_in = wa
        return self._wa_cap

    def variant(self, wa: rm.WorldArrays, lod_distances, far_clip, dims,
                iteration_direction: int, chunk: int, max_chunks: int,
                group_cells: int, widths=None,
                before_capture=None) -> _Variant:
        """The variant for these settings and stage ``widths`` (None: the
        full width alone, the uncompacted march), captured now if it was
        not (or if a setting it baked in changed), on the world arrays
        ``world`` gives for ``wa``; ``before_capture()``, where given, is
        called before a capture (the shards wait there for every graph
        still running, ``parallel/mesh.py``)."""
        R = self._rays.shape[0]
        widths = (R,) if widths is None else tuple(int(w) for w in widths)
        if widths[0] != R or any(b >= a for a, b in zip(widths, widths[1:])):
            raise ValueError(f"stage widths {widths} for {R} rays")
        wa = self.world(wa)
        lod = tuple(float(x) for x in np.asarray(lod_distances, np.float32))
        far = float(np.float32(far_clip))  # compares like the f32 scalar
        slot = (int(iteration_direction), int(group_cells), widths)
        key = (lod, far, tuple(dims), int(chunk), int(max_chunks))
        v = self.variants.get(slot)
        if v is not None and v.key == key and v.args.wa is wa:
            return v
        if before_capture is not None and self.device.type == "cuda":
            before_capture()
        a = rm.MarchArgs(
            wa, self.static,
            torch.tensor(lod, dtype=torch.float32, device=self.device), far,
            tuple(dims), self.consts, slot[0], int(chunk), int(max_chunks),
            slot[1], True)
        exits = torch.zeros(len(widths), dtype=torch.int32,
                            device=self.device)
        v = self.variants[slot] = _Variant(
            key, a, widths, exits,
            self._capture(a, slot, widths, exits)
            if self.device.type == "cuda" else None)
        return v

    def _capture(self, a: rm.MarchArgs, slot, widths, exits):
        with profiling.PROFILER.process_span("graph_capture") as numbers:
            exec_ = self._capture_variant(a, slot, widths, exits)
            numbers.update(self.captures[-1])
        return exec_

    def _capture_variant(self, a: rm.MarchArgs, slot, widths, exits):
        from cpuvox_tpu_torch.ops import _build, march_loop

        dev = self.device
        if self.timer is not None and self.clock_offset_ns is None:
            host, card = march_loop.globaltimer_anchor(dev)
            self.clock_offset_ns = host - card
        t0 = time.perf_counter()
        # one eager iteration a stage on dead rays, and the packs: the
        # kernels load and torch's ops make their first-use calls before the
        # capture; the frame's load overwrites what they wrote
        self.state.alive.zero_()
        for w in widths:
            self.body(a, self.index(w))
        for w in widths[1:]:
            self.pack(w)
        reserved = torch.cuda.memory_reserved(dev)
        t1 = time.perf_counter()

        def captured(fn):
            g = torch.cuda.CUDAGraph(keep_graph=True)
            g.capture_begin(pool=self.pool)
            try:
                fn()
            finally:
                g.capture_end()
            return g

        stages = []
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            prologue = captured(self.prologue)
            bodies, packs = [], []
            for k, w in enumerate(widths):
                s0, r0 = time.perf_counter(), torch.cuda.memory_reserved(dev)
                with _build.timing(self.timer):
                    bodies.append(captured(
                        lambda: self.body(a, self.index(w))))
                if k + 1 < len(widths):
                    packs.append(captured(lambda: self.pack(widths[k + 1])))
                stages.append({
                    "width": w, "capture_ms": (time.perf_counter() - s0) * 1e3,
                    "pool_bytes": torch.cuda.memory_reserved(dev) - r0})
        torch.cuda.current_stream(dev).wait_stream(stream)
        t2 = time.perf_counter()
        exec_ = march_loop.MarchGraphExec(
            prologue, bodies, packs, thresholds(widths), self.state.alive,
            self.state.rs.alive, self.state.i, a.max_chunks, exits,
            self.timer)
        t3 = time.perf_counter()
        self.captures.append({
            "direction": slot[0], "gated": slot[1] > 0, "widths": widths,
            "warm_ms": (t1 - t0) * 1e3, "capture_ms": (t2 - t1) * 1e3,
            "instantiate_ms": (t3 - t2) * 1e3,
            "pool_bytes": torch.cuda.memory_reserved(dev) - reserved,
            "stages": stages})
        return exec_

    def _timer_frame(self):
        """The frame's row of the recorder's device ring if it samples the
        frame (None if not, or untimed), with the timer buffer set for a
        sampled or an unsampled frame in stream order (no copy between two
        unsampled frames)."""
        if self.timer is None:
            return None
        row = profiling.PROFILER.device_row(self.device, self.clock_offset_ns)
        if row is not None or self._sampled:
            self.timer.copy_(self._timer_init[int(row is not None)])
            self._sampled = row is not None
        return row

    def march(self, v: _Variant, static: rm.RayStatic, dda: rm.DDAState,
              alive0, cam_y, cam_y_norm=None):
        """One frame's march of variant ``v`` on these rays (``load``'s
        camera heights), on the current stream: the (R, P) int32 raybuffer
        after the skybox fill, a tensor of its own."""
        from cpuvox_tpu_torch.ops import march_loop

        a = v.args
        self.load(static, dda, alive0, cam_y, cam_y_norm)
        s = self.state
        if v.exec is not None:
            row = self._timer_frame()
            v.exec.launch(torch.cuda.current_stream(self.device))
            if row is not None:
                row.copy_(self.timer)
            march_loop.graph_stats.add(launches=1, checks=len(v.widths),
                                       iterations=s.i)
        else:  # the plain version: the host reads each condition
            self.prologue()
            for k, (w, t) in enumerate(zip(v.widths, thresholds(v.widths))):
                index = self.index(w)
                cond = self.control(a, first=k == 0, threshold=t,
                                    check=k > 0, exit_out=v.exits[k])
                while bool(cond):
                    self.body(a, index)
                    cond = self.control(a, first=False, threshold=t,
                                        exit_out=v.exits[k])
                if k + 1 < len(v.widths):
                    self.pack(v.widths[k + 1])
        march_loop.stage_stats.add(v.widths, v.exits)
        if a.group_cells:
            rm.add_gated_stats(s, s.i)
        return rm.fill_skybox(a.wa, self.static, s.rs.raybuf)
