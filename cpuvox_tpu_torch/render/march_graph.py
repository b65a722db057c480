"""A single-camera frame's march as one CUDA graph launch.

The port of the JAX package's in-graph march: there the march is a
``lax.while_loop`` whose condition lives on the device
(``cpuvox_tpu/render/raymarch.py:928-957``, and ``:1542``/``:1583`` for the
gated march), so a frame never asks the host and the harness can dispatch
frame i before it waits for frame i-1 (``cpuvox_tpu/bench/harness.py:46-71``).
Here the loop is a CUDA graph with a conditional WHILE node whose condition
a hand-written kernel sets (``csrc/march_loop.cu``).

A ``MarchGraph`` belongs to a Renderer (``Renderer.march`` on a CUDA
Renderer with the kernels and compaction off).  It holds static buffers at
the frame's ray count: the rays (``RayStatic``), the loop's state
(``raymarch.MarchState``: the DDA, the liveness, the raster state, the
iteration counter, the rewind count) and the per-ray camera height the
rasterizer and the gate read.  For each variant, an iteration direction
with the dense or the gated march, it captures with
``torch.cuda.CUDAGraph(keep_graph=True)``, after one eager warm iteration on
dead rays:

- the prologue: the raster state reset from the rays, the rewind count 0;
- the body: one iteration without its control (``raymarch.march_body`` or
  ``gated_body``) with the next state written back into the buffers
  (``raymarch.write_state``);

and ``ops/march_loop.MarchGraphExec`` instantiates the parent graph: the
prologue, the control kernel (the condition before the first iteration:
no iteration runs when no ray lives), and a WHILE node over the body and
the control kernel, which folds ``alive &= rs.alive``, counts the iteration
and sets the condition; the device counter enforces the budget.  All the
variants of a MarchGraph capture into one private pool: they never run at
once, and a body's temporaries are dead by its end.

A frame copies its rays into the buffers (device-to-device, no host read),
fills the camera height, launches the graph, adds the iteration and rewind
counts to the stats on the device, and fills the skybox into a new tensor,
so the raybuffer it returns does not alias the buffers that the next frame
overwrites.  Phase 2 follows as an eager launch on the same stream.

What a capture bakes in is the variant's key: the world arrays (the same
object), the chunk, the budget, the gated group, the LOD distances, the
far clip and the dims.  The captures read the Renderer's own world arrays
until it swaps them (a dynamic world rebuilt every frame, a world-sharded
window); from the first swap on they read copies the MarchGraph owns,
refreshed in place from each new set of the same layout (``world``), so a
swap costs a copy a table and no capture.  A failed capture,
instantiation or launch raises.

On a CPU device the same buffers and the same in-place iteration run with
the host reading the condition (``march``): the plain version of the graph,
which the CPU tests hold against the functional ``march_step`` /
``gated_step`` loop and against the JAX package.
"""
from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

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
    ``MarchArgs`` (the world arrays among them), and the instantiated graph
    (None on a CPU device)."""

    key: tuple
    args: rm.MarchArgs
    exec: object = None


class MarchGraph:
    """Static buffers for ``R`` rays of ``P`` texels on ``device``, and
    the captured march of each variant over them."""

    def __init__(self, R: int, P: int, world_max_y, solid_bounds, device):
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
        self.variants: dict[tuple[int, int], _Variant] = {}
        # the Renderer's world arrays last seen, and those the captures read
        self._wa_in = self._wa_cap = None
        # one line a capture: variant, warm, capture and instantiate ms,
        # the private pool's growth in bytes
        self.captures: list[dict] = []
        self.pool = (torch.cuda.graph_pool_handle() if dev.type == "cuda"
                     else None)

    @property
    def shape(self) -> tuple[int, int]:
        return tuple(self.state.rs.raybuf.shape)

    def load(self, static: rm.RayStatic, dda: rm.DDAState, alive0,
             cam_y) -> None:
        """A frame's rays and camera height into the buffers."""
        for d, x in zip(self.static, static):
            d.copy_(x)
        for d, x in zip(self.state.dda, dda):
            d.copy_(x)
        self.state.alive.copy_(alive0)
        cy = np.float32(cam_y)
        self.consts["cam_y"].fill_(float(cy))
        # an f32 divide, as raster_consts computes it
        self.consts["cam_y_norm"].fill_(float(cy / self.world_max_y))

    def prologue(self) -> None:
        rm.reset_raster_state(self.state.rs, self.static)
        self.state.rewound.zero_()

    def body(self, a: rm.MarchArgs) -> None:
        body = rm.gated_body if a.group_cells else rm.march_body
        rm.write_state(self.state, body(a, self.state))

    def control(self, a: rm.MarchArgs, first: bool):
        from cpuvox_tpu_torch.ops import march_loop

        s = self.state
        return march_loop.loop_control(s.alive, s.rs.alive, s.i,
                                       a.max_chunks, first=first)

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
                group_cells: int) -> _Variant:
        """The variant for these settings, captured now if it was not (or
        if a setting it baked in changed), on the world arrays ``world``
        gives for ``wa``."""
        wa = self.world(wa)
        lod = tuple(float(x) for x in np.asarray(lod_distances, np.float32))
        far = float(np.float32(far_clip))  # compares like the f32 scalar
        slot = (int(iteration_direction), int(group_cells))
        key = (lod, far, tuple(dims), int(chunk), int(max_chunks))
        v = self.variants.get(slot)
        if v is not None and v.key == key and v.args.wa is wa:
            return v
        a = rm.MarchArgs(
            wa, self.static,
            torch.tensor(lod, dtype=torch.float32, device=self.device), far,
            tuple(dims), self.consts, slot[0], int(chunk), int(max_chunks),
            slot[1], True)
        v = self.variants[slot] = _Variant(
            key, a, self._capture(a, slot) if self.device.type == "cuda"
            else None)
        return v

    def _capture(self, a: rm.MarchArgs, slot):
        from cpuvox_tpu_torch.ops import march_loop

        dev = self.device
        t0 = time.perf_counter()
        # one eager iteration on dead rays: the kernels load and torch's ops
        # make their first-use calls before the capture; the frame's load
        # overwrites what it wrote
        self.state.alive.zero_()
        self.body(a)
        reserved = torch.cuda.memory_reserved(dev)
        t1 = time.perf_counter()
        graphs = []
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            for fn in (self.prologue, lambda: self.body(a)):
                g = torch.cuda.CUDAGraph(keep_graph=True)
                g.capture_begin(pool=self.pool)
                try:
                    fn()
                finally:
                    g.capture_end()
                graphs.append(g)
        torch.cuda.current_stream(dev).wait_stream(stream)
        t2 = time.perf_counter()
        exec_ = march_loop.MarchGraphExec(
            graphs[0], graphs[1], self.state.alive, self.state.rs.alive,
            self.state.i, a.max_chunks)
        t3 = time.perf_counter()
        self.captures.append({
            "direction": slot[0], "gated": slot[1] > 0,
            "warm_ms": (t1 - t0) * 1e3, "capture_ms": (t2 - t1) * 1e3,
            "instantiate_ms": (t3 - t2) * 1e3,
            "pool_bytes": torch.cuda.memory_reserved(dev) - reserved})
        return exec_

    def march(self, v: _Variant, static: rm.RayStatic, dda: rm.DDAState,
              alive0, cam_y):
        """One frame's march of variant ``v`` on these rays: the (R, P)
        int32 raybuffer after the skybox fill, a tensor of its own."""
        from cpuvox_tpu_torch.ops import march_loop

        a = v.args
        self.load(static, dda, alive0, cam_y)
        s = self.state
        if v.exec is not None:
            v.exec.launch(torch.cuda.current_stream(self.device))
            march_loop.graph_stats.add(launches=1, iterations=s.i)
        else:  # the plain version: the host reads the condition
            self.prologue()
            cond = self.control(a, first=True)
            while bool(cond):
                self.body(a)
                cond = self.control(a, first=False)
        if a.group_cells:
            rm.gated_stats.add(iterations=s.i, rewinds=s.rewound)
        return rm.fill_skybox(a.wa, self.static, s.rs.raybuf)
