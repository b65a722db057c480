"""What the benchmark takes from the program (``cpuvox_tpu_torch``): the
Renderer under test, its camera type, its camera batch
(``parallel/batch.py``), its color resolve and its launch counter.  It
imports the program when it is imported, so that a checkout without the
program fails before any world is built.  Besides it, only the readers of
the program's own recorder (``voxbench/metrics/``, those that read
``cpuvox_tpu_torch.utils.profiling``) import the program, when they read.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from cpuvox_tpu_torch.config import RenderConfig
from cpuvox_tpu_torch.ops import march_loop
from cpuvox_tpu_torch.parallel import batch as _batch
from cpuvox_tpu_torch.render import raymarch
from cpuvox_tpu_torch.render.camera import Camera
from cpuvox_tpu_torch.render.frame import Renderer
from cpuvox_tpu_torch.world.rle import WorldLOD


def renderer(lods, config: dict, traffic: dict, device: str):
    """A Renderer over a copy of the benchmark's world (the program's own
    ``WorldLOD`` type), with the configuration's render settings at the
    traffic's screen size."""
    plods = [WorldLOD(**{f.name: (np.array(getattr(w, f.name))
                                  if isinstance(getattr(w, f.name), np.ndarray)
                                  else getattr(w, f.name))
                         for f in dataclasses.fields(w)}) for w in lods]
    r = config["render"]
    rc = RenderConfig(width=traffic["width"], height=traffic["height"],
                      fov_y_deg=r["fov_y_deg"], near_clip=r["near_clip"],
                      lod_levels=r["lod_levels"], lod_error=r["lod_error"],
                      render_scale=r["render_scale"],
                      skybox_rgb=tuple(r["skybox_rgb"]),
                      occupancy_gate=r["occupancy_gate"])
    return Renderer.create(plods, rc, device=device)


def camera(pose: dict, traffic: dict):
    return Camera(**pose, screen=(traffic["width"], traffic["height"]))


def gate_on(r) -> bool:
    """Whether the occupancy gate resolved on for this world."""
    return bool(r.occupancy_on)


def captures(r) -> int:
    """March-graph captures the Renderer has made, in its frame graph and
    its camera batch's graphs (a capture in the window would be a compile
    inside it)."""
    graphs = [r._graph] if r._graph is not None else []
    graphs += list(r._batch_graphs.values())
    return sum(len(g.captures) for g in graphs)


def camera_batch(r, cams):
    """A step of a camera batch: (B, H, W) int32 ARGB bits on the card, one
    screen a camera in the order of ``cams`` (``render_camera_batch``)."""
    return _batch.render_camera_batch(r, cams)


def bucket_size(n: int, cap: int) -> int:
    """The cameras the batch pads a direction group of ``n`` to, in a batch
    of ``cap``: each bucket is a march-graph variant of its own."""
    return _batch.bucket_size(n, cap)


def hook_batch(name: str, make):
    """Puts ``make(f)`` in the place of the batch module's function ``name``
    (``f``), where ``render_camera_batch`` looks it up, and returns the
    callable that puts ``f`` back.  Hooks are undone in the reverse order."""
    inner = getattr(_batch, name)
    setattr(_batch, name, make(inner))

    def undo():
        setattr(_batch, name, inner)

    return undo


def raybuffer_argb(r, raybuf) -> np.ndarray:
    """A frame's raybuffer as uint32 ARGB on the host: color indices resolved
    through the Renderer's colors (unwritten texels magenta), or as they are
    in ARGB mode."""
    argb = raybuf if r.argb_on else raymarch.resolve_colors(raybuf, r._wa.colors)
    return argb.cpu().numpy().view(np.uint32)


def rasterizer_iterations() -> int | None:
    """The march iterations run since the last reset, a rasterizer launch
    an iteration (one read of the device counter), None if the program
    counts none."""
    n = march_loop.kernel_launches().get("rasterize_visits")
    return None if n is None else int(n)
