"""Render configuration: a copy of ``cpuvox_tpu/config.py``.

Every field here keeps the JAX package's name and default.  Left out are the
knobs that shaped only the TPU kernels' layout or Mosaic's control flow
(``kernel_run_block``, ``kernel_sweep_skip``, ``kernel_walk_tile``,
``kernel_walk_cond``, ``kernel_slot_gate``, ``kernel_roll``,
``block_groups``, ``pallas_interpret``).  ``block_fetch``, ``lite_records``
and ``drain_groups`` stay so that the Renderer can refuse their non-default
settings, which the port does not carry.  ``argb_records`` (kernel 2 writes
the column's inline colors, phase 2 skips the color resolve) and
``host_init`` are carried.  One default differs: ``host_init`` is True
here, because on the H100 a frame's setup is up to 1.3 ms faster with the
numpy host init than with the device init's hundred small launches, and was
not slower in any run (a tie within the host's spread at the least,
``PERF.md``); both give the same bits.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings of a Renderer."""

    width: int = 1280
    height: int = 720

    # camera intrinsics (reference scene: FOV 85, near 0.05, far 1000;
    # Assets/Scenes/SampleScene.unity:176-178 — far is overwritten per-world by
    # UnityManager.SetupLods, :421-423)
    fov_y_deg: float = 85.0
    near_clip: float = 0.05

    # LOD policy (UnityManager.cs:42, :436 "lodError", World.cs REPEAT_WORLD clip scaling)
    lod_levels: int = 6
    lod_error: float = 1.0

    # render-resolution scale: phases 1+2 run at (width, height) * render_scale
    # through a scaled camera and the frame is upscaled (nearest) to native size
    # (UnityManager.cs:35-36,57-63,179-182)
    render_scale: float = 1.0

    # march bounds (replace the reference's unbounded per-ray `while(true)`;
    # DrawSegmentRayJob.cs:235).  0 = auto: the Renderer resolves them per
    # world (Renderer.march_params)
    max_march_chunks: int = 0
    chunk_steps: int = 0

    # skybox color, ARGB (DrawSegmentRayJob.cs:702 — (25, 25, 25))
    skybox_rgb: tuple[int, int, int] = (25, 25, 25)

    # "xla" runs the plain torch versions of the kernels (the twin of the
    # JAX package's XLA path); anything else the hand-written CUDA kernels
    backend: str = "pallas"
    # ARGB records: inline each column's voxel colors into its record so
    # phase 1 writes final colors and phase 2 skips the color resolve.
    # Engages when no column holds more than 24 voxels
    # (render/device.py INLINE_MAX_COLORS); the record grows by that many
    # words, so it is opt-in.  Output-identical either way
    argb_records: bool = False
    # per-ray init on the host (numpy, render/ray_init.py) or, with False,
    # on the device (render/device_init.py); both give the same bits in
    # every lane.  The JAX package defaults to False; on the H100 the host
    # init is the faster one (PERF.md), so the port defaults to True
    host_init: bool = True
    # occupancy-gated march ("auto" | "on" | "off"): read one 16x8-column
    # occupancy-tile row per tile a ray crosses per chunk and fetch column
    # records only for nonempty visits — the empty-column `continue` of
    # DrawSegmentRayJob.cs:251-256.  "auto" enables it when >= 50% of LOD0
    # columns are empty.  Output-identical to the dense march either way
    occupancy_gate: str = "auto"
    # gated-group size: cells fetched + rasterized per chunk per ray on the
    # gated path (rays with more gated cells in a chunk rewind to the first
    # unprocessed cell — output-exact for ANY value).  0 = auto
    gated_group_cells: int = 0
    # the JAX package's block-conditional gated fetch: only "auto"/"off"
    # (both off) are ported
    block_fetch: str = "auto"
    # the JAX package's lite records: only "off" is ported
    lite_records: str = "off"
    # gated-chunk drain groups: only 0 (one group, then the rewind) is ported
    drain_groups: int = 0
    # solid-bound ray kill ("on" | "off"): retire a ray once its frozen
    # frustum window provably clears the world's solid-content Y bounds;
    # output-exact, "off" is the A/B leg
    solid_kill: str = "on"

    @property
    def screen(self) -> tuple[int, int]:
        return (self.width, self.height)

    @property
    def far_clip_multiplier(self) -> int:
        # UnityManager.cs:421: REPEAT_WORLD ? 10 : 2 — we fix REPEAT_WORLD=False
        return 2
