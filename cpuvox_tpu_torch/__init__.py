"""cpuvox_tpu_torch — the PyTorch + CUDA (Hopper, sm_90a) port of cpuvox_tpu.

The JAX package ``cpuvox_tpu`` stays the reference; this package renders the
same frames bit for bit on an NVIDIA H100:

- ``render``  camera, segments, the device world layout and the numpy oracle;
              host ray init, the plain torch twin of the phase-1 march (dense
              and occupancy-gated), phase-2 reprojection and the Renderer
- ``ops``     the three hand-written CUDA kernels (DDA roll, chunk rasterizer,
              raybuffer sample), each beside its plain torch version
- ``bench``   the benchmark path, the flythrough timing harness (CUDA events
              + synchronize) and the per-stage breakdown
- ``config``, ``models``, ``utils``, ``world``: render settings, procedural
              worlds, colors, the RLE world and its ``.world`` files

The host-side numpy modules are copies of the JAX package's: this package
imports nothing of ``cpuvox_tpu`` and no jax.
"""

__version__ = "0.1.0"
