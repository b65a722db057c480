"""cpuvox_tpu_torch — the PyTorch + CUDA (Hopper, sm_90a) port of cpuvox_tpu.

The JAX package ``cpuvox_tpu`` stays the reference; this package renders the
same frames bit for bit on an NVIDIA H100:

- ``render``  host ray init (numpy), the plain torch twin of the phase-1 march,
              phase-2 reprojection and the frame Renderer (dense branch)
- ``ops``     the three hand-written CUDA kernels (DDA roll, chunk rasterizer,
              raybuffer sample), each beside its plain torch version
- ``bench``   the flythrough timing harness (CUDA events + synchronize)
- ``shared``  the host-side numpy modules borrowed from ``cpuvox_tpu``; none of
              them imports jax, and nothing in this package does
"""

__version__ = "0.1.0"
