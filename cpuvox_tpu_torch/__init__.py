"""cpuvox_tpu_torch — the PyTorch + CUDA (Hopper, sm_90a) port of cpuvox_tpu.

The JAX package ``cpuvox_tpu`` stays the reference; this package renders the
same frames bit for bit on an NVIDIA H100:

- ``render``    camera, segments, the device world layout and the numpy
                oracle; ray init on the host or the device (a camera batch's
                in one vectorised pass), the plain torch twin of the phase-1
                march (dense and occupancy-gated), phase-2 reprojection and
                the Renderer; the march graph (``march_graph.py``): a frame's
                march, or a camera batch's direction group, as one CUDA graph
                launch with a WHILE node, so the host reads nothing
- ``ops``       the hand-written CUDA kernels, each beside its plain torch
                version: the DDA roll, the rasterizer, phase 2 (a frame or a
                camera batch a launch) and the march loop's control kernel,
                which sets the graph's WHILE condition
- ``parallel``  the camera batch (the RL-rollout mode), and rendering over
                several devices: ray- and camera-sharded frames, the world
                sharded by LOD0 tiles
- ``assets``    mesh import (``.obj``), the voxelizer on the card and the
                LOD chain, into a world
- ``frontend``  the interactive session (camera controllers, a step a frame)
- ``bench``     the benchmark entry (``python -m cpuvox_tpu_torch.bench``),
                its timing harness, the per-stage breakdown and the kernels'
                design-constant sweeps
- ``config``, ``models``, ``utils``, ``world``: render settings, procedural
                and dynamic worlds, colors and profiling, the RLE world and
                its ``.world`` files

The host-side numpy modules are copies of the JAX package's: this package
imports nothing of ``cpuvox_tpu`` and no jax.
"""

__version__ = "0.1.0"
