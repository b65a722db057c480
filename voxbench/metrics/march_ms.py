"""The march on the device (``Renderer.march``: the march graph with the
roll and rasterizer kernels), ms by CUDA events around the call, the mean a
frame."""

MOVES = "fps"


def read(t):
    if not t.march_ms:
        return None
    return sum(t.march_ms) / len(t.march_ms)
