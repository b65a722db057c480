"""Phase 2's share of its roofline, %: the least time the card needs for a
frame's phase 2 over its time.  The least time is the bytes over the H100's
3.35 TB/s: the screen written once, each raybuffer texel the screen samples
read once and, in index mode, each color word those texels name read once,
counted by the reference's own reprojection (``reference/frame.pixel_texels``)
on the frames the check kept, whatever implements phase 2; their mean.  The
time is the median over the window's frames of CUDA events around
``Renderer.phase2``: an event pair around a launch of some 0.03 ms also holds
any wait of the card for the host's launch, which the median leaves out."""

import statistics

from voxbench import peaks

MOVES = "fps"


def read(t):
    if not t.phase2_bytes or not t.phase2_ms:
        return None
    least_ms = statistics.mean(t.phase2_bytes) / peaks.HBM_BYTES_PER_S * 1e3
    return 100.0 * least_ms / statistics.median(t.phase2_ms)
