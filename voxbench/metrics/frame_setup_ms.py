"""The host's set-up of a frame (``Renderer.frame_setup``: the camera, the
segments, the reprojection tables and the initial rays), ms by the host
clock, the mean over the window's frames."""

MOVES = "latency_ms_p95"


def read(t):
    if not t.setup_host_s:
        return None
    return 1e3 * sum(t.setup_host_s) / len(t.setup_host_s)
