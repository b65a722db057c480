"""The frame set-up's geometry, ms by the host clock, the mean a frame over
the window's frames: the program's own span ``geometry`` inside
``Renderer.frame_setup`` (the camera snapshot, the vanishing point, the
segments and their contexts), read from its recorder
(``cpuvox_tpu_torch/utils/profiling.PROFILER``) for the last ``t.frames``
frames it rendered.  None where the program records no such span, or kept
fewer frames than the window's."""

MOVES = "latency_ms_p95"


def read(t):
    try:
        from cpuvox_tpu_torch.utils.profiling import PROFILER
        s = PROFILER.summary(t.frames)
    except (ImportError, AttributeError):
        return None
    return None if s is None else s["host_ms"].get("geometry")
