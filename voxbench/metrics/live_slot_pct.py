"""The live share of the ray slots the march graph marched, %: the live
rays before each iteration over the width of the stage it ran at, summed
over the iterations of the sampled frames among the last ``t.frames``
frames the program rendered (the control kernel's own count, added on the
card, read from the program's recorder,
``cpuvox_tpu_torch/utils/profiling.PROFILER``).  None where the program
counts nothing (the CPU, a program without the count) or kept fewer
frames than the window's."""

MOVES = "fps"


def read(t):
    try:
        from cpuvox_tpu_torch.utils.profiling import PROFILER
        s = PROFILER.summary(t.frames)
    except (ImportError, AttributeError):
        return None
    if s is None or not s.get("slots"):
        return None
    return 100.0 * s["live_rays"] / s["slots"]
