"""The gate glue inside the march graph, ms on the card a frame: the time from
each roll launch's end to the rasterizer's start and from each rasterizer
launch's end to the next control kernel's start (the gated march's gate
kernel and its rewind kernel, ``csrc/gate.cu``, and the graph's node
latencies around them; the dense march has only the node latencies),
by the card's clock (the kernels' own sampled timers, ``csrc/timer.cuh``),
the mean over the sampled frames among the last ``t.frames`` frames the
program rendered, read from its recorder
(``cpuvox_tpu_torch/utils/profiling.PROFILER``).  The four parts (roll,
rasterizer, gate glue, march control) partition the graph's time from the
first control kernel's start to the last one's end.  None where the program
times nothing (the CPU, a program without the timers) or kept fewer frames
than the window's."""

MOVES = "fps"


def read(t):
    try:
        from cpuvox_tpu_torch.utils.profiling import PROFILER
        s = PROFILER.summary(t.frames)
    except (ImportError, AttributeError):
        return None
    return None if s is None else s["device_ms"].get("gate_glue")
