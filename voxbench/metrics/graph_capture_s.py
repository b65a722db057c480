"""The march graphs' captures in set-up (``MarchGraph`` variants: the warm
iteration, the captures, the instantiation), s: the program's own process
spans ``graph_capture``, read from its recorder
(``cpuvox_tpu_torch/utils/profiling.PROFILER``), summed.  None where the
program records no such span."""

MOVES = "setup_s"


def read(t):
    try:
        from cpuvox_tpu_torch.utils.profiling import PROFILER
        return PROFILER.process_totals().get("graph_capture")
    except (ImportError, AttributeError):
        return None
