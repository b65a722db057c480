"""The Renderer's packing of the world's records on the host
(``render/device.build_device_world``, called by ``Renderer.create``), s:
the program's own process span ``world_pack``, read from its recorder
(``cpuvox_tpu_torch/utils/profiling.PROFILER``), summed over the spans it
kept.  None where the program records no such span."""

MOVES = "setup_s"


def read(t):
    try:
        from cpuvox_tpu_torch.utils.profiling import PROFILER
        return PROFILER.process_totals().get("world_pack")
    except (ImportError, AttributeError):
        return None
