"""The host's waits for the device a pass (stream syncs and blocking
copies, as utils/profiling.recording counts them on a CUDA device), over
the passes recorded after the window. A count: it repeats for a seed."""

from benchmark.metrics._spans import syncs_per_unit


def read(ctx):
    return syncs_per_unit(ctx)
