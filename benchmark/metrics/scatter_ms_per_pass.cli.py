"""Host milliseconds a pass inside the program's span `scatter`
(core/integrator_pbrt.py: the three BSDF samplers, the throughput update
and Russian roulette of every bounce), over the passes recorded after the
window; None where the program has no such span."""

from benchmark.metrics._spans import ms_per_unit


def read(ctx):
    return ms_per_unit(ctx, {"scatter"})
