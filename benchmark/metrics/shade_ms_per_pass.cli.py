"""Host milliseconds a pass of the shading glue's own dispatch: the self
time of the program's spans `camera` (generate_rays) and `bounce` (one
iteration of the estimator's loop), less their children (`nee`,
`scatter`, `query`, `rng`), over the passes recorded after the window."""

from benchmark.metrics._spans import ms_per_unit


def read(ctx):
    return ms_per_unit(ctx, {"camera", "bounce"}, self_time=True)
