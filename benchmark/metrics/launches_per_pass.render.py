"""Device events (kernels, copies, fills) a pass, over the profiled
passes: the host's dispatch of the shading glue, camera and Threefry
(core/integrator.py, core/sampling.py, core/camera.py, rng.py), the
accelerator's glue and the kernels. A count: it repeats for a seed."""


def read(ctx):
    n = len(ctx.device_events())
    return n / ctx.units if n and ctx.units else None
