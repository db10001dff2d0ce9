"""Device milliseconds a pass of the program's own kernels: the
__global__ functions of pyrenderer_tpu_torch/csrc/*.cu, found by name at
set-up, over the profiled passes."""


def read(ctx):
    dev = [e for e in ctx.device_events() if ctx.is_port(e)]
    if not dev or not ctx.units:
        return None
    return sum(e.end - e.start for e in dev) * 1e3 / ctx.units
