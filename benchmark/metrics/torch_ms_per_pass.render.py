"""Device milliseconds a pass of every device event that is not one of the
program's own kernels (PyTorch's kernels, copies and fills), summed over
the events, over the profiled passes."""


def read(ctx):
    dev = [e for e in ctx.device_events() if not ctx.is_port(e)]
    if not dev or not ctx.units:
        return None
    return sum(e.end - e.start for e in dev) * 1e3 / ctx.units
