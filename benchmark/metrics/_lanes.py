"""A whole-table kernel's share of its roofline, from the lanes the
program counted for its query: the readers closest_hit_roofline.pbrt and
any_hit_roofline.pbrt.

The counts are the program's counters closest_rays and shadow_rays (the
pbrt trace's lanes that its closest-hit and any-hit queries tested,
utils/profiling.count), a recorded pass's mean: from the tracer's
counters where the driver put them there (drivers/progressive_specular.py),
else from the program's last recording() block, the passes the driver
recorded after the window (utils/profiling.last_recording; a program
without it, or without the counters, reads nothing). The kernel's device
time is over the profiled passes, which are other passes of the same
run: the counts a pass hardly move from pass to pass (the primary rays
are the pixels, and the rest is an average over them).
"""

from benchmark.harness import kernel_ident
from benchmark.metrics import _peaks


def lanes_per_pass(ctx, name: str):
    """A recorded pass's mean of the program counter `name`; None where it
    was not counted."""
    if name in ctx.counters:
        return ctx.counters[name]
    try:
        from pyrenderer_tpu_torch.utils import profiling
    except ImportError:
        return None
    last = getattr(profiling, "last_recording", None)
    rec = last() if last is not None else None
    summary = rec.summary("pass") if rec is not None else None
    return summary.get(name) if summary else None


def roofline(ctx, kernel: str, counter: str):
    """100 x the least time of `kernel`'s work over its device time in the
    profiled passes: each counted lane tested against every triangle at
    MT_OPS, each lane's ray read and hit written once, and the triangle
    table read once a launch; None where the kernel did not run or the
    lanes were not counted."""
    if kernel not in ctx.kernels.get("intersect", set()):
        return None
    dev = [e for e in ctx.device_events() if kernel_ident(e.name) == kernel]
    lanes = lanes_per_pass(ctx, counter)
    n_tris = ctx.counters.get("n_tris")
    if not dev or not lanes or not n_tris or not ctx.units:
        return None
    rays = lanes * ctx.units
    seconds = sum(e.end - e.start for e in dev)
    ops = rays * n_tris * _peaks.MT_OPS
    nbytes = rays * _peaks.RAY_BYTES + len(dev) * n_tris * 9 * 4
    return 100.0 * _peaks.least_seconds(ops, nbytes) / seconds
