"""The whole-table kernels' share of their roofline, in percent: the
least time of the work the profiled passes asked of them over the time
they took.

The kernels are the __global__ functions of csrc/intersect.cu. The work
is every ray the passes queried (the program's rays_traced counter over
the profiled passes: live closest-hit rays plus shadow rays) tested
against every triangle of the scene, at MT_OPS a test, whatever
implements the query; the bytes are each such ray read and its hit
written once, and the triangle table read once a launch. A shadow ray's
any hit may stop at its first occluder, so for shadow rays the count is
an upper bound of the work; in a closed box most shadow rays are not
occluded and test every triangle."""

from benchmark.harness import kernel_ident
from benchmark.metrics import _peaks


def read(ctx):
    names = ctx.kernels.get("intersect", set())
    dev = [e for e in ctx.device_events() if kernel_ident(e.name) in names]
    rays = ctx.counters.get("rays_traced")
    n_tris = ctx.counters.get("n_tris")
    if not dev or not rays or not n_tris:
        return None
    seconds = sum(e.end - e.start for e in dev)
    ops = rays * n_tris * _peaks.MT_OPS
    nbytes = rays * _peaks.RAY_BYTES + len(dev) * n_tris * 9 * 4
    return 100.0 * _peaks.least_seconds(ops, nbytes) / seconds
