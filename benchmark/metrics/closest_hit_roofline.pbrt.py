"""B1's share of its roofline, in percent: the closest-hit kernel of
csrc/intersect.cu (closest_kernel) under the pbrt estimator. Its work is
the lanes the pbrt trace's closest-hit queries tested (the program
counter closest_rays, a pass's mean, times the profiled passes), each
against every triangle at MT_OPS; its bytes each such ray read and hit
written once and the triangle table once a launch; its time the kernel's
device time over the profiled passes (_lanes.roofline)."""

from benchmark.metrics._lanes import roofline


def read(ctx):
    return roofline(ctx, "closest_kernel", "closest_rays")
