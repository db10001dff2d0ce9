"""B2's share of its roofline, in percent: the any-hit kernel of
csrc/intersect.cu (anyhit_kernel) under the pbrt estimator. Its work is
the shadow rays the pbrt trace's any-hit queries tested (the program
counter shadow_rays, a pass's mean, times the profiled passes), each
against every triangle at MT_OPS; its bytes each such ray read and hit
written once and the triangle table once a launch; its time the kernel's
device time over the profiled passes (_lanes.roofline). An any hit stops
at its first occluder, so the operations are an upper bound of the work
and the share may read above what the kernel achieves on the tests it
makes; in these scenes most shadow rays reach the light and test every
triangle."""

from benchmark.metrics._lanes import roofline


def read(ctx):
    return roofline(ctx, "anyhit_kernel", "shadow_rays")
