"""B5's share of its roofline, in percent: the binned prepass
(csrc/binned.cu binned_prepass_kernel). Its work is the live rays the
prepass tested (the program counter binned_rays, a pass's mean, times the
profiled passes), each slab-tested against every real bin at SLAB_OPS;
its bytes each such ray read once, its W ids and flag written once, and
the bin boxes once a launch (_binned.prepass_work); its time the kernel's
device time over the profiled passes."""

from benchmark.metrics import _binned


def read(ctx):
    return _binned.roofline(ctx, "binned_prepass_kernel", "binned_rays", _binned.prepass_work)
