"""B7's share of its roofline, in percent: the resident binned leaf
(csrc/binned.cu binned_leaf_kernel). Its work is the real pairs the leaf
tested (the program counter binned_pairs, a pass's mean, times the
profiled passes), each pair's ray against its bin's BIN x 128 triangles
at WT_OPS (the cell's leaves are watertight); its bytes each pair's ray,
bin id and ray index read and its key written once, and each bin's
triangles once a launch (_binned.leaf_work: the least traffic; once a
pair would be an upper bound, above the kernel's time); its time the
kernel's device time over the profiled passes."""

from benchmark.metrics import _binned


def read(ctx):
    return _binned.roofline(ctx, "binned_leaf_kernel", "binned_pairs", _binned.leaf_work)
