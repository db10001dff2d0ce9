"""The share of the binned queries' live rays that the residual sweep
finishes: the program counters overflow_rays (rays that crossed more than
W bins, re-traced through the unsorted cluster sweep) over binned_rays
(the live rays the prepass tested), a recorded pass's means
(kernels/binned.py, read after the window by drivers/progressive_binned.py);
None where the program does not count them."""


def read(ctx):
    rays = ctx.counters.get("binned_rays")
    ovf = ctx.counters.get("overflow_rays")
    if not rays or ovf is None:
        return None
    return ovf / rays
