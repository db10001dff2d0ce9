"""Host milliseconds a pass inside the binned queries' four spans
(kernels/binned.py: `bin_prepass`, the prepass and its one read, the
query's wait; `bin_sort`, the pair sort and its cut; `bin_leaf`, the leaf
and the scatter-min; `bin_overflow`, the residual sweep of the overflow
rays), less their `launch` children: the glue's torch ops and the wait,
over the passes recorded after the window; None where the program has no
such spans."""

from benchmark.metrics._spans import ms_per_unit


def read(ctx):
    return ms_per_unit(ctx, {"bin_prepass", "bin_sort", "bin_leaf", "bin_overflow"},
                       self_time=True)
