"""The work of the binned traversal's two kernels (csrc/binned.cu): the
yardstick of prepass_roofline.binned and leaf_roofline.binned.

Copied so that a change to the program cannot move it: SLAB_OPS and
WT_OPS from chip_smoke.py (fp32 operations of one slab test and of one
watertight triangle test, counted in csrc/leaf.cuh, each add, multiply,
compare, min, max, abs and select one operation, an IEEE division one);
LANE_TRIS and BIN from pyrenderer_tpu_torch/accel/clusters.py (triangles
a cluster, clusters a bin: the program's defaults, which the cell runs).
The peaks are _peaks.py's.

The counts are the program counters of kernels/binned.py, a recorded
pass's mean (drivers/progressive_binned.py puts them in the tracer's
counters): binned_rays, the live rays the prepass tested, and
binned_pairs, the real (bin, ray) pairs the leaf tested. A program
without them reads nothing. The kernels' device time is over the
profiled passes, other passes of the same run: the counts hardly move
from pass to pass (the camera rays are the pixels, the rest an average
over them).
"""

from benchmark.harness import kernel_ident
from benchmark.metrics import _peaks

SLAB_OPS = 26       # fp32 operations of one ray-box slab test
WT_OPS = 75         # fp32 operations of one watertight triangle test
LANE_TRIS = 128     # triangles a cluster
BIN = 4             # clusters a bin
RAY_BYTES = 32      # a ray's row: origin, direction, t1, pad (8 float32)
BOX_BYTES = 32      # a bin box's row of bin_box8 (8 float32)
FLAG_BYTES = 1      # a ray's overflow flag
ID_BYTES = 4        # a candidate bin id (int32)
W = 6               # candidate bins a ray (kernels/binned.py W_SLOTS)
# a pair's ray and bin id read, its int64 ray index read and int64 key written
PAIR_BYTES = RAY_BYTES + ID_BYTES + 8 + 8
BIN_TRI_BYTES = BIN * LANE_TRIS * 9 * 4   # a bin's triangle rows v0 | e1 | e2


def bins(n_tris: int) -> int:
    """The scene's real bins: ceil(clusters / BIN), clusters of LANE_TRIS."""
    clusters = -(-n_tris // LANE_TRIS)
    return -(-clusters // BIN)


def prepass_work(rays: float, n_bins: int, launches: int) -> tuple:
    """(fp32 operations, bytes) of `launches` prepass launches over `rays`
    live rays in all: each ray slab-tested against every real bin; each
    ray read once, its W ids and its flag written once, the bin boxes read
    once a launch."""
    ops = rays * n_bins * SLAB_OPS
    nbytes = rays * (RAY_BYTES + W * ID_BYTES + FLAG_BYTES) + launches * n_bins * BOX_BYTES
    return ops, nbytes


def leaf_work(pairs: float, n_bins: int, launches: int) -> tuple:
    """(fp32 operations, bytes) of `launches` leaf launches over `pairs`
    pairs in all: each pair's ray against its bin's BIN x LANE_TRIS
    triangles; each pair's ray, bin id and ray index read and its key
    written once, and each bin's triangles read once a launch. The pairs
    arrive sorted by bin, so a bin's rows are read from the L2 for all but
    its first pair: counting them once a pair (an upper bound of the
    traffic, 18,432 bytes a pair) would put the least time above the
    kernel's own."""
    ops = pairs * BIN * LANE_TRIS * WT_OPS
    nbytes = pairs * PAIR_BYTES + launches * n_bins * BIN_TRI_BYTES
    return ops, nbytes


def roofline(ctx, kernel: str, counter: str, work):
    """100 x the least time of `kernel`'s work over its device time in the
    profiled passes: work(count, real bins, launches) -> (ops, bytes), the
    count the counter's mean a pass times the profiled passes; None where
    the kernel did not run or the count or the triangles are missing."""
    if kernel not in ctx.kernels.get("binned", set()):
        return None
    dev = [e for e in ctx.device_events() if kernel_ident(e.name) == kernel]
    n = ctx.counters.get(counter)
    n_tris = ctx.counters.get("n_tris")
    if not dev or not n or not n_tris or not ctx.units:
        return None
    ops, nbytes = work(n * ctx.units, bins(n_tris), len(dev))
    seconds = sum(e.end - e.start for e in dev)
    return 100.0 * _peaks.least_seconds(ops, nbytes) / seconds
