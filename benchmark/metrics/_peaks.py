"""Published peaks of one NVIDIA H100 SXM and the operation counts of the
port's triangle tests: the yardstick of the kernels' rooflines.

Copied from chip_smoke.py (PEAK_FP32, PEAK_BYTES: NVIDIA's H100 SXM data
sheet, fp32 outside the tensor cores and HBM3, rates at the full 700 W;
the card's power limit is printed beside every run) and from
pyrenderer_tpu_torch/perf/clusterbench.py (MT_OPS: fp32 operations of one
Moeller-Trumbore test counted in csrc/intersect.cu, each add, multiply,
compare, min, max, abs and select one operation, an IEEE division one).

The work of a query is counted in rays as bench.py counts them (copied
convention, pyrenderer_tpu_torch/bench.py docstring): the closest-hit rays
of live lanes plus the NEE shadow rays; dead, masked lanes are not
counted. The program's ProgressiveRenderer.rays_traced counts so.
"""

PEAK_FP32 = 67e12      # fp32 FLOP/s
PEAK_BYTES = 3.35e12   # HBM bytes/s
MT_OPS = 60            # fp32 operations of one Moeller-Trumbore test
RAY_BYTES = 28 + 9     # a ray read once (origin, direction, t1), a hit written once


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time of `ops` fp32 operations and `nbytes` bytes of device
    memory traffic on the card."""
    return max(ops / PEAK_FP32, nbytes / PEAK_BYTES)
