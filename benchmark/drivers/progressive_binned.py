"""The progressive-render driver of the binned cell: progressive.Driver's
passes (the CLI's render loop: set-up, warm-up, the window, with a tracer
the device-profiled passes) and its judging against the plain reference
(benchmark/reference/render.py), with the program's own spans and the
binned queries' counters read after the window.

With a tracer, after the passes progressive.Driver profiles,
`recorded_passes` more passes run under the program's
utils/profiling.recording() and no torch profiler, so that the spans'
record_function annotations ("pr::*") never reach the device-only trace.
The readers get, through the tracer's counters: "spans", one (name,
start_ns, end_ns, parent, unit, syncs) a span, parent and unit indices
into that list; "syncs_counted", whether the host's waits were counted
(on a CUDA device); and COUNTED, a recorded pass's mean of each of the
program counters of kernels/binned.py (binned_rays, the live rays its
prepass tested; binned_pairs, the real pairs its leaf tested;
overflow_rays, the rays its residual sweep finished). Those passes land
on the film too, and are counted among the passes judged.

What is judged is progressive.Driver's: the film after the window at
`compare_pixels` pixels drawn from the seed, each pixel's sum against the
reference's sum of the same samples, every pixel's sample count against
the passes run.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from benchmark import compare, harness
from benchmark.reference import render as reference
from benchmark.reference import scene as scene_data

progressive = harness.load_module(Path(__file__).with_name("progressive.py"),
                                  "benchmark_driver_progressive")
COUNTED = ("binned_rays", "binned_pairs", "overflow_rays")


class Driver(progressive.Driver):
    def window(self, seconds: float, tracer=None) -> None:
        super().window(seconds, tracer)
        if tracer is not None:
            self._record(tracer, int(self.traffic["recorded_passes"]))

    def _record(self, tracer, n: int) -> None:
        from pyrenderer_tpu_torch.utils.profiling import recording

        with recording(self.device) as rec:
            for _ in range(n):
                self.renderer.render_one_pass()
        tracer.counters["spans"] = [(s.name, s.start_ns, s.end_ns, s.parent, s.unit, s.syncs)
                                    for s in rec.spans]
        tracer.counters["syncs_counted"] = "syncs" in rec.counters
        summary = rec.summary("pass") or {}
        for name in COUNTED:
            if name in summary:
                tracer.counters[name] = summary[name]
        self.passes += n
        self.attempted += n


# the blocks a ray keeps in _FirstBlocks: at terrain100k the share of rays
# that cross more of the reference's blocks (6.4% of 2,048 camera rays, 21%
# of a bounce-1 wavefront's 464 live rays) is the share that cross more
# than W = 6 bins, which the program's prepass sends to the residual sweep
FIRST_BLOCKS = 11


class _FirstBlocks(reference.Reference):
    """A planted fault that mimics overflow work lost: a ray tests only
    the first FIRST_BLOCKS of the reference's blocks whose boxes it
    crosses (in block order, as the prepass keeps a ray's first W bins by
    bin id) and never the rest, in the closest and the shadow queries
    alike."""

    def set_params(self, vertices, albedo) -> None:
        super().set_params(vertices, albedo)
        pairs = self.tris._pairs

        def first(ro, rd, t0, t1):
            ray, blk = pairs(ro, rd, t0, t1)   # ascending by ray, then by block
            rank = torch.arange(ray.shape[0], device=ray.device) - torch.searchsorted(ray, ray)
            keep = rank < FIRST_BLOCKS
            return ray[keep], blk[keep]

        self.tris._pairs = first


# fault: (reference class, the configuration's changes)
FAULTS = {
    "moeller_trumbore": lambda cfg: (reference.Reference,
                                     dict(cfg, triangle_test="moller_trumbore")),
    "first_blocks": lambda cfg: (_FirstBlocks, cfg),
}


def control_numbers(cell, seed: int, device, variant: str = "bfloat16", samples=None) -> dict:
    """The comparison's numbers of the reference in `variant` against the
    reference, at the pixels a run of `seed` compares, over `samples`
    samples a pixel. "bfloat16" (the control, one precision below the
    configuration's float32) must fail; "float64" moves every rounding,
    as a sound change of the program's arithmetic may, and must pass
    (both progressive.control_numbers). Planted faults: "moeller_trumbore"
    (the Moeller-Trumbore test where watertight is configured: a leaf
    that dropped its watertight flag) and "first_blocks" (_FirstBlocks)."""
    if variant not in FAULTS:
        return progressive.control_numbers(cell, seed, device, variant, samples)
    arrays, camera = scene_data.load(cell.config["scene"])
    camera["resolution"] = tuple(cell.config["resolution"])
    w, h = camera["resolution"]
    n_pix = min(int(cell.checks["compare_pixels"]), w * h)
    idx = np.random.default_rng(seed).choice(w * h, n_pix, replace=False)
    px = torch.as_tensor(idx % w, device=device)
    py = torch.as_tensor(h - 1 - idx // w, device=device)
    cls, settings = FAULTS[variant](cell.config)
    ref = reference.Reference(arrays, camera, cell.config, device).pixel_sums(px, py, samples,
                                                                              seed)
    alt = cls(arrays, camera, settings, device).pixel_sums(px, py, samples, seed)
    return compare.film_numbers(alt[0], np.full((h, w), samples), lambda: ref, samples)
