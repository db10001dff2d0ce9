"""The progressive-render driver of the pbrt cells: progressive.Driver's
passes (the CLI's render loop: set-up, warm-up, the window, with a tracer
the device-profiled passes), judged against the pbrt reference
(benchmark/reference/render_pbrt.py), with the program's own spans read
after the window.

With a tracer, after the passes progressive.Driver profiles,
`profile_passes` more passes run under the program's
utils/profiling.recording() and no torch profiler, so that the spans'
record_function annotations ("pr::*") never reach the device-only trace.
The recorder's spans go to the metric readers through the tracer's
counters: "spans", one (name, start_ns, end_ns, parent, unit, syncs) a
span, parent and unit indices into that list; "syncs_counted", whether
the host's waits were counted (on a CUDA device). Those passes land on
the film too, and are counted among the passes judged.

What is judged is the film after the window, as progressive.Driver
judges it (at `compare_pixels` pixels drawn from the seed, each pixel's
sum against the reference's sum of the same samples, every pixel's
sample count against the passes run), and sq_gap: the relative gap
between the film's and the reference's sums of squared samples over the
compared pixels and channels, which an estimator that keeps the mean but
changes the variance (Russian roulette or MIS taken out) moves.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from benchmark import compare, harness
from benchmark.reference import render_pbrt
from benchmark.reference import scene as scene_data

progressive = harness.load_module(Path(__file__).with_name("progressive.py"),
                                  "benchmark_driver_progressive")


def pixels(seed: int, w: int, h: int, n_pix: int):
    """(rows, cols) of the n_pix film pixels a run of `seed` compares, and
    their (px, py) in the camera's pixel coordinates (y up)."""
    idx = np.random.default_rng(seed).choice(w * h, min(n_pix, w * h), replace=False)
    rows, cols = idx // w, idx % w
    return rows, cols, cols, h - 1 - rows


def film_numbers(film_sum, film_sq, film_spp, reference, n_samples: int) -> dict:
    """compare.film_numbers and sq_gap: |the film's summed squares - the
    reference's| / the reference's, None where the film has a sample
    gap."""
    sums = []

    def ref():
        sums.append(reference())
        return sums[0]

    numbers = compare.film_numbers(film_sum, film_spp, ref, n_samples)
    numbers["sq_gap"] = None
    if sums:
        r_sq = float(np.asarray(sums[0][1], np.float64).sum())
        numbers["sq_gap"] = abs(float(np.asarray(film_sq, np.float64).sum()) - r_sq) / max(
            abs(r_sq), 1e-30)
    return numbers


class Driver(progressive.Driver):
    def window(self, seconds: float, tracer=None) -> None:
        super().window(seconds, tracer)
        if tracer is not None:
            self._record(tracer, int(self.traffic["profile_passes"]))

    def _record(self, tracer, n: int) -> None:
        from pyrenderer_tpu_torch.utils.profiling import recording

        with recording(self.device) as rec:
            for _ in range(n):
                self.renderer.render_one_pass()
        tracer.counters["spans"] = [(s.name, s.start_ns, s.end_ns, s.parent, s.unit, s.syncs)
                                    for s in rec.spans]
        tracer.counters["syncs_counted"] = "syncs" in rec.counters
        self.passes += n
        self.attempted += n

    def judge(self) -> dict:
        w, h = self.camera["resolution"]
        rows, cols, px, py = pixels(self.seed, w, h, int(self.cell.checks["compare_pixels"]))
        n = self.passes * int(self.traffic["spp_step"])

        def ref_sums():
            ref = render_pbrt.PbrtReference(self.arrays, self.camera, self.config, self.device)
            return ref.pixel_sums(torch.as_tensor(px, device=self.device),
                                  torch.as_tensor(py, device=self.device), n, self.seed)

        return film_numbers(self.film.radiance_sum[rows, cols], self.film.sq_sum[rows, cols],
                            self.film.spp_map, ref_sums, n)


class _NoMis(render_pbrt.PbrtReference):
    """A planted fault that keeps the mean: NEE unweighted, and emission
    found by a bsdf sample counted only at the camera vertex (no vertex
    here is specular)."""

    def emission_weight(self, bounce, prev_pdf, pdf_light):
        return torch.full_like(pdf_light, 1.0 if bounce == 0 else 0.0)

    def nee_weight(self, pdf_nee, pdf_bsdf):
        return torch.ones_like(pdf_nee)


def control_numbers(cell, seed: int, device, variant: str = "bfloat16", samples=None) -> dict:
    """The comparison's numbers of the reference in `variant` against the
    reference, at the pixels a run of `seed` compares, over `samples`
    samples a pixel. "bfloat16" (one precision below the configuration's
    float32) is the control and must fail; "float64" moves every rounding,
    as a sound change of the program's arithmetic may, and must pass.
    Faults that keep the mean: "rr_off" (Russian roulette never starts)
    and "mis_off" (_NoMis)."""
    arrays, camera = scene_data.load(cell.config["scene"])
    camera["resolution"] = tuple(cell.config["resolution"])
    w, h = camera["resolution"]
    _, _, px, py = pixels(seed, w, h, int(cell.checks["compare_pixels"]))
    px, py = torch.as_tensor(px, device=device), torch.as_tensor(py, device=device)
    settings, cls, dtype = cell.config, render_pbrt.PbrtReference, torch.float32
    if variant in ("bfloat16", "float64"):
        dtype = getattr(torch, variant)
    elif variant == "rr_off":
        settings = dict(settings, render=dict(settings["render"],
                                              russian_roulette_start=settings["max_bounces"]))
    elif variant == "mis_off":
        cls = _NoMis
    else:
        raise ValueError(f"variant {variant!r}")
    ref = render_pbrt.PbrtReference(arrays, camera, cell.config, device).pixel_sums(
        px, py, samples, seed)
    alt = cls(arrays, camera, settings, device, dtype=dtype).pixel_sums(px, py, samples, seed)
    return film_numbers(alt[0], alt[1], np.full((h, w), samples), lambda: ref, samples)
