"""The progressive-render driver of the specular pbrt cell: progressive_pbrt's
passes and recorded spans, on a scene with spheres, metal and glass
(benchmark/reference/scene_specular.py) and a stratified camera, judged
against the specular pbrt reference
(benchmark/reference/render_pbrt_specular.py).

The program's RenderConfig takes the configuration's `stratified` and the
scene's own renderer.spp, which sets the camera's grid (ceil(sqrt(spp))
square); the window's passes walk it by their sample ids. With a tracer,
the passes recorded after the window also hand the readers the program's
counters closest_rays and shadow_rays, a recorded pass's mean of each
(the lanes the closest-hit and any-hit queries tested), beside the spans.

What is judged is progressive_pbrt's: the film after the window at
`compare_pixels` pixels drawn from the seed against the reference's sums
of the same samples, every pixel's sample count, and sq_gap.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from benchmark import harness
from benchmark.reference import render_pbrt_specular as reference
from benchmark.reference import scene_specular as scene_data

progressive_pbrt = harness.load_module(Path(__file__).with_name("progressive_pbrt.py"),
                                       "benchmark_driver_progressive_pbrt")
progressive = progressive_pbrt.progressive
COUNTED = ("closest_rays", "shadow_rays")


def strata(config: dict) -> int:
    """The camera grid's side: ceil(sqrt(the scene's renderer.spp)) where
    the configuration is stratified, else 0."""
    if not config.get("stratified"):
        return 0
    return reference.strata_of(int(config["scene"]["renderer"]["spp"]))


class Driver(progressive_pbrt.Driver):
    def setup(self) -> None:
        from pyrenderer_tpu_torch.config import RenderConfig
        from pyrenderer_tpu_torch.render.driver import ProgressiveRenderer
        from pyrenderer_tpu_torch.scene.types import Camera, Scene, to_device

        cfg_file = self.config
        arrays, camera = scene_data.load(cfg_file["scene"])
        camera["resolution"] = tuple(cfg_file["resolution"])
        self.arrays, self.camera = arrays, camera
        scene, cam = to_device(Scene(**arrays), Camera(**camera), self.device)
        cfg = RenderConfig(max_bounces=int(cfg_file["max_bounces"]),
                           spp=int(cfg_file["scene"]["renderer"]["spp"]),
                           stratified=bool(cfg_file["stratified"]),
                           spp_step=int(self.traffic["spp_step"]),
                           estimator=cfg_file["estimator"], seed=self.seed,
                           **cfg_file["render"])
        w, h = camera["resolution"]
        film = progressive._timed_film(self._tracer).blank(w, h, self.seed)
        self.renderer = ProgressiveRenderer(scene, cam, cfg, backend=cfg_file["backend"],
                                            film=film, chunk=int(self.traffic["chunk"]))
        self.film = film
        for _ in range(int(self.traffic["warmup_passes"])):
            self.renderer.render_one_pass()
        self.passes = int(self.traffic["warmup_passes"])

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

    def judge(self) -> dict:
        w, h = self.camera["resolution"]
        rows, cols, px, py = progressive_pbrt.pixels(self.seed, w, h,
                                                     int(self.cell.checks["compare_pixels"]))
        n = self.passes * int(self.traffic["spp_step"])

        def ref_sums():
            ref = reference.SpecularReference(self.arrays, self.camera, self.config,
                                              self.device, strata=strata(self.config))
            return ref.pixel_sums(torch.as_tensor(px, device=self.device),
                                  torch.as_tensor(py, device=self.device), n, self.seed)

        return progressive_pbrt.film_numbers(
            self.film.radiance_sum[rows, cols], self.film.sq_sum[rows, cols],
            self.film.spp_map, ref_sums, n)


class _NoMis(reference.SpecularReference):
    """A planted fault that keeps the mean: NEE unweighted, and emission
    found by a bsdf sample counted only at the camera vertex and after a
    metal or glass vertex (where no NEE competes)."""

    def emission_weight(self, bounce, prev_pdf, pdf_light):
        return torch.full_like(pdf_light, 1.0 if bounce == 0 else 0.0)

    def nee_weight(self, pdf_nee, pdf_bsdf):
        return torch.ones_like(pdf_nee)


class _GlassReflects(reference.SpecularReference):
    """A planted fault: glass that never refracts (a mirror of albedo 1)."""

    def glass_sample(self, rd, n_geo, ior, u):
        n_eff = torch.where((reference._dot(rd, n_geo) < 0)[:, None], n_geo, -n_geo)
        return reference._normalize(reference._reflect(rd, n_eff))


# variant: (reference class, configuration's changes, the arrays' changes)
VARIANTS = {
    "bfloat16": None, "float64": None,
    "rr_off": lambda cfg, arrays: (reference.SpecularReference, dict(
        cfg, render=dict(cfg["render"], russian_roulette_start=cfg["max_bounces"])), arrays),
    "mis_off": lambda cfg, arrays: (_NoMis, cfg, arrays),
    "glass_reflects": lambda cfg, arrays: (_GlassReflects, cfg, arrays),
    "metal_smooth": lambda cfg, arrays: (reference.SpecularReference, cfg, dict(
        arrays, roughness=np.zeros_like(arrays["roughness"]))),
    "strata_off": lambda cfg, arrays: (reference.SpecularReference,
                                       dict(cfg, stratified=False), arrays),
}


def control_numbers(cell, seed: int, device, variant: str = "bfloat16", samples=None) -> dict:
    """The comparison's numbers of the reference in `variant` against the
    reference, at the pixels a run of `seed` compares, over `samples`
    samples a pixel. "bfloat16" (one precision below the configuration's
    float32) is the control and must fail; "float64" moves every rounding,
    as a sound change of the program's arithmetic may, and must pass.
    Faults that keep the image plausible: "rr_off" (Russian roulette
    never starts), "mis_off" (_NoMis), "glass_reflects" (_GlassReflects),
    "metal_smooth" (the metal's roughness 0), "strata_off" (the camera
    without strata)."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}")
    arrays, camera = scene_data.load(cell.config["scene"])
    camera["resolution"] = tuple(cell.config["resolution"])
    w, h = camera["resolution"]
    _, _, px, py = progressive_pbrt.pixels(seed, w, h, int(cell.checks["compare_pixels"]))
    px, py = torch.as_tensor(px, device=device), torch.as_tensor(py, device=device)
    cls, settings, alt_arrays, dtype = reference.SpecularReference, cell.config, arrays, \
        torch.float32
    if VARIANTS[variant] is None:
        dtype = getattr(torch, variant)
    else:
        cls, settings, alt_arrays = VARIANTS[variant](cell.config, arrays)
    ref = reference.SpecularReference(arrays, camera, cell.config, device,
                                      strata=strata(cell.config)).pixel_sums(px, py, samples,
                                                                             seed)
    alt = cls(alt_arrays, camera, settings, device, dtype=dtype,
              strata=strata(settings)).pixel_sums(px, py, samples, seed)
    return progressive_pbrt.film_numbers(alt[0], alt[1], np.full((h, w), samples),
                                         lambda: ref, samples)
