"""The progressive-render driver: the CLI's render loop, one pass after
another for as long as the window lasts.

Set-up loads the configuration's scene (benchmark/reference/scene.py),
hands its arrays to the program as a Scene on the device, builds
render.driver.ProgressiveRenderer (its TraceTables, and the accelerator
the backend needs) with a film of the harness's (a Film that times
add_pass), and renders the warm-up passes. The window calls
render_one_pass until `seconds` have gone by, each pass ending in its host
copy and film update. With a tracer, `profile_passes` passes after them
are profiled on the device alone, and one more with the host's
operations.

What is judged is the film after the window: at `compare_pixels` pixels
drawn from the seed, each pixel's sum against the plain reference's sum of
the same samples (benchmark/reference/render.py), and every pixel's
sample count against the passes run.

The traffic mix's numbers: spp_step (samples a pixel a pass), chunk (rays
a dispatch), warmup_passes, profile_passes.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import compare, harness
from benchmark.reference import render as reference
from benchmark.reference import scene as scene_data


def _timed_film(tracer_ref):
    """A Film whose add_pass is timed into the span "film.add_pass" of the
    tracer in tracer_ref[0], which keeps it while it profiles."""
    from pyrenderer_tpu_torch.core.film import Film

    class TimedFilm(Film):
        def add_pass(self, radiance_sum, sq_sum, n_samples: int = 1) -> None:
            t = time.perf_counter()
            super().add_pass(radiance_sum, sq_sum, n_samples)
            tracer = tracer_ref[0]
            if tracer is not None:
                tracer.span("film.add_pass", time.perf_counter() - t)

    return TimedFilm


class Driver:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
        self.traffic = cell.traffic
        self.config = cell.config
        self.attempted = self.failed = 0
        self.pass_s = []
        self.profiled = 0
        self.window_s = 0.0
        self._tracer = [None]

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
                           spp_step=int(self.traffic["spp_step"]),
                           estimator=cfg_file["estimator"], seed=self.seed,
                           **cfg_file["render"])
        w, h = camera["resolution"]
        film = _timed_film(self._tracer).blank(w, h, self.seed)
        self.renderer = ProgressiveRenderer(scene, cam, cfg, backend=cfg_file["backend"],
                                            film=film, chunk=int(self.traffic["chunk"]))
        self.film = film
        for _ in range(int(self.traffic["warmup_passes"])):
            self.renderer.render_one_pass()
        self.passes = int(self.traffic["warmup_passes"])

    def window(self, seconds: float, tracer=None) -> None:
        """Passes until `seconds` have gone by. With a tracer, profile_passes
        more passes are then profiled on the device alone, and one more with
        the host's operations too (the breakdown's): after the unprofiled
        ones, whose wall the profiler's state cannot slow."""
        r = self.renderer
        self._tracer[0] = tracer
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds or not self.pass_s:
            t = time.perf_counter()
            r.render_one_pass()
            self.pass_s.append(time.perf_counter() - t)
        if tracer is not None:
            n = int(self.traffic["profile_passes"])
            tracer.counters["unit_wall_s"] = float(np.median(self.pass_s))
            tracer.counters["n_tris"] = int(self.arrays["faces"].shape[0])
            rays0 = r.rays_traced
            tracer.begin()
            for _ in range(n):
                t = time.perf_counter()
                r.render_one_pass()
                self.pass_s.append(time.perf_counter() - t)
            tracer.end(n)
            tracer.counters["rays_traced"] = r.rays_traced - rays0
            tracer.begin(host=True)
            t = time.perf_counter()
            r.render_one_pass()
            self.pass_s.append(time.perf_counter() - t)
            tracer.end()
            self.profiled = n + 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.window_s = time.perf_counter() - t0
        self.attempted = len(self.pass_s)
        self.passes += len(self.pass_s)
        self.backend = r.backend

    def summary(self) -> list:
        all_ms = np.asarray(self.pass_s) * 1e3
        ms = all_ms[:all_ms.size - self.profiled]
        w, h = self.camera["resolution"]
        lines = [f"window: {all_ms.size} passes in {self.window_s:.3f} s, backend "
                 f"{self.backend}, {w}x{h}; unprofiled pass ms median {np.median(ms):.3f} "
                 f"p90 {harness.percentile(ms, 90):.3f} min {ms.min():.3f} max {ms.max():.3f}"]
        if self.profiled:
            lines.append("profiled pass ms: "
                         + " ".join(f"{x:.3f}" for x in all_ms[ms.size:]))
        return lines

    def end_to_end(self) -> dict:
        w, h = self.camera["resolution"]
        samples = len(self.pass_s) * w * h * int(self.traffic["spp_step"])
        return {
            "samples_per_s": samples / self.window_s / 1e6,
            "pass_ms_p90": harness.percentile(np.asarray(self.pass_s) * 1e3, 90),
        }

    def free(self) -> None:
        """Drop the renderer and its device state; the film (host) stays."""
        self.renderer = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def judge(self) -> dict:
        w, h = self.camera["resolution"]
        n_pix = min(int(self.cell.checks["compare_pixels"]), w * h)
        idx = np.random.default_rng(self.seed).choice(w * h, n_pix, replace=False)
        rows, cols = idx // w, idx % w
        n = self.passes * int(self.traffic["spp_step"])

        def ref_sums():
            ref = reference.Reference(self.arrays, self.camera, self.config, self.device)
            px = torch.as_tensor(cols, device=self.device)
            py = torch.as_tensor(h - 1 - rows, device=self.device)
            return ref.pixel_sums(px, py, n, self.seed)

        return compare.film_numbers(self.film.radiance_sum[rows, cols], self.film.spp_map,
                                    ref_sums, n)


def control_numbers(cell, seed: int, device, variant: str = "bfloat16", samples=None) -> dict:
    """The comparison's numbers of the reference computed in `variant`'s
    dtype against the reference in float32, at the pixels a run of `seed`
    compares, over `samples` samples a pixel. "bfloat16" is the control
    (one precision below the configuration's float32), which must fail;
    "float64" moves every rounding and so sends some paths elsewhere, as a
    sound change of the program's arithmetic may, and must pass."""
    dtypes = {"bfloat16": torch.bfloat16, "float64": torch.float64}
    if variant not in dtypes:
        raise ValueError(f"variant {variant!r}")
    arrays, camera = scene_data.load(cell.config["scene"])
    camera["resolution"] = tuple(cell.config["resolution"])
    w, h = camera["resolution"]
    n_pix = min(int(cell.checks["compare_pixels"]), w * h)
    idx = np.random.default_rng(seed).choice(w * h, n_pix, replace=False)
    rows, cols = idx // w, idx % w
    px = torch.as_tensor(cols, device=device)
    py = torch.as_tensor(h - 1 - rows, device=device)
    sums = {dt: reference.Reference(arrays, camera, cell.config, device, dtype=dt)
            .pixel_sums(px, py, samples, seed) for dt in (torch.float32, dtypes[variant])}
    return compare.film_numbers(sums[dtypes[variant]][0], np.full((h, w), samples),
                                lambda: sums[torch.float32], samples)
