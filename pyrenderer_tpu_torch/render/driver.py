"""Progressive render driver (PyTorch). Counterpart of
pyrenderer_tpu/render/driver.py.

One spp_step-sample pass after another is accumulated into a host Film
until cfg.spp, with samples/s printed every REPORT_INTERVAL passes, an
`on_pass` hook (the CLI's ``--live`` view), optional preview PNGs,
checkpoints (Film.save/load) and resume, and the bench.py ray count (live
closest-hit rays plus NEE shadow rays). With cfg.adaptive (Tungsten's
``adaptive_sampling``) the uniform passes stop at cfg.adaptive_min_spp and
adaptive sweeps add one sample to each pixel whose relative error is above
cfg.adaptive_tolerance, until cfg.spp. ``run_resilient`` retries failed
passes and rejects non-finite ones before the film absorbs them.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from pyrenderer_tpu_torch.config import RenderConfig
from pyrenderer_tpu_torch.core.camera import morton_pixel_order
from pyrenderer_tpu_torch.core.film import Film
from pyrenderer_tpu_torch.core.integrator import TraceTables, render_sample
from pyrenderer_tpu_torch.core.tonemap import tonemap
from pyrenderer_tpu_torch.kernels import film as film_kernel
from pyrenderer_tpu_torch.scene.types import Camera, Scene
from pyrenderer_tpu_torch.utils.checks import assert_all_finite
from pyrenderer_tpu_torch.utils.image_io import write_hdr, write_png
from pyrenderer_tpu_torch.utils.profiling import span


REPORT_INTERVAL = 10  # passes between samples/s reports

def _render_pass(scene, camera, cfg: RenderConfig, tables, first_sample: int,
                 n_samples: int, pixel_x, pixel_y):
    """(sum, sum of squares, rays traced) of `n_samples` sample radiances
    per pixel, on the device, not synchronised. The sums start from the
    first sample's values: kernels/film.write adds them to 0.0, which gives
    the bits of a sum started from 0.0."""
    rays = 0.0
    for s in range(n_samples):
        r, n = render_sample(scene, camera, cfg, cfg.seed, first_sample + s, pixel_x, pixel_y,
                             tables=tables, with_stats=True)
        total, sq = (r, r * r) if s == 0 else (total + r, sq + r * r)
        rays = rays + n
    return total, sq, rays


def _render_pass_ids(scene, camera, cfg: RenderConfig, tables, sample_ids, pixel_x, pixel_y):
    """One sample per pixel with per-pixel sample ids (the adaptive
    sweeps): (radiance, its square, rays traced)."""
    r, n = render_sample(scene, camera, cfg, cfg.seed, sample_ids, pixel_x, pixel_y,
                         tables=tables, with_stats=True)
    return r, r * r, n


class ProgressiveRenderer:
    """Accumulates spp_step-sample passes into a Film until cfg.spp; with
    cfg.adaptive, refines only unconverged pixels past adaptive_min_spp.

    `scene` and `camera` hold tensors on the device to render on
    (scene.types.to_device); the film lives on the host. The accelerator
    the backend needs (a FlatBVH, a ClusterScene or a ClusterChunks:
    core/integrator.maybe_build_accel) is built unless `accel` gives one,
    and the backend resolved with it, before the first pass. `on_pass(r)`
    runs after every pass the film absorbed, uniform or adaptive."""

    def __init__(
        self,
        scene: Scene,
        camera: Camera,
        cfg: RenderConfig,
        backend: str = "auto",
        film: Optional[Film] = None,
        chunk: int = 1 << 16,
        accel=None,
        on_pass: Optional[Callable[["ProgressiveRenderer"], None]] = None,
    ):
        if cfg.resolution is not None:
            camera = camera._replace(resolution=tuple(cfg.resolution))
        self.scene = scene
        self.camera = camera
        self.cfg = cfg
        self.tables = TraceTables(scene, cfg, backend, accel=accel)
        self.backend = self.tables.backend
        self.accel = self.tables.accel
        self.chunk = chunk
        self.on_pass = on_pass
        w, h = camera.resolution
        self.film = film if film is not None else Film.blank(w, h, cfg.seed)
        if film is not None and film.seed != cfg.seed:
            raise ValueError(
                f"resume film was rendered with seed {film.seed}, config has {cfg.seed}"
            )
        self._validate = False
        # pixel coordinates in row-major order from the bottom row (the
        # adaptive sweeps index them); the uniform passes trace them in
        # Morton order so each chunk is a compact screen block, and each
        # chunk's sums land at its pixels' film places in the staging
        # tensor, which reaches the host in one copy a pass
        ys, xs = np.mgrid[0:h, 0:w]
        self._px_np = xs.reshape(-1)
        self._py_np = ys.reshape(-1)
        perm, _ = morton_pixel_order(w, h)
        self.device = scene.vertices.device
        self._px = torch.as_tensor(self._px_np[perm], device=self.device)
        self._py = torch.as_tensor(self._py_np[perm], device=self.device)
        dtype = scene.vertices.dtype
        self._staging = torch.empty((2, h, w, 3), dtype=dtype, device=self.device)
        self._host = torch.empty((2, h, w, 3), dtype=dtype,
                                 pin_memory=self.device.type == "cuda")
        self._rays = torch.zeros((), dtype=torch.float64, device=self.device)
        self.render_seconds = 0.0

    @property
    def rays_traced(self) -> float:
        """Rays of the passes and adaptive chunks the film absorbed, counted
        as bench.py counts them (a pass that failed or was rejected adds
        none)."""
        return float(self._rays)

    def render_one_pass(self) -> None:
        """One uniform spp_step pass over all pixels."""
        with span("pass"):
            rays = 0.0
            for start in range(0, self._px.shape[0], self.chunk):
                px = self._px[start:start + self.chunk]
                py = self._py[start:start + self.chunk]
                with span("chunk"):
                    s, q, n = _render_pass(self.scene, self.camera, self.cfg, self.tables,
                                           self.film.next_sample, self.cfg.spp_step, px, py)
                    film_kernel.write(self._staging, s, q, px, py)
                rays = rays + n
            with span("readback"):
                self._host.copy_(self._staging)
            with span("film"):
                img, sq = self._host.numpy()
                if self._validate:
                    # run_resilient's guard, before the film absorbs the
                    # pass: it can be retried with the same RNG counters
                    assert_all_finite({"radiance": img, "radiance_sq": sq},
                                      f"in the pass at spp {self.film.spp}")
                self.film.add_pass(img, sq, self.cfg.spp_step)
            self._rays += rays

    def refine_adaptive(self, quiet: bool = False) -> int:
        """One adaptive sweep: render one extra sample for every pixel whose
        relative error exceeds cfg.adaptive_tolerance, up to cfg.spp; each
        pixel's sample id is its count so far (film.spp_map). Returns the
        number of refined pixels."""
        with span("pass"):
            h = self.camera.resolution[1]
            err = self.film.relative_error()
            active = (err > self.cfg.adaptive_tolerance) & (self.film.spp_map < self.cfg.spp)
            idx = np.nonzero(active[::-1].reshape(-1))[0]  # flip back to y-up order
            if idx.size == 0:
                return 0
            for start in range(0, idx.size, self.chunk):
                # the JAX driver pads each chunk to a power of two (at least
                # 4096) to bound the TPU's compiles and cuts the results at
                # [:k]; no output depends on the padding, so it is left out
                part = idx[start:start + self.chunk]
                rows = h - 1 - self._py_np[part]
                cols = self._px_np[part]
                ids = torch.as_tensor(self.film.spp_map[rows, cols].astype(np.int64),
                                      device=self.device)
                px = torch.as_tensor(self._px_np[part], device=self.device)
                py = torch.as_tensor(self._py_np[part], device=self.device)
                with span("chunk"):
                    r, q, n = _render_pass_ids(self.scene, self.camera, self.cfg, self.tables,
                                               ids, px, py)
                with span("readback"):
                    r, q = r.cpu().numpy(), q.cpu().numpy()
                with span("film"):
                    if self._validate:
                        assert_all_finite({"radiance": r, "radiance_sq": q},
                                          "in an adaptive chunk")
                    self.film.add_pixels(rows, cols, r, q)
                self._rays += n
        if not quiet:
            print(f"adaptive: refined {idx.size} pixels", file=sys.stderr)
        return int(idx.size)

    def ldr(self) -> np.ndarray:
        """The film's mean radiance tonemapped with cfg.tonemap, (H, W, 3)
        in [0, 1]; tonemapped in float32, as the JAX driver does (Film.hdr
        is float64)."""
        return tonemap(torch.as_tensor(self.film.hdr, dtype=torch.float32),
                       self.cfg.tonemap).numpy()

    def write_preview(self, path: Optional[str] = None) -> str:
        """Dump the current tonemapped accumulation."""
        path = path or self.cfg.preview_file
        write_png(path, self.ldr())
        return path

    def _checkpoint(self, checkpoint_path, passes: int) -> None:
        if (checkpoint_path and self.cfg.checkpoint_interval
                and passes % self.cfg.checkpoint_interval == 0):
            self.film.save(checkpoint_path)

    def run(self, checkpoint_path: Optional[str] = None, quiet: bool = False):
        """Uniform passes up to cfg.spp (cfg.adaptive_min_spp with
        cfg.adaptive), then adaptive sweeps until none refines a pixel.
        render_seconds adds this call's wall, also when a pass raises."""
        cfg = self.cfg
        start = last_t = time.perf_counter()
        passes = 0
        uniform_target = min(cfg.adaptive_min_spp, cfg.spp) if cfg.adaptive else cfg.spp
        try:
            while self.film.spp < uniform_target:
                self.render_one_pass()
                passes += 1
                if not quiet and passes % REPORT_INTERVAL == 0:
                    dt = time.perf_counter() - last_t
                    sps = REPORT_INTERVAL * cfg.spp_step / dt
                    print(f"{sps:.2f} samples/s ({self.film.spp}/{cfg.spp} spp)",
                          file=sys.stderr)
                    last_t = time.perf_counter()
                if self.on_pass:
                    self.on_pass(self)
                if cfg.preview_interval and passes % cfg.preview_interval == 0:
                    self.write_preview()
                self._checkpoint(checkpoint_path, passes)
            if cfg.adaptive:
                while self.refine_adaptive(quiet=quiet):
                    passes += 1
                    if self.on_pass:
                        self.on_pass(self)
                    self._checkpoint(checkpoint_path, passes)
            if checkpoint_path and cfg.checkpoint_interval:
                self.film.save(checkpoint_path)
        finally:
            self.render_seconds += time.perf_counter() - start
        return self.film

    def run_resilient(
        self,
        checkpoint_path: Optional[str] = None,
        max_retries: int = 3,
        backoff: float = 2.0,
        quiet: bool = False,
    ):
        """run() with failure detection and retries.

        - A pass that raises (a failed launch, a lost device, anything but
          KeyboardInterrupt) is retried: the film only advances when a
          pass completes, so the retry starts at the exact pass that failed
          with the same RNG counters, and the final image is bit-identical
          to an uninterrupted render. Retries back off exponentially from
          `backoff` seconds; a checkpoint_path also lets a fresh process
          resume (Film.load) if this one dies outright.
        - Every pass and adaptive chunk is checked for non-finite values
          before the film absorbs it; a bad one raises and is retried, and
          a deterministic NaN source (the RNG is counter-based) fails
          after max_retries instead of poisoning the accumulation.

        max_retries bounds consecutive failures: any progress since the
        last failure (samples absorbed, film.spp_map.sum()) resets the
        count and the backoff.
        """
        attempts = 0
        cur_backoff = backoff
        last_progress = -1
        self._validate = True
        try:
            while True:
                try:
                    return self.run(checkpoint_path=checkpoint_path, quiet=quiet)
                except Exception as e:  # noqa: BLE001 -- any pass failure is retried
                    progress = int(self.film.spp_map.sum())
                    if progress > last_progress:
                        attempts = 0
                        cur_backoff = backoff
                        last_progress = progress
                    attempts += 1
                    if attempts > max_retries:
                        raise
                    if not quiet:
                        print(f"pass failed ({e!r}); retry {attempts}/{max_retries} in "
                              f"{cur_backoff:.0f}s from spp {self.film.spp}", file=sys.stderr)
                    time.sleep(cur_backoff)
                    cur_backoff *= 2.0
        finally:
            self._validate = False

    def write_outputs(self, out_dir: str = ".") -> list:
        written = []
        png = os.path.join(out_dir, self.cfg.output_file)
        write_png(png, self.ldr())
        written.append(png)
        if self.cfg.hdr_output_file:
            written.append(
                write_hdr(os.path.join(out_dir, self.cfg.hdr_output_file), self.film.hdr)
            )
        return written
