"""Progressive render driver (PyTorch). Counterpart of
pyrenderer_tpu/render/driver.py.

One spp_step-sample pass after another is accumulated into a host Film
until cfg.spp, with samples/s printed every 10 passes,
optional preview PNGs, checkpoints (Film.save/load) and resume, and the
bench.py ray count (live closest-hit rays plus NEE shadow rays).

Adaptive sampling, ``run_resilient`` and the CLI's ``--live`` view are not
ported yet (ROADMAP A6).
"""

from __future__ import annotations

import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from pyrenderer_tpu_torch.config import RenderConfig
from pyrenderer_tpu_torch.core.camera import morton_pixel_order
from pyrenderer_tpu_torch.core.film import Film
from pyrenderer_tpu_torch.core.integrator import TraceTables, render_sample
from pyrenderer_tpu_torch.core.tonemap import tonemap
from pyrenderer_tpu_torch.scene.types import Camera, Scene
from pyrenderer_tpu_torch.utils.image_io import write_hdr, write_png


REPORT_INTERVAL = 10  # passes between samples/s reports


class ProgressiveRenderer:
    """Accumulates spp_step-sample passes into a Film until cfg.spp.

    `scene` and `camera` hold tensors on the device to render on
    (scene.types.to_device); the film lives on the host. The accelerator
    the backend needs (a FlatBVH, a ClusterScene or a ClusterChunks:
    core/integrator.maybe_build_accel) is built unless `accel` gives one,
    and the backend resolved with it, before the first pass."""

    def __init__(
        self,
        scene: Scene,
        camera: Camera,
        cfg: RenderConfig,
        backend: str = "auto",
        film: Optional[Film] = None,
        chunk: int = 1 << 16,
        accel=None,
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
        w, h = camera.resolution
        self.film = film if film is not None else Film.blank(w, h, cfg.seed)
        if film is not None and film.seed != cfg.seed:
            raise ValueError(
                f"resume film was rendered with seed {film.seed}, config has {cfg.seed}"
            )
        # trace in Morton order so each chunk is a compact screen block;
        # results are unpermuted before they land on the film
        ys, xs = np.mgrid[0:h, 0:w]
        self._perm, self._inv_perm = morton_pixel_order(w, h)
        device = scene.vertices.device
        self._px = torch.as_tensor(xs.reshape(-1)[self._perm], device=device)
        self._py = torch.as_tensor(ys.reshape(-1)[self._perm], device=device)
        self._rays = torch.zeros((), dtype=torch.float64, device=device)
        self.render_seconds = 0.0

    @property
    def rays_traced(self) -> float:
        """Rays traced so far, counted as bench.py counts them."""
        return float(self._rays)

    def render_one_pass(self) -> None:
        """One uniform spp_step pass over all pixels."""
        w, h = self.camera.resolution
        first = self.film.next_sample
        sums, sqs = [], []
        for start in range(0, w * h, self.chunk):
            px = self._px[start:start + self.chunk]
            py = self._py[start:start + self.chunk]
            total = sq = 0.0
            for s in range(self.cfg.spp_step):
                r, n_rays = render_sample(
                    self.scene, self.camera, self.cfg, self.cfg.seed, first + s,
                    px, py, tables=self.tables, with_stats=True)
                total = total + r
                sq = sq + r * r
                self._rays += n_rays
            sums.append(total)
            sqs.append(sq)
        img = torch.cat(sums).cpu().numpy()[self._inv_perm].reshape(h, w, 3)[::-1]
        sq = torch.cat(sqs).cpu().numpy()[self._inv_perm].reshape(h, w, 3)[::-1]
        self.film.add_pass(img, sq, self.cfg.spp_step)

    def _hdr(self):
        # float32, as the JAX driver tonemaps (Film.hdr is float64)
        return torch.as_tensor(self.film.hdr, dtype=torch.float32)

    def write_preview(self, path: Optional[str] = None) -> str:
        """Dump the current tonemapped accumulation."""
        path = path or self.cfg.preview_file
        write_png(path, tonemap(self._hdr(), self.cfg.tonemap).numpy())
        return path

    def run(self, checkpoint_path: Optional[str] = None, quiet: bool = False):
        cfg = self.cfg
        start = last_t = time.perf_counter()
        passes = 0
        while self.film.spp < cfg.spp:
            self.render_one_pass()
            passes += 1
            if not quiet and passes % REPORT_INTERVAL == 0:
                dt = time.perf_counter() - last_t
                sps = REPORT_INTERVAL * cfg.spp_step / dt
                print(f"{sps:.2f} samples/s ({self.film.spp}/{cfg.spp} spp)",
                      file=sys.stderr)
                last_t = time.perf_counter()
            if cfg.preview_interval and passes % cfg.preview_interval == 0:
                self.write_preview()
            if (checkpoint_path and cfg.checkpoint_interval
                    and passes % cfg.checkpoint_interval == 0):
                self.film.save(checkpoint_path)
        if checkpoint_path and cfg.checkpoint_interval:
            self.film.save(checkpoint_path)
        self.render_seconds += time.perf_counter() - start
        return self.film

    def write_outputs(self, out_dir: str = ".") -> list:
        written = []
        ldr = tonemap(self._hdr(), self.cfg.tonemap).numpy()
        png = os.path.join(out_dir, self.cfg.output_file)
        write_png(png, ldr)
        written.append(png)
        if self.cfg.hdr_output_file:
            written.append(
                write_hdr(os.path.join(out_dir, self.cfg.hdr_output_file), self.film.hdr)
            )
        return written
