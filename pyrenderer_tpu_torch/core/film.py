"""Film: progressive accumulation state with checkpoint/resume and
per-pixel statistics for adaptive sampling.

The reference's checkpointable state is (HDR radiance sum, spp count)
dumped as hdr.npy/spp.npy (reference main_taichi.py:119-123, consumed by
tone_map.py:5-6) — but the dump is commented out and Tungsten's
resume_render/adaptive_sampling fields in scene.json are ignored (SURVEY
§5.4, §5.6). Here both are first-class: accumulation is associative, so a
checkpoint is exactly (radiance_sum, sq_sum, spp_map, next_sample, seed)
and resuming keeps adding; the squared sums give the per-pixel variance
that drives adaptive sample allocation.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Film:
    radiance_sum: np.ndarray   # (H, W, 3) float32 — sum over samples
    sq_sum: np.ndarray         # (H, W, 3) float32 — sum of squared samples
    spp_map: np.ndarray        # (H, W) int32 — samples accumulated per pixel
    seed: int                  # RNG seed the accumulation was made with
    next_sample: int           # next sample_id for uniform (non-adaptive) passes

    @classmethod
    def blank(cls, width: int, height: int, seed: int) -> "Film":
        return cls(
            radiance_sum=np.zeros((height, width, 3), np.float32),
            sq_sum=np.zeros((height, width, 3), np.float32),
            spp_map=np.zeros((height, width), np.int32),
            seed=seed,
            next_sample=0,
        )

    @property
    def spp(self) -> int:
        """Minimum samples over all pixels (the 'guaranteed' spp)."""
        return int(self.spp_map.min()) if self.spp_map.size else 0

    def add_pass(self, radiance_sum, sq_sum, n_samples: int = 1) -> None:
        """Accumulate a full-frame pass: summed radiance and squares (H, W, 3)."""
        self.radiance_sum += np.asarray(radiance_sum, np.float32)
        self.sq_sum += np.asarray(sq_sum, np.float32)
        self.spp_map += n_samples
        self.next_sample += n_samples

    def add_pixels(self, rows, cols, radiance, sq) -> None:
        """Accumulate one sample for a subset of pixels (adaptive passes).
        rows/cols: (K,) indices; radiance/sq: (K, 3)."""
        np.add.at(self.radiance_sum, (rows, cols), np.asarray(radiance, np.float32))
        np.add.at(self.sq_sum, (rows, cols), np.asarray(sq, np.float32))
        np.add.at(self.spp_map, (rows, cols), 1)

    @property
    def hdr(self) -> np.ndarray:
        """Mean radiance."""
        return self.radiance_sum / np.maximum(self.spp_map, 1)[..., None]

    def relative_error(self) -> np.ndarray:
        """(H, W) per-pixel relative standard error of the mean (luminance),
        the adaptive-sampling criterion."""
        n = np.maximum(self.spp_map, 1)[..., None]
        mean = self.radiance_sum / n
        var = np.maximum(self.sq_sum / n - mean**2, 0.0) / n
        lum_w = np.array([0.2126, 0.7152, 0.0722], np.float32)
        se = np.sqrt(var @ lum_w**2)
        lum = np.maximum(mean @ lum_w, 1e-3)
        return se / lum

    def save(self, path: str) -> None:
        np.savez(
            path,
            radiance_sum=self.radiance_sum,
            sq_sum=self.sq_sum,
            spp_map=self.spp_map,
            spp=self.spp,  # convenience/back-compat
            seed=self.seed,
            next_sample=self.next_sample,
        )

    @classmethod
    def load(cls, path: str) -> "Film":
        with np.load(path) as data:
            return cls(
                radiance_sum=data["radiance_sum"],
                sq_sum=data["sq_sum"],
                spp_map=data["spp_map"],
                seed=int(data["seed"]),
                next_sample=int(data["next_sample"]),
            )
