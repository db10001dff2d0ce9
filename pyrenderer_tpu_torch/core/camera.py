"""Batched primary-ray generation (PyTorch) and trace-order permutations.

Counterpart of pyrenderer_tpu/core/camera.py, reproducing the reference CPU
camera (core/camera.py:41-72 generate_ray): sensor plane at ``focal_dist``
along -z in camera space, ``sensor_height = tan(fov/2) * focal_dist``,
square-aperture jitter on the ray origin, and the row-vector world
transform ``homogeneous(v) @ iview``.

The 3x3 transforms are written out as broadcast products and sums, not as
a matmul, so no TF32 or library kernel choice can touch ray directions.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pyrenderer_tpu_torch import rng
from pyrenderer_tpu_torch.scene.types import Camera
from pyrenderer_tpu_torch.utils.profiling import span


def _row_transform(v, m):
    """v (N, 3) @ m (3, 3), summed left to right."""
    return v[:, 0:1] * m[0] + v[:, 1:2] * m[1] + v[:, 2:3] * m[2]


def generate_rays(camera: Camera, pixel_x, pixel_y, sample_id, seed: int,
                  strata: int = 0):
    """Primary rays for pixel coords (x right, y up from the bottom).

    pixel_x, pixel_y: (N,) integer tensors on the camera's device;
    sample_id: int or (N,) integer tensor. strata > 1 enables stratified
    (jittered-grid) pixel sampling over a strata x strata grid walked by
    sample_id. Returns (ro, rd): (N, 3) tensors in the camera's dtype.
    """
    with span("camera"):
        w, h = camera.resolution
        dtype = camera.iview.dtype
        pixel_id = pixel_y.to(torch.int64) * w + pixel_x.to(torch.int64)

        jx, jy = rng.uniform2(seed, pixel_id, sample_id, rng.CAMERA_BOUNCE, rng.U_PIXEL_X, dtype)
        if strata > 1:
            sample = sample_id.to(torch.int64) if torch.is_tensor(sample_id) else sample_id
            stratum = (sample & 0xFFFFFFFF) % (strata * strata)
            sx = stratum % strata
            sy = stratum // strata
            if torch.is_tensor(stratum):
                sx, sy = sx.to(dtype), sy.to(dtype)
            jx = (sx + jx) / strata
            jy = (sy + jy) / strata
        u = (pixel_x.to(dtype) + jx) / w
        v = (pixel_y.to(dtype) + jy) / h

        fov = camera.fov_deg * (math.pi / 180.0)
        sensor_h = torch.tan(fov / 2) * camera.focal_dist
        sensor_w = sensor_h * (w / h)

        cx = u - 0.5
        cy = v - 0.5
        d_cam = torch.stack(
            [
                cx * sensor_w * 2.0,
                cy * sensor_h * 2.0,
                -camera.focal_dist * torch.ones_like(cx),
            ],
            dim=-1,
        )

        lx, ly = rng.uniform2(seed, pixel_id, sample_id, rng.CAMERA_BOUNCE, rng.U_LENS_X, dtype)
        ap = camera.aperture
        o_cam = torch.stack(
            [
                torch.where(ap > 0, ap * lx - ap / 2, 0.0),
                torch.where(ap > 0, ap * ly - ap / 2, 0.0),
                torch.zeros_like(lx),
            ],
            dim=-1,
        )

        rot = camera.iview[:3, :3]  # row-vector: world = cam_vec @ iview
        trans = camera.iview[3, :3]
        rd = _row_transform(d_cam - o_cam, rot)
        rd = rd / torch.sqrt(torch.sum(rd * rd, dim=-1, keepdim=True))
        ro = _row_transform(o_cam, rot) + trans
        return ro, rd


def morton_pixel_order(w: int, h: int):
    """Permutation putting flattened row-major pixels into Morton (Z-curve)
    order, and its inverse (NumPy, host side, once per resolution).

    A Morton chunk of rays is a compact screen block; the order is
    invisible to the estimator (the RNG is keyed on pixel id).

    Returns (perm, inv_perm), both (w*h,) int64 with
    flat_morton = flat_row_major[perm] and flat_row_major = flat_morton[inv_perm].
    """
    ys, xs = np.mgrid[0:h, 0:w]
    xs = xs.reshape(-1).astype(np.uint64)
    ys = ys.reshape(-1).astype(np.uint64)

    def spread(v):
        v = (v | (v << 16)) & np.uint64(0x0000FFFF0000FFFF)
        v = (v | (v << 8)) & np.uint64(0x00FF00FF00FF00FF)
        v = (v | (v << 4)) & np.uint64(0x0F0F0F0F0F0F0F0F)
        v = (v | (v << 2)) & np.uint64(0x3333333333333333)
        v = (v | (v << 1)) & np.uint64(0x5555555555555555)
        return v

    code = (spread(xs) << np.uint64(1)) | spread(ys)
    perm = np.argsort(code, kind="stable")
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    return perm, inv


def hilbert_pixel_order(w: int, h: int):
    """Row-major -> Hilbert-curve pixel permutation (and inverse).

    Consecutive Hilbert cells are always screen-adjacent. Vectorized xy->d
    (bitwise rotate/reflect per level) on the next-pow2 square; arbitrary
    w x h handled by argsort of the valid cells' indices."""
    n = 1 << int(np.ceil(np.log2(max(w, h, 2))))
    ys, xs = np.mgrid[0:h, 0:w]
    x = xs.reshape(-1).astype(np.int64)
    y = ys.reshape(-1).astype(np.int64)
    d = np.zeros(x.size, np.int64)
    s = n // 2
    while s > 0:
        rx = ((x & s) > 0).astype(np.int64)
        ry = ((y & s) > 0).astype(np.int64)
        d += s * s * ((3 * rx) ^ ry)
        refl = (ry == 0) & (rx == 1)
        x_r = np.where(refl, s - 1 - (x & (s - 1)), x & (s - 1))
        y_r = np.where(refl, s - 1 - (y & (s - 1)), y & (s - 1))
        swap = ry == 0
        x, y = np.where(swap, y_r, x_r), np.where(swap, x_r, y_r)
        s //= 2
    perm = np.argsort(d, kind="stable")
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    return perm, inv


def pixel_order(w: int, h: int, kind: str = "morton"):
    """Trace-order permutation selector ("morton" default, "hilbert",
    "row" = identity)."""
    if kind == "hilbert":
        return hilbert_pixel_order(w, h)
    if kind == "row":
        ident = np.arange(w * h)
        return ident, ident.copy()
    if kind != "morton":
        raise ValueError(f"unknown pixel order {kind!r} "
                         "(expected 'morton', 'hilbert', or 'row')")
    return morton_pixel_order(w, h)
