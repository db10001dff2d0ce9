"""Watertight ray-triangle intersection (PBRT shear formulation), batched.

Counterpart of pyrenderer_tpu/core/watertight.py, operation for operation
(reference mathematics/intersection_taichi.py:94-161, ray_triangle_hit2):
translate to the ray origin, permute so the dominant ray axis is z, shear
to align the ray with +z, compute 2D edge functions, and reject only when
the edge signs are mixed -- shared edges and vertices then never leak rays.

Where an edge function cancels to less than ~2 ulp of its products, it is
recomputed as a compensated difference of products (Dekker two-products,
pure float32) instead of the reference's float64 fallback. The CUDA leaf of
csrc/cluster.cu evaluates the same expressions in the same order, built
with -fmad=false, so no a*b - c*d is contracted into an FMA there either.

Every sum of three terms is written out left to right, so the twin's
association is fixed and equals the kernel's.
"""

from __future__ import annotations

import torch

_SPLIT = 4097.0  # 2^12 + 1 for f32 Dekker splitting (24-bit mantissa)

# Fallback trigger: |a*b - c*d| <= (|a*b| + |c*d|) * 2^-22 -- a relative
# threshold rather than e == 0, whose firing depends on whether the
# compiler contracted the product difference (see the JAX module).
_EDGE_REL_TOL = 2.0 ** -22


def _two_product_err(a, b):
    """Error of the rounded product: fl(a*b) + err == a*b exactly."""
    p = a * b
    ah = a * _SPLIT
    ah = ah - (ah - a)
    al = a - ah
    bh = b * _SPLIT
    bh = bh - (bh - b)
    bl = b - bh
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def diff_of_products(a, b, c, d):
    """a*b - c*d with a compensated correction term (correct sign even when
    the naive f32 result cancels to 0)."""
    p1, e1 = _two_product_err(a, b)
    p2, e2 = _two_product_err(c, d)
    return (p1 - p2) + (e1 - e2)


def edge_fn(a, b, c, d):
    """Watertight 2D edge function a*b - c*d: fast product difference,
    compensated (diff_of_products) wherever cancellation leaves less than
    ~2 ulp of signal (_EDGE_REL_TOL)."""
    p1 = a * b
    p2 = c * d
    e = p1 - p2
    thr = (p1.abs() + p2.abs()) * _EDGE_REL_TOL
    return torch.where(e.abs() <= thr, diff_of_products(a, b, c, d), e)


def _permute(v, kx, ky, kz):
    """Gather-free axis permutation for (..., 3) with per-element indices."""
    def pick(k):
        return torch.where(
            k[..., None] == 0,
            v[..., 0:1],
            torch.where(k[..., None] == 1, v[..., 1:2], v[..., 2:3]),
        )[..., 0]

    return torch.stack([pick(kx), pick(ky), pick(kz)], dim=-1)


def watertight_terms(v0, v1, v2, ro, rd):
    """Broadcast watertight test terms for (N rays x T triangles).

    v0/v1/v2: (T, 3); ro/rd: (N, 3). Returns (valid_geom (N,T), t (N,T)) --
    `valid_geom` is the sign test only; range conditions (t0 < t < t1) are
    the caller's.
    """
    kz = torch.argmax(rd.abs(), dim=-1)   # (N,), the first maximum on ties
    kx = (kz + 1) % 3
    ky = (kx + 1) % 3
    d = _permute(rd, kx, ky, kz)          # (N, 3)

    sx = -d[:, 0] / d[:, 2]
    sy = -d[:, 1] / d[:, 2]
    sz = 1.0 / d[:, 2]

    def shear(p):  # p: (T, 3) -> (N, T) permuted+sheared components
        pt = p[None, :, :] - ro[:, None, :]
        shape = pt.shape[:2]
        pt = _permute(pt, kx[:, None].expand(shape), ky[:, None].expand(shape),
                      kz[:, None].expand(shape))
        x = pt[..., 0] + sx[:, None] * pt[..., 2]
        y = pt[..., 1] + sy[:, None] * pt[..., 2]
        return x, y, pt[..., 2]

    x0, y0, z0 = shear(v0)
    x1, y1, z1 = shear(v1)
    x2, y2, z2 = shear(v2)

    e0 = edge_fn(x1, y2, y1, x2)
    e1 = edge_fn(x2, y0, y2, x0)
    e2 = edge_fn(x0, y1, y0, x1)

    mixed = ((e0 < 0) | (e1 < 0) | (e2 < 0)) & ((e0 > 0) | (e1 > 0) | (e2 > 0))
    det = e0 + e1 + e2
    szc = sz[:, None]
    t_scaled = e0 * (z0 * szc) + e1 * (z1 * szc) + e2 * (z2 * szc)
    t = t_scaled / torch.where(det == 0, 1.0, det)
    valid = (~mixed) & (det.abs() > 0)
    return valid, t


def _terms(scene, ro, rd, t0, t1):
    v = scene.vertices
    f = scene.faces
    valid, t = watertight_terms(v[f[:, 0]], v[f[:, 1]], v[f[:, 2]], ro, rd)
    if torch.is_tensor(t1) and t1.dim() == 1:
        t1 = t1[:, None]
    return valid & (t > t0) & (t < t1), t


def intersect_watertight(scene, ro, rd, t0, t1):
    """Closest hit over all triangles with the watertight test: (hit, t,
    tri), the contract of core.intersect.intersect_brute (tri = 0 and
    t = 0 on a miss, ties to the lowest face). Backend "watertight"."""
    ok, t = _terms(scene, ro, rd, t0, t1)
    t_hit, tri = torch.where(ok, t, torch.inf).min(dim=1)
    hit = torch.isfinite(t_hit)
    return hit, torch.where(hit, t_hit, 0.0), tri.to(torch.int32)


def occluded_watertight(scene, ro, rd, t0, t1):
    """Any-hit twin of intersect_watertight (shadow rays)."""
    ok, _ = _terms(scene, ro, rd, t0, t1)
    return ok.any(dim=1)
