"""Batched ray-triangle intersection in plain PyTorch (the "brute" backend).

Counterpart of pyrenderer_tpu/core/intersect.py:74-107: a broadcast
(N rays x T triangles) Moeller-Trumbore test in the reference's operation
order (intersection_taichi.py:69-91), then the closest accepted hit per
ray. It runs on any device and dtype; it is the CPU path of the renderer
and the correctness oracle of the CUDA kernels (kernels/intersect.py).

The MXU bilinear-form backend (``intersect_matmul``) is not ported yet.
"""

from __future__ import annotations

import torch

from pyrenderer_tpu_torch.scene.types import Scene


def _gather_tris(scene: Scene):
    v = scene.vertices
    f = scene.faces
    v0 = v[f[:, 0]]
    return v0, v[f[:, 1]] - v0, v[f[:, 2]] - v0  # v0, e1, e2


def _mt_terms(v0, e1, e2, ro, rd):
    """(det, t, u, v), each (N, T), component by component in the order of
    the TPU kernel's _mt_test (pallas_intersect.py:39-77): c = e1 x d,
    det = c.e2, s = o - v0, q = s x e2, t = -inv q.e1, u = -inv q.d,
    v = inv c.s, every dot product summed left to right."""
    dx, dy, dz = (rd[:, k:k + 1] for k in range(3))       # (N, 1)
    ox, oy, oz = (ro[:, k:k + 1] for k in range(3))
    v0x, v0y, v0z = v0[:, 0], v0[:, 1], v0[:, 2]          # (T,)
    e1x, e1y, e1z = e1[:, 0], e1[:, 1], e1[:, 2]
    e2x, e2y, e2z = e2[:, 0], e2[:, 1], e2[:, 2]
    cx = e1y * dz - e1z * dy
    cy = e1z * dx - e1x * dz
    cz = e1x * dy - e1y * dx
    det = cx * e2x + cy * e2y + cz * e2z
    inv = 1.0 / torch.where(det == 0, 1.0, det)
    sx = ox - v0x
    sy = oy - v0y
    sz = oz - v0z
    qx = sy * e2z - sz * e2y
    qy = sz * e2x - sx * e2z
    qz = sx * e2y - sy * e2x
    t = -inv * (qx * e1x + qy * e1y + qz * e1z)
    u = -inv * (qx * dx + qy * dy + qz * dz)
    v = inv * (cx * sx + cy * sy + cz * sz)
    return det, t, u, v


def _accept(det, t, u, v, t0, t1):
    if torch.is_tensor(t1) and t1.dim() == 1:
        t1 = t1[:, None]
    return (
        (det.abs() > 0)
        & (t > t0)
        & (t < t1)
        & (u >= 0)
        & (u <= 1)
        & (v >= 0)
        & (1.0 - u - v >= 0)
    )


def intersect_brute_arrays(v0, e1, e2, ro, rd, t0, t1):
    """Closest hit over raw (T, 3) triangle arrays (v0, e1 = v1 - v0,
    e2 = v2 - v0). Returns (hit (N,) bool, t (N,), tri (N,) int32).

    A miss gives t = 0 and tri = argmin of an all-inf row, i.e. 0 (the
    brute contract; the kernels return -1). Ties resolve to the lowest
    face index: argmin returns the first minimum."""
    det, t, u, v = _mt_terms(v0, e1, e2, ro, rd)
    t_masked = torch.where(_accept(det, t, u, v, t0, t1), t, torch.inf)
    t_hit, tri = t_masked.min(dim=1)
    hit = torch.isfinite(t_hit)
    return hit, torch.where(hit, t_hit, 0.0), tri.to(torch.int32)


def occluded_arrays(v0, e1, e2, ro, rd, t0, t1):
    """Any-hit shadow query over raw triangle arrays; (N,) bool."""
    det, t, u, v = _mt_terms(v0, e1, e2, ro, rd)
    return _accept(det, t, u, v, t0, t1).any(dim=1)


def intersect_brute(scene: Scene, ro, rd, t0, t1):
    """Closest hit over all triangles: (hit, t, tri), ties to the lowest
    face (the reference's sequential strict-less-than scan)."""
    return intersect_brute_arrays(*_gather_tris(scene), ro, rd, t0, t1)


def occluded(scene: Scene, ro, rd, t0, t1):
    """Any-hit shadow query, t1 scalar or per ray."""
    return occluded_arrays(*_gather_tris(scene), ro, rd, t0, t1)
