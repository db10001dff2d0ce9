"""Batched ray-triangle intersection in plain PyTorch: the "brute" and
"matmul" backends.

Counterpart of pyrenderer_tpu/core/intersect.py.

``intersect_brute`` is a broadcast (N rays x T triangles)
Moeller-Trumbore test in the reference's operation order
(intersection_taichi.py:69-91), then the closest accepted hit per ray. It
runs on any device and dtype; it is the CPU path of the renderer and the
correctness oracle of the CUDA kernels (kernels/intersect.py).

``intersect_matmul`` is the JAX package's MXU formulation: every
Moeller-Trumbore quantity (det, u*det, v*det, t*det) is at most bilinear in
the ray, f(o, d) = c0 + a.o + b.d + o^T C d, so the rays' features
phi = [1, o, d, o (x) d] (N, 16) times one (16, 4T) coefficient matrix give
every ray-triangle test in one matrix product. The product runs in IEEE
float32 whatever the process has set (TF32 would lose the triple products'
precision and miss hits).
"""

from __future__ import annotations

import contextlib

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


# ---------------------------------------------------------------------------
# The matmul backend: intersection as one matrix product.
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _ieee_fp32():
    """float32 matrix products in IEEE single precision inside the block,
    whatever the process has set (torch.set_float32_matmul_precision
    "high"/"medium", the TF32 flags): the counterpart of JAX's
    Precision.HIGHEST. The flags are restored on the way out."""
    flags = (torch.backends.cuda.matmul, torch.backends.mkldnn.matmul)
    prev = [f.fp32_precision for f in flags]
    for f in flags:
        f.fp32_precision = "ieee"
    try:
        yield
    finally:
        for f, p in zip(flags, prev):
            f.fp32_precision = p


class _IeeeMatmul(torch.autograd.Function):
    """a @ b with the forward and both backward products under _ieee_fp32:
    the backward runs after the caller's block has ended."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        with _ieee_fp32():
            return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        with _ieee_fp32():
            ga = g @ b.T if ctx.needs_input_grad[0] else None
            gb = a.T @ g if ctx.needs_input_grad[1] else None
        return ga, gb


def build_tri_matrix(scene: Scene):
    """Coefficient matrix W: (16, T, 4) of the outputs [det, u*det, v*det,
    t*det], rows ordered as ray_features' columns. The coefficients come
    from evaluating the exact triple products on basis vectors, so W is
    differentiable w.r.t. scene.vertices (no detach, as in the JAX
    package)."""
    v0, e1, e2 = _gather_tris(scene)
    dtype, device = v0.dtype, v0.device

    def quantities(o, d):
        # o, d: (3,) against the (T, 3) triangles -> (T, 4)
        d = d.expand_as(e1)
        c_e1_d = torch.linalg.cross(e1, d, dim=-1)
        det = (c_e1_d * e2).sum(-1)
        s = o[None, :] - v0
        c_s_e2 = torch.linalg.cross(s, e2, dim=-1)
        t_det = -(c_s_e2 * e1).sum(-1)
        u_det = -(c_s_e2 * d).sum(-1)
        v_det = (c_e1_d * s).sum(-1)
        return torch.stack([det, u_det, v_det, t_det], dim=-1)

    zero = torch.zeros(3, dtype=dtype, device=device)
    eye = torch.eye(3, dtype=dtype, device=device)
    c0 = quantities(zero, zero)                                          # (T, 4)
    co = [quantities(eye[i], zero) - c0 for i in range(3)]               # 3 x (T, 4)
    cd = [quantities(zero, eye[j]) - c0 for j in range(3)]
    cod = [quantities(eye[i], eye[j]) - c0 - co[i] - cd[j]
           for i in range(3) for j in range(3)]                          # 9 x (T, 4)
    return torch.stack([c0] + co + cd + cod)                             # (16, T, 4)


def ray_features(ro, rd):
    """phi = [1, o, d, o (x) d] : (N, 16)."""
    n = ro.shape[0]
    od = (ro[:, :, None] * rd[:, None, :]).reshape(n, 9)
    return torch.cat([ro.new_ones((n, 1)), ro, rd, od], dim=1)


def mt_terms_matmul(tri_matrix, ro, rd):
    """All (N, T) Moeller-Trumbore terms (det, t, u, v) from one IEEE
    float32 product (N, 16) @ (16, 4T)."""
    k, n_tris, _ = tri_matrix.shape
    phi = ray_features(ro, rd)
    raw = _IeeeMatmul.apply(phi, tri_matrix.reshape(k, n_tris * 4)).reshape(-1, n_tris, 4)
    det = raw[..., 0]
    f = 1.0 / torch.where(det == 0, 1.0, det)
    return det, raw[..., 3] * f, raw[..., 1] * f, raw[..., 2] * f


def intersect_matmul(scene: Scene, ro, rd, t0, t1, tri_matrix=None):
    """Closest hit through the matmul formulation, the contract of
    intersect_brute (a miss gives t = 0, tri = 0)."""
    if tri_matrix is None:
        tri_matrix = build_tri_matrix(scene)
    det, t, u, v = mt_terms_matmul(tri_matrix, ro, rd)
    t_masked = torch.where(_accept(det, t, u, v, t0, t1), t, torch.inf)
    t_hit, tri = t_masked.min(dim=1)
    hit = torch.isfinite(t_hit)
    return hit, torch.where(hit, t_hit, 0.0), tri.to(torch.int32)


def occluded_matmul(scene: Scene, ro, rd, t0, t1, tri_matrix=None):
    """Any-hit shadow query through the matmul formulation; (N,) bool."""
    if tri_matrix is None:
        tri_matrix = build_tri_matrix(scene)
    det, t, u, v = mt_terms_matmul(tri_matrix, ro, rd)
    return _accept(det, t, u, v, t0, t1).any(dim=1)
