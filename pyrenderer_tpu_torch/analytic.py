"""Analytic-primitive path tracer: spheres, planes, oriented AABBs (PyTorch).

Counterpart of pyrenderer_tpu/analytic.py, with the same functions in the
same order: the standalone analytic renderer of the reference
(taichi_ref.py, a single self-contained file outside the Tungsten scene
pipeline), as one wavefront program:

  - analytic intersectors: quadratic sphere with the reference's two-step
    root refinement (taichi_ref.py:108-142), plane (:145-153), slab AABB
    with entry-face normal (:156-190) and its transformed variant
    (:193-210);
  - the hardcoded Cornell-like scene: glass sphere, rotated specular box,
    five planes, area light (:220-287 intersect_scene; the scene constants
    are data shared with the reference and with the JAX package);
  - MIS direct lighting: area-light sample + BRDF sample combined with the
    power heuristic (:368-397), visibility by re-intersection;
  - lambert / specular / glass materials with Schlick reflectance and the
    reference's branch structure (:400-434), as masked selects;
  - 5x5 stratified pixel sampling (:437-454) on the counter RNG (rng.py).

Everything is batched over rays (N, ...) with masks for divergence and
computes on the device of its input tensors; camera_rays and render, which
take none, are told their device. It is plain PyTorch: the JAX module runs
no Pallas kernel either. The bounce loop is a Python loop (the JAX
module's lax.scan) and render sums its samples in order (the JAX module's
lax.map and .sum(0), whose float32 sum may run in another order).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from pyrenderer_tpu_torch import rng
from pyrenderer_tpu_torch.core import sampling
from pyrenderer_tpu_torch.core.bsdf import power_heuristic, reflect, schlick

INF = 1e10
EPS = 1e-4

MAT_NONE, MAT_LAMBERT, MAT_SPECULAR, MAT_GLASS, MAT_LIGHT = 0, 1, 2, 3, 4

# --- scene constants (data shared with taichi_ref.py:18-70) ---------------
CAMERA_POS = (0.0, 0.6, 3.0)
FOV = 0.8
MAX_DEPTH = 10
LIGHT_Y = 2.0 - EPS
LIGHT_X_MIN, LIGHT_X_RANGE = -0.25, 0.5
LIGHT_Z_MIN, LIGHT_Z_RANGE = 1.0, 0.12
LIGHT_AREA = LIGHT_X_RANGE * LIGHT_Z_RANGE
LIGHT_MIN = (LIGHT_X_MIN, LIGHT_Y, LIGHT_Z_MIN)
LIGHT_MAX = (LIGHT_X_MIN + LIGHT_X_RANGE, LIGHT_Y, LIGHT_Z_MIN + LIGHT_Z_RANGE)
LIGHT_COLOR = (0.9, 0.85, 0.7)
LIGHT_NORMAL = (0.0, -1.0, 0.0)
REFR_IDX = 2.4
SP1_CENTER = (0.4, 0.225, 1.75)
SP1_RADIUS = 0.22
BOX_MIN = (0.0, 0.0, 0.0)
BOX_MAX = (0.55, 1.1, 0.55)
STRATIFY = 5


def _box_transforms():
    # inverted in float64 NumPy and only then cast to float32, as the JAX
    # module does, so that the box's constants are bit-identical to its
    rad = np.pi / 8.0
    c, s = np.cos(rad), np.sin(rad)
    rot = np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]])
    translate = np.eye(4)
    translate[:3, 3] = [-0.7, 0.0, 0.7]
    m = translate @ rot
    m_inv = np.linalg.inv(m)
    return m_inv.astype(np.float32), m_inv.T.astype(np.float32)


_BOX_M_INV, _BOX_M_INV_T = _box_transforms()


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


@functools.lru_cache(maxsize=None)
def _vec_on(values, device, dtype):
    return torch.tensor(values, dtype=dtype, device=device)


def _vec(values, like):
    """A constant vector on `like`'s device and dtype, made once per device:
    a host-to-device copy on every call would make the host wait."""
    return _vec_on(tuple(float(v) for v in values), like.device, like.dtype)


def _affine(v, m, translate: bool):
    """v (N, 3) @ m[:3, :3].T (+ m[:3, 3]) for a float32 NumPy matrix m,
    as multiply-adds with its entries as scalars. Not torch.matmul: under
    torch.set_float32_matmul_precision("high") a CUDA matmul rounds its
    inputs to TF32, and the box's hits and normals would then hang on a
    global flag."""
    cols = []
    for j in range(3):
        r = float(m[j, 0]), float(m[j, 1]), float(m[j, 2])
        c = v[:, 0] * r[0] + v[:, 1] * r[1] + v[:, 2] * r[2]
        cols.append(c + float(m[j, 3]) if translate else c)
    return torch.stack(cols, dim=1)


# --- analytic intersectors (vectorized over rays) -------------------------


def intersect_sphere(ro, rd, center, radius):
    """Quadratic sphere test with the reference's refinement step: advance
    to the first root, re-solve from there, accept only a positive forward
    root (taichi_ref.py:108-142). Returns (t, hit_pos); t = INF on miss."""
    center = _vec(center, ro)
    t_vec = ro - center
    b = 2.0 * _dot(t_vec, rd)
    c = _dot(t_vec, t_vec) - radius * radius
    delta = b * b - 4.0 * c
    near_ok = delta > -1e-4
    sdelta = torch.sqrt(torch.clamp(delta, min=0.0))
    dist0 = 0.5 * (-b - sdelta)

    # refinement from the advanced position
    new_pos = ro + rd * dist0[:, None]
    t2 = new_pos - center
    b2 = 2.0 * _dot(t2, rd)
    c2 = _dot(t2, t2) - radius * radius
    delta2 = b2 * b2 - 4.0 * c2
    ok2 = delta2 > 0
    sdelta2 = torch.sqrt(torch.clamp(delta2, min=0.0))
    ret = 0.5 * (-b2 - sdelta2) + dist0
    hit = near_ok & ok2 & (ret > 0)
    t = torch.where(hit, ret, INF)
    hit_pos = new_pos + (0.5 * (-b2 - sdelta2))[:, None] * rd
    return t, hit_pos


def intersect_plane(ro, rd, point, normal):
    """Infinite plane (taichi_ref.py:145-153). Returns t (INF on miss)."""
    point = _vec(point, ro)
    normal = _vec(normal, ro)
    denom = _dot(rd, normal)
    t = torch.where(denom.abs() > EPS, _dot(point - ro, normal) / denom, INF)
    return torch.where(t > 0, t, INF)


def intersect_aabb(ro, rd, bmin, bmax):
    """Axis-aligned slab test returning the ENTRY face normal
    (taichi_ref.py:156-190). Returns (hit, t_near, t_far, normal)."""
    bmin = _vec(bmin, ro)
    bmax = _vec(bmax, ro)
    safe_d = torch.where(rd == 0, 1e-20, rd)
    i1 = (bmin - ro) / safe_d
    i2 = (bmax - ro) / safe_d
    near = torch.minimum(i1, i2)
    far = torch.maximum(i1, i2)
    # degenerate axes: ray parallel and origin outside the slab -> miss
    outside = (rd == 0) & ((ro < bmin) | (ro > bmax))
    near_t = near.amax(dim=-1)
    far_t = far.amin(dim=-1)
    # torch.argmax takes the first of equal maxima, as jnp.argmax does
    axis = near.argmax(dim=-1)
    near_is_max = torch.gather(i2 < i1, 1, axis[:, None])[:, 0]
    hit = (near_t <= far_t) & ~outside.any(dim=-1)
    sign = torch.where(near_is_max, 1.0, -1.0).to(ro.dtype)
    one_hot = axis[:, None] == torch.arange(3, device=ro.device)
    normal = one_hot.to(ro.dtype) * sign[:, None]
    return hit, near_t, far_t, normal


def intersect_aabb_transformed(ro, rd, bmin, bmax, m_inv, m_inv_t):
    """Oriented box: intersect in local space, normal back via the inverse
    transpose (taichi_ref.py:193-210). m_inv and m_inv_t are (4, 4) NumPy
    arrays (_BOX_M_INV, _BOX_M_INV_T)."""
    o_l = _affine(ro, m_inv, translate=True)
    d_l = _affine(rd, m_inv, translate=False)
    hit, t, _, n_l = intersect_aabb(o_l, d_l, bmin, bmax)
    hit = hit & (t > 0)
    n_w = _affine(n_l, m_inv_t, translate=False)
    return hit, torch.where(hit, t, INF), n_w


def intersect_light(ro, rd, tmax):
    hit, t, _, _ = intersect_aabb(ro, rd, LIGHT_MIN, LIGHT_MAX)
    ok = hit & (t > 0) & (t < tmax)
    return ok, torch.where(ok, t, INF)


def intersect_scene(ro, rd):
    """Closest hit over the hardcoded scene (taichi_ref.py:222-287).

    Returns (t, normal, color, mat), all (N, ...) tensors; mat is int32.
    """
    n = ro.shape[0]
    closest = torch.full((n,), INF, dtype=ro.dtype, device=ro.device)
    normal = torch.zeros_like(ro)
    color = torch.zeros_like(ro)
    mat = torch.full((n,), MAT_NONE, dtype=torch.int32, device=ro.device)

    def take(t_new, n_new, c_new, m_new, cond):
        nonlocal closest, normal, color, mat
        better = cond & (t_new > 0) & (t_new < closest)
        closest = torch.where(better, t_new, closest)
        normal = torch.where(better[:, None], n_new, normal)
        color = torch.where(better[:, None], _vec(c_new, ro), color)
        mat = torch.where(better, m_new, mat)

    # glass sphere
    t, hp = intersect_sphere(ro, rd, SP1_CENTER, SP1_RADIUS)
    sn = sampling.safe_normalize(hp - _vec(SP1_CENTER, ro))
    take(t, sn, (1.0, 1.0, 1.0), MAT_GLASS, t < INF)
    # rotated specular box
    bh, bt, bn = intersect_aabb_transformed(
        ro, rd, BOX_MIN, BOX_MAX, _BOX_M_INV, _BOX_M_INV_T)
    take(bt, bn, (0.8, 0.5, 0.4), MAT_SPECULAR, bh)
    # five planes (left red, right green, bottom/top/far gray)
    planes = [
        ((-1.1, 0.0, 0.0), (1.0, 0.0, 0.0), (0.65, 0.05, 0.05)),
        ((1.1, 0.0, 0.0), (-1.0, 0.0, 0.0), (0.12, 0.45, 0.15)),
        ((0.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.93, 0.93, 0.93)),
        ((0.0, 2.0, 0.0), (0.0, -1.0, 0.0), (0.93, 0.93, 0.93)),
        ((0.0, 0.0, 0.0), (0.0, 0.0, 1.0), (0.93, 0.93, 0.93)),
    ]
    for point, pn, pc in planes:
        t = intersect_plane(ro, rd, point, pn)
        take(t, _vec(pn, ro), pc, MAT_LAMBERT, t < INF)
    # area light
    lh, lt = intersect_light(ro, rd, closest)
    take(lt, _vec(LIGHT_NORMAL, ro), LIGHT_COLOR, MAT_LIGHT, lh)
    return closest, normal, color, mat


def visible_to_light(p, wd):
    _, _, _, mat = intersect_scene(p + EPS * wd, wd)
    return mat == MAT_LIGHT


# --- lighting (taichi_ref.py:313-397) -------------------------------------


def area_light_pdf(p, wd):
    hit, t = intersect_light(p, wd, INF)
    l_cos = _dot(_vec(LIGHT_NORMAL, p), -wd)
    dist_sq = t * t * _dot(wd, wd)
    return torch.where(hit & (l_cos > EPS), dist_sq / (LIGHT_AREA * l_cos), 0.0)


def brdf_pdf(nrm, wd):
    return torch.clamp(_dot(nrm, wd), min=0.0) / np.pi


def sample_direct_light(p, nrm, hit_color, pixel, sample, bounce, seed):
    """MIS: one area-light sample + one BRDF sample, power heuristic."""
    dtype = p.dtype
    fl = (1.0 / np.pi) * hit_color * _vec(LIGHT_COLOR, p)

    ux, uz = rng.uniform2(seed, pixel, sample, bounce, rng.U_LIGHT_U, dtype)
    on_light = torch.stack(
        [
            ux * LIGHT_X_RANGE + LIGHT_X_MIN,
            torch.full_like(ux, LIGHT_Y),
            uz * LIGHT_Z_RANGE + LIGHT_Z_MIN,
        ],
        dim=1,
    )
    to_light = sampling.safe_normalize(on_light - p)
    l_pdf = area_light_pdf(p, to_light)
    b_pdf = brdf_pdf(nrm, to_light)
    vis = visible_to_light(p, to_light)
    ok = (_dot(to_light, nrm) > 0) & (l_pdf > 0) & (b_pdf > 0) & vis
    w = power_heuristic(l_pdf, b_pdf)
    nl = torch.clamp(_dot(to_light, nrm), min=0.0)
    li = torch.where(
        ok[:, None], fl * (w * nl / torch.where(l_pdf == 0, 1.0, l_pdf))[:, None], 0.0)

    u1, u2 = rng.uniform2(seed, pixel, sample, bounce, rng.U_BSDF_1, dtype)
    bdir = sampling.rotate_z_to(nrm, sampling.cosine_sample_hemisphere(u1, u2))
    b_pdf2 = brdf_pdf(nrm, bdir)
    l_pdf2 = area_light_pdf(p, bdir)
    vis2 = visible_to_light(p, bdir)
    ok2 = (b_pdf2 > 0) & (l_pdf2 > 0) & vis2
    w2 = power_heuristic(b_pdf2, l_pdf2)
    nl2 = torch.clamp(_dot(bdir, nrm), min=0.0)
    return li + torch.where(
        ok2[:, None], fl * (w2 * nl2 / torch.where(b_pdf2 == 0, 1.0, b_pdf2))[:, None], 0.0)


def _refract(d, n, eta_ratio):
    """Reference refract (taichi_ref.py:82-93): returns (has_refr, dir).
    The analytic tracer's own, not core/bsdf.refract."""
    dt = _dot(d, n)
    discr = 1.0 - eta_ratio ** 2 * (1.0 - dt * dt)
    has = discr > 0
    rd = eta_ratio[:, None] * (d - n * dt[:, None]) - n * torch.sqrt(
        torch.clamp(discr, min=0.0))[:, None]
    return has, sampling.safe_normalize(rd)


def sample_ray_dir(indir, nrm, mat, pixel, sample, bounce, seed):
    """Next direction per material (taichi_ref.py:408-434), vectorized:
    lambert cosine sample, mirror reflect, glass schlick reflect/refract.
    Returns (dir, pdf).

    The glass choice `ur < refl_prob` flips on an ulp's difference in
    refl_prob, so two implementations that round differently part ways on
    a few paths: compare their images by statistics, not pixel by pixel."""
    dtype = indir.dtype
    u1, u2 = rng.uniform2(seed, pixel, sample, bounce, rng.U_BSDF_0, dtype)
    lam = sampling.rotate_z_to(nrm, sampling.cosine_sample_hemisphere(u1, u2))
    lam_pdf = torch.clamp(brdf_pdf(nrm, lam), min=EPS)

    spec = reflect(indir, nrm)

    cos_in = _dot(indir, nrm)
    going_out = cos_in > 0
    outn = torch.where(going_out[:, None], -nrm, nrm)
    eta = torch.where(going_out, torch.full_like(cos_in, REFR_IDX), 1.0 / REFR_IDX)
    cos = torch.where(going_out, REFR_IDX * cos_in, -cos_in)
    has_refr, refr_dir = _refract(indir, outn, eta)
    refl_prob = torch.where(has_refr, schlick(cos, REFR_IDX), 1.0)
    ur = rng.uniform(seed, pixel, sample, bounce, rng.U_BSDF_2, dtype)
    glass = torch.where((ur < refl_prob)[:, None], reflect(indir, nrm), refr_dir)

    out = torch.where(
        (mat == MAT_LAMBERT)[:, None], lam,
        torch.where((mat == MAT_SPECULAR)[:, None], spec, glass),
    )
    pdf = torch.where(mat == MAT_LAMBERT, lam_pdf, 1.0)
    return sampling.safe_normalize(out), pdf


# --- render (taichi_ref.py:440-491) ----------------------------------------


def trace(ro, rd, pixel, sample, seed, max_depth=MAX_DEPTH):
    """Wavefront radiance for N rays (masked bounce loop)."""
    n = ro.shape[0]
    light_color = _vec(LIGHT_COLOR, ro)
    acc = torch.zeros_like(ro)
    thr = torch.ones_like(ro)
    alive = torch.ones(n, dtype=torch.bool, device=ro.device)
    for bounce in range(max_depth):
        t, nrm, col, mat = intersect_scene(ro, rd)
        alive = alive & (mat != MAT_NONE)
        p = ro + t[:, None] * rd

        hit_light = alive & (mat == MAT_LIGHT)
        acc = acc + torch.where(hit_light[:, None], thr * light_color, 0.0)
        alive = alive & (mat != MAT_LIGHT)

        is_lam = mat == MAT_LAMBERT
        direct = sample_direct_light(p, nrm, col, pixel, sample, bounce, seed)
        acc = acc + torch.where((alive & is_lam)[:, None], thr * direct, 0.0)

        new_dir, pdf = sample_ray_dir(rd, nrm, mat, pixel, sample, bounce, seed)
        lam_thr = (1.0 / np.pi) * col * (
            torch.clamp(_dot(nrm, new_dir), min=0.0) / pdf)[:, None]
        thr_mul = torch.where(is_lam[:, None], lam_thr, col)
        thr = torch.where(alive[:, None], thr * thr_mul, thr)
        ro = torch.where(alive[:, None], p + EPS * new_dir, ro)
        rd = torch.where(alive[:, None], new_dir, rd)
    return acc


def camera_rays(res, sample, seed, dtype=torch.float32, *, device):
    """Stratified primary rays (taichi_ref.py:441-455) on `device`: the 5x5
    stratum is chosen by pass index, the in-stratum jitter by the counter
    RNG. The Python-float constants are applied in the JAX module's order,
    so each ray rounds as it does there."""
    w, h = res
    ys, xs = torch.meshgrid(torch.arange(h, device=device), torch.arange(w, device=device),
                            indexing="ij")
    u = xs.reshape(-1).to(dtype)
    v = ys.reshape(-1).to(dtype)
    pixel = ys.reshape(-1) * w + xs.reshape(-1)
    sample_arr = torch.full_like(pixel, sample)
    str_x = (sample // STRATIFY) % STRATIFY
    str_y = sample % STRATIFY
    jx, jy = rng.uniform2(seed, pixel, sample_arr, 0, rng.U_PIXEL_X, dtype)
    aspect = w / h
    d = torch.stack(
        [
            2.0 * FOV * (u + (str_x + jx) / STRATIFY) / h - FOV * aspect - 1e-5,
            2.0 * FOV * (v + (str_y + jy) / STRATIFY) / h - FOV - 1e-5,
            -torch.ones_like(u),
        ],
        dim=1,
    )
    rd = sampling.safe_normalize(d)
    ro = _vec(CAMERA_POS, rd).expand_as(rd)
    return ro, rd, pixel, sample_arr


def render(res=(200, 200), spp=4, seed=0, max_depth=MAX_DEPTH, *, device):
    """Accumulated HDR frame (H, W, 3) on `device`, y flipped to row-0-top.
    Each sample traces all W*H rays as one wavefront."""
    w, h = res
    acc = torch.zeros((w * h, 3), dtype=torch.float32, device=device)
    for s in range(spp):
        ro, rd, pixel, sample_arr = camera_rays(res, s, seed, device=device)
        acc = acc + trace(ro, rd, pixel, sample_arr, seed, max_depth=max_depth)
    return acc.reshape(h, w, 3).flip(0) / spp


def tonemap(hdr, gain=100.0):
    """The reference's display transform: sqrt(mean * 100) (taichi_ref.py
    :487-491; the x100 gain is what makes this dim physical scene
    displayable; `render` already folds in the accumulation divide)."""
    return torch.sqrt(torch.clamp(hdr * gain, min=0.0))
