"""Physically based wavefront estimator ("pbrt") in PyTorch.

Counterpart of pyrenderer_tpu/core/integrator_pbrt.py, the same bounce
loop as core/integrator.trace_reference over the extended (T, 24) face
table:

- emission on hit with MIS against the light sampler (power heuristic,
  weight 1 at the camera vertex and after specular bounces);
- NEE from lambert vertices only: the area pdf converted to solid angle,
  MIS against the bsdf pdf;
- lambert, metal (fuzzy mirror) and dielectric (Schlick + Snell)
  scattering, per core/bsdf.py;
- Russian roulette on the throughput from cfg.russian_roulette_start on.

RNG slots per bounce, as the NumPy oracle (the JAX package's
ref/scalar_pbrt.py) draws them:
  uniform2(U_BSDF_0) -> (u1, u2)  lambert cosine / metal fuzz direction
  uniform(U_BSDF_2)  -> u3        metal fuzz radius / dielectric choice
  [uniform(U_LIGHT_PRIM) iff >1 light] uniform(U_LIGHT_FACE),
  uniform2(U_LIGHT_U) -> (u, v)   light point
  uniform(U_RR)      -> rr

The gradient contract is core/integrator.py's: vertices, albedo and
emission are differentiable through the re-derived hit geometry, the face
and light rows and the light pdf (the MIS weights included); the hit ids,
the visibility and the shadow rays' extents are detached. The Russian
roulette's continuation probability splits its gradient among tied
channels and at its clip bounds as jnp.max and jnp.clip do.
"""

from __future__ import annotations

import torch

from pyrenderer_tpu_torch import rng
from pyrenderer_tpu_torch.config import RenderConfig
from pyrenderer_tpu_torch.core import bsdf, sampling
from pyrenderer_tpu_torch.core.integrator import (
    TraceTables,
    _any_hit,
    _closest,
    _sample_light_point,
    check_supported,
    use_wavefront_sort,
    wavefront_sort_perm,
)
from pyrenderer_tpu_torch.core.sampling import INV_PI
from pyrenderer_tpu_torch.scene.types import MAT_LAMBERT, MAT_METAL, Scene


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def trace_pbrt(
    scene: Scene,
    cfg: RenderConfig,
    ro,
    rd,
    pixel_id,
    sample_id,
    seed: int,
    tables: TraceTables | None = None,
    backend: str = "auto",
    with_stats: bool = False,
):
    """Radiance for a wavefront of rays, "pbrt" estimator semantics.

    Arguments and the with_stats count as trace_reference: live
    closest-hit rays plus one shadow ray per live lane and bounce (the JAX
    estimator's count, which includes lanes that need no shadow test).
    The wavefront sort (use_wavefront_sort) permutes this loop's state as
    trace_reference's, prev_pdf and prev_spec included."""
    check_supported(cfg)
    dtype = ro.dtype
    if tables is None:
        tables = TraceTables(scene, cfg.replace(estimator="pbrt"), backend)
    n = ro.shape[0]
    pixel_id = pixel_id.to(torch.int64).expand(n)

    beta = torch.ones_like(ro)
    radiance = torch.zeros_like(ro)
    alive = torch.ones(n, dtype=torch.bool, device=ro.device)
    prev_pdf = torch.ones(n, dtype=dtype, device=ro.device)
    prev_spec = torch.zeros(n, dtype=torch.bool, device=ro.device)
    n_rays = torch.zeros((), dtype=torch.float32, device=ro.device)
    t_max = torch.full((), cfg.t_max, dtype=dtype, device=ro.device)
    wf_sort = use_wavefront_sort(tables)
    sort = False if wf_sort else None
    if wf_sort:
        sample_id = torch.as_tensor(sample_id, device=ro.device).to(torch.int64).expand(n)
        orig = torch.arange(n, device=ro.device)

    for bounce in range(cfg.max_bounces):
        if wf_sort:
            perm = wavefront_sort_perm(tables.accel, ro, rd, alive)
            (ro, rd, beta, radiance, alive, prev_pdf, prev_spec, pixel_id, sample_id,
             orig) = (x[perm] for x in (ro, rd, beta, radiance, alive, prev_pdf, prev_spec,
                                         pixel_id, sample_id, orig))
        n_rays = n_rays + alive.sum(dtype=torch.float32)

        # dead lanes trace a zero interval, as in trace_reference
        t_clip = torch.where(alive, t_max, 0.0)
        hit, _, tri = _closest(scene, tables, cfg, ro, rd, t_clip, sort=sort)
        tri = torch.clamp(tri, min=0).to(torch.int64)

        row = tables.fetch_face(tri)
        v0, e1, e2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
        albedo = row[:, 9:12]
        sign = row[:, 12]
        emissive = row[:, 13] > 0.5
        sided = row[:, 14] > 0.5
        mat_type = row[:, 15].to(torch.int64)
        emission = row[:, 16:19]
        ior = row[:, 19]
        roughness = row[:, 20]
        hit_pdf_a = row[:, 21]

        # differentiable hit geometry (the selection is detached)
        det = _dot(torch.linalg.cross(e1, rd, dim=-1), e2)
        safe_det = torch.where(det == 0, 1.0, det)
        s = ro - v0
        t = -_dot(torch.linalg.cross(s, e2, dim=-1), e1) / safe_det
        p = ro + t[:, None] * rd

        n_geo = sign[:, None] * sampling.safe_normalize(torch.linalg.cross(e1, e2, dim=-1))
        flip = (~sided) & (_dot(n_geo, -rd) < 0)
        nrm = torch.where(flip[:, None], -n_geo, n_geo)

        # ---- emission with MIS against the light sampler ----
        cos_l = _dot(-rd, nrm)
        dist_sq_hit = sampling.maximum(t * t, 1e-12)
        # pdf of having sampled this point by NEE, in solid angle
        pdf_light_sa = hit_pdf_a * dist_sq_hit / sampling.maximum(cos_l, 1e-6)
        if bounce == 0:
            w_mis = torch.ones_like(cos_l)
        else:
            w_mis = torch.where(prev_spec, 1.0, bsdf.power_heuristic(prev_pdf, pdf_light_sa))
        add_em = (alive & hit & emissive & (cos_l > 0))[:, None]
        radiance = radiance + torch.where(add_em, emission * beta * w_mis[:, None], 0.0)

        alive = alive & hit & (~emissive)
        is_lambert = mat_type == MAT_LAMBERT
        is_metal = mat_type == MAT_METAL

        # ---- NEE from diffuse vertices (the MIS partner) ----
        p2, n2, em, pdf_a = _sample_light_point(
            scene, tables, pixel_id, sample_id, bounce, seed, dtype)
        to_light = p2 - p
        dist_sq = sampling.maximum(_dot(to_light, to_light), 1e-12)
        dist = torch.sqrt(dist_sq)
        wl = to_light / dist[:, None]
        cos_surf = _dot(nrm, wl)
        cos_light = _dot(n2, -wl)
        nee_candidate = alive & is_lambert & (cos_surf > 0) & (cos_light > 0)
        shadow_t1 = torch.where(nee_candidate, dist.detach() * (1.0 - cfg.shadow_eps), 0.0)
        occ = _any_hit(scene, tables, cfg, p.detach(), wl.detach(), shadow_t1, sort=sort)
        n_rays = n_rays + alive.sum(dtype=torch.float32)
        pdf_nee_sa = pdf_a * dist_sq / sampling.maximum(cos_light, 1e-6)
        w_nee = bsdf.power_heuristic(pdf_nee_sa, bsdf.lambert_pdf(nrm, wl))
        contrib = albedo * INV_PI * em * (
            w_nee * cos_surf / sampling.maximum(pdf_nee_sa, 1e-12))[:, None]
        radiance = radiance + torch.where((nee_candidate & (~occ))[:, None], beta * contrib, 0.0)

        # ---- BSDF sampling ----
        u1, u2 = rng.uniform2(seed, pixel_id, sample_id, bounce, rng.U_BSDF_0, dtype)
        u3 = rng.uniform(seed, pixel_id, sample_id, bounce, rng.U_BSDF_2, dtype)
        wi_l, pdf_l = bsdf.lambert_sample(nrm, u1, u2)
        wi_m, metal_ok = bsdf.metal_sample(rd, nrm, roughness, u1, u2, u3)
        # the dielectric takes the unflipped geometric normal
        wi_d = bsdf.dielectric_sample(rd, n_geo, ior, u3)
        # every face that is neither lambert nor metal scatters as glass
        # (MAT_DIELECTRIC; light faces have ended their paths above)
        wi = torch.where(is_lambert[:, None], wi_l,
                         torch.where(is_metal[:, None], wi_m, wi_d))
        # throughput scale: lambert f*cos/pdf = albedo; metal albedo (or the
        # path ends); dielectric 1 (clear glass)
        scale = torch.where(
            is_lambert[:, None], albedo,
            torch.where(is_metal[:, None], albedo * metal_ok[:, None].to(dtype),
                        torch.ones_like(albedo)))
        beta = torch.where(alive[:, None], beta * scale, beta)
        alive = alive & torch.where(is_metal, metal_ok, True)

        prev_pdf = torch.where(is_lambert, pdf_l, 1.0)
        prev_spec = ~is_lambert

        # ---- Russian roulette ----
        # (the draw only matters from russian_roulette_start on, so it is
        # made only there)
        if bounce >= cfg.russian_roulette_start:
            u_rr = rng.uniform(seed, pixel_id, sample_id, bounce, rng.U_RR, dtype)
            # amax splits the gradient among tied channels, as jnp.max
            # does (max(dim) gives it all to one), and the bounds split a
            # tie as jnp.clip does
            p_cont = sampling.minimum(sampling.maximum(torch.amax(beta, dim=-1), 0.05), 1.0)
            survive = u_rr < p_cont
            beta = torch.where((alive & survive)[:, None],
                               beta * (1.0 / p_cont)[:, None], beta)
            alive = alive & survive

        ro = torch.where(alive[:, None], p, ro)
        rd = torch.where(alive[:, None], wi, rd)

    if wf_sort:
        radiance = torch.zeros_like(radiance).index_put((orig,), radiance)
    if with_stats:
        return radiance, n_rays
    return radiance
