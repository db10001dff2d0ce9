"""Batched BSDF sampling and evaluation for the "pbrt" estimator (PyTorch).

Counterpart of pyrenderer_tpu/core/bsdf.py, after the reference's three
material families:
  - lambert: cosine-hemisphere scatter, f = albedo/pi, pdf = cos/pi
    (reference core/bsdf.py:19 BSDFLambertian);
  - metal: mirror reflection plus roughness * a point in the unit ball,
    absorbed if the fuzzed direction leaves the hemisphere (reference
    core/bsdf_taichi.py:46-59 Metal.scatter);
  - dielectric: Snell refraction with Schlick-probability reflection and
    total internal reflection (reference core/bsdf_taichi.py:62-86).

Every function is batched over (N, ...) and draws no randomness: the
uniforms come in as arguments, so the NumPy oracle (the JAX package's
ref/scalar_pbrt.py) can follow the same stream.
"""

from __future__ import annotations

import torch

from pyrenderer_tpu_torch.core import sampling
from pyrenderer_tpu_torch.core.sampling import INV_PI, PI


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def reflect(v, n):
    """Mirror v about the plane of normal n (v points toward the surface)."""
    return v - 2.0 * _dot(v, n)[..., None] * n


def refract(uv, n, eta_ratio):
    """Snell refraction of unit vector uv about n (reference
    core/bsdf_taichi.py:18-24)."""
    cos_theta = torch.clamp(_dot(-uv, n), max=1.0)
    r_out_perp = eta_ratio[..., None] * (uv + cos_theta[..., None] * n)
    par_len = -sampling.safe_sqrt((1.0 - _dot(r_out_perp, r_out_perp)).abs())
    return r_out_perp + par_len[..., None] * n


def schlick(cosine, ref_idx):
    """Schlick's reflectance approximation (reference core/bsdf_taichi.py:7)."""
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * (1.0 - cosine) ** 5


def point_in_unit_sphere(u1, u2, u3):
    """Uniform point in the unit ball: direction from (u1, u2), radius the
    cube root of u3 (the metal fuzz).

    torch has no cbrt; u3 >= 0, so u3 ** (1/3) is real. It is not the
    correctly rounded cube root: it may differ from np.cbrt / jnp.cbrt in
    the last ulp or two (tests/test_torch_pbrt.py bounds it)."""
    cos_t = 1.0 - 2.0 * u1
    sin_t = sampling.safe_sqrt(1.0 - cos_t * cos_t)
    phi = 2.0 * PI * u2
    r = u3.pow(1.0 / 3.0)
    return torch.stack(
        [r * sin_t * torch.cos(phi), r * sin_t * torch.sin(phi), r * cos_t], dim=-1)


def lambert_sample(nrm, u1, u2):
    """Cosine-weighted wi in the frame of nrm; returns (wi, pdf)."""
    wi = sampling.rotate_z_to(nrm, sampling.cosine_sample_hemisphere(u1, u2))
    pdf = _dot(nrm, wi).abs() * INV_PI
    return wi, pdf


def lambert_pdf(nrm, wi):
    return torch.clamp(_dot(nrm, wi), min=0.0) * INV_PI


def metal_sample(rd, nrm, roughness, u1, u2, u3):
    """Fuzzy mirror; returns (wi, valid). The throughput scales by the
    albedo where valid and the path ends where not."""
    wi = reflect(rd, nrm) + roughness[..., None] * point_in_unit_sphere(u1, u2, u3)
    wi = sampling.safe_normalize(wi)
    return wi, _dot(wi, nrm) > 0


def dielectric_sample(rd, nrm, ior, u_choice):
    """Glass: refract unless total internal reflection or the Schlick draw
    chooses reflection. rd is a unit vector, nrm the outward geometric
    normal (before any flip toward the ray). Returns a unit wi."""
    front = _dot(rd, nrm) < 0
    n_eff = torch.where(front[..., None], nrm, -nrm)
    eta = torch.where(front, 1.0 / ior, ior)
    cos_theta = torch.clamp(_dot(-rd, n_eff), max=1.0)
    sin_theta = sampling.safe_sqrt(1.0 - cos_theta * cos_theta)
    cannot_refract = eta * sin_theta > 1.0
    do_reflect = cannot_refract | (u_choice < schlick(cos_theta, eta))
    wi = torch.where(do_reflect[..., None], reflect(rd, n_eff), refract(rd, n_eff, eta))
    return sampling.safe_normalize(wi)


def power_heuristic(pf, pg):
    """Two-sample power heuristic (reference core/tracing.py:18)."""
    f2 = pf * pf
    g2 = pg * pg
    return f2 / torch.clamp(f2 + g2, min=1e-20)
