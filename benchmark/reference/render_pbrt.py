"""The plain reference of the pbrt cells: the "pbrt" estimator at a fixed
bounce count, over the render cells' camera, Threefry and brute-force
triangle tests (benchmark/reference/render.py), in plain PyTorch.

It imports nothing of the program. It follows core/integrator_pbrt.py's
trace_pbrt (the semantics of the JAX package's ref/scalar_pbrt.py
oracle) for the faces that the benchmark's scene loader makes, lambert
and light:

- emission on a hit, weighted by the power heuristic against the light
  sampler (weight 1 at the camera vertex);
- NEE from every live vertex: one light point, its area pdf converted to
  solid angle, the power heuristic against the lambert pdf, one shadow
  ray;
- a cosine-sampled lambert bounce, the throughput scaled by the albedo;
- Russian roulette on the throughput from `russian_roulette_start` on.

Every live vertex lies on a lambert face (a light face ends its path), so
no bounce is specular. Metal and glass are not covered: a scene that has
them is refused, and they are left to a cell of their own (spheres.pbrt).

RNG slots a bounce, as trace_pbrt draws them: U_BSDF_0 (both words) for
the lambert direction; U_LIGHT_PRIM only with more than one light,
U_LIGHT_FACE, U_LIGHT_U (both words) for the light point; U_RR from
`russian_roulette_start` on. trace_pbrt also draws U_BSDF_2 on every lane,
which feeds only metal and glass; the stream is counter-based, so leaving
it out moves no other draw.

It works out again what the program derives from the scene arrays for
this estimator: the light faces' area pdf (1 / (lights x faces of the
light x area)) and each face's scene emission. `dtype` is the precision
of every float, as in render.Reference: float32 is the configuration's,
and bfloat16 makes the control.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import render
from benchmark.reference.render import (
    INV_PI,
    _cosine_hemisphere,
    _dot,
    _normalize,
    _rotate_z_to,
    camera_rays,
    uniforms,
)

# the program's rng.py slots and scene/types.py material code
U_BSDF_0, U_BSDF_2 = 4, 6
U_LIGHT_PRIM, U_LIGHT_FACE, U_LIGHT_U = 7, 8, 9
U_RR = 11
MAT_LAMBERT = 0


def power_heuristic(pf, pg):
    """Two-sample power heuristic, pf^2 / (pf^2 + pg^2)."""
    f2 = pf * pf
    g2 = pg * pg
    return f2 / torch.clamp(f2 + g2, min=1e-20)


class PbrtReference(render.Reference):
    """The pbrt reference renderer of one scene: `arrays` and `camera` as
    benchmark.reference.scene.load makes them, `settings` the
    configuration's (max_bounces, triangle_test, render: t_min, t_max,
    shadow_eps, russian_roulette_start). pixel_sums is render.Reference's."""

    def __init__(self, arrays, camera, settings, device, dtype=torch.float32):
        # plain float32 products on the card, never TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        mat_type, emissive = np.asarray(arrays["mat_type"]), np.asarray(arrays["emissive"])
        if ((mat_type != MAT_LAMBERT) & (emissive == 0)).any():
            raise ValueError("the pbrt reference covers lambert and light faces only")
        self.emission_table = torch.as_tensor(
            np.asarray(arrays["emission"], np.float32), device=device).to(dtype)
        super().__init__(arrays, camera, settings, device, dtype)
        self.rr_start = int(settings["render"]["russian_roulette_start"])

    def set_params(self, vertices, albedo) -> None:
        """render.Reference's rows, the faces' scene emission in place of the
        light albedo, and each face's area pdf of being sampled by NEE (0
        off the lights)."""
        super().set_params(vertices, albedo)
        self.face_em = self.emission_table[self.mat]
        self.light_em = self.face_em[self.light_faces]               # (L, F, 3)
        area = 0.5 * torch.linalg.vector_norm(torch.linalg.cross(self.e1, self.e2, dim=-1),
                                              dim=-1)
        n_lights = self.light_faces.shape[0]
        pdf = torch.zeros_like(area)
        for li, nf in enumerate(self.light_nfaces.tolist()):
            faces = self.light_faces[li, :nf]
            pdf[faces] = 1.0 / (n_lights * nf * torch.clamp(area[faces], min=1e-12))
        self.pdf_a = pdf

    def emission_weight(self, bounce: int, prev_pdf, pdf_light):
        """MIS weight of emission found by the bsdf sample of the vertex
        before (bounce > 0) against NEE's pdf of the same point."""
        if bounce == 0:
            return torch.ones_like(pdf_light)
        return power_heuristic(prev_pdf, pdf_light)

    def nee_weight(self, pdf_nee, pdf_bsdf):
        """MIS weight of the light sample against the lambert pdf."""
        return power_heuristic(pdf_nee, pdf_bsdf)

    def trace(self, px, py, sample, seed):
        """Radiance (N, 3) of pixel (px, py), sample `sample` (N,) each."""
        dt = self.dtype
        w = self.cam["resolution"][0]
        pixel = py * w + px
        ro, rd = camera_rays(self.cam, px, py, sample, seed, dt)
        n = ro.shape[0]
        beta = torch.ones_like(ro)
        radiance = torch.zeros_like(ro)
        alive = torch.ones(n, dtype=torch.bool, device=ro.device)
        prev_pdf = torch.ones(n, dtype=dt, device=ro.device)
        for bounce in range(self.bounces):
            t_clip = torch.where(alive, self.t_max, 0.0).to(dt)
            hit, tri = self.tris.closest(ro, rd, self.t_min, t_clip)
            v0, e1, e2 = self.v0[tri], self.e1[tri], self.e2[tri]
            det = _dot(torch.linalg.cross(e1, rd, dim=-1), e2)
            s = ro - v0
            t = -_dot(torch.linalg.cross(s, e2, dim=-1), e1) / torch.where(det == 0, 1.0, det)
            p = ro + t[:, None] * rd
            n_geo = self.sign[tri][:, None] * _normalize(torch.linalg.cross(e1, e2, dim=-1))
            flip = (~self.sided[tri]) & (_dot(n_geo, -rd) < 0)
            nrm = torch.where(flip[:, None], -n_geo, n_geo)
            albedo = self.albedo[tri]

            # emission, against NEE's pdf of the point in solid angle
            cos_l = _dot(-rd, nrm)
            pdf_light = (self.pdf_a[tri] * torch.clamp(t * t, min=1e-12)
                         / torch.clamp(cos_l, min=1e-6))
            w_em = self.emission_weight(bounce, prev_pdf, pdf_light)
            add = (alive & hit & self.emissive[tri] & (cos_l > 0))[:, None]
            radiance = radiance + torch.where(add, self.face_em[tri] * beta * w_em[:, None], 0.0)
            alive = alive & hit & (~self.emissive[tri])

            # NEE: every live vertex is lambert
            p2, n2, em, pdf_a = self._light_point(pixel, sample, bounce, seed)
            to_light = p2 - p
            dist_sq = torch.clamp(_dot(to_light, to_light), min=1e-12)
            dist = torch.sqrt(dist_sq)
            wl = to_light / dist[:, None]
            cos_surf = _dot(nrm, wl)
            cos_light = _dot(n2, -wl)
            cand = alive & (cos_surf > 0) & (cos_light > 0)
            shadow_t1 = torch.where(cand, dist * (1.0 - self.shadow_eps), 0.0)
            occ = self.tris.occluded(p, wl, self.t_min, shadow_t1)
            pdf_nee = pdf_a * dist_sq / torch.clamp(cos_light, min=1e-6)
            w_nee = self.nee_weight(pdf_nee, torch.clamp(cos_surf, min=0.0) * INV_PI)
            contrib = albedo * INV_PI * em * (
                w_nee * cos_surf / torch.clamp(pdf_nee, min=1e-12))[:, None]
            radiance = radiance + torch.where((cand & (~occ))[:, None], beta * contrib, 0.0)

            # the lambert bounce: f cos / pdf = albedo
            u1, u2 = uniforms(seed, pixel, sample, bounce, U_BSDF_0, dt)
            wi = _rotate_z_to(nrm, _cosine_hemisphere(u1, u2))
            prev_pdf = _dot(nrm, wi).abs() * INV_PI
            beta = torch.where(alive[:, None], beta * albedo, beta)

            if bounce >= self.rr_start:
                u_rr, _ = uniforms(seed, pixel, sample, bounce, U_RR, dt)
                p_cont = torch.clamp(torch.amax(beta, dim=-1), 0.05, 1.0)
                survive = u_rr < p_cont
                beta = torch.where((alive & survive)[:, None], beta * (1.0 / p_cont)[:, None],
                                   beta)
                alive = alive & survive

            ro = torch.where(alive[:, None], p, ro)
            rd = torch.where(alive[:, None], wi, rd)
        return radiance

    def _light_point(self, pixel, sample, bounce, seed):
        """(point, normal, emission, area pdf) of one light sample a lane:
        a light (U_LIGHT_PRIM, with more than one), a face of it
        (U_LIGHT_FACE), a sqrt-barycentric point on it (U_LIGHT_U)."""
        dt = self.dtype
        n_lights = self.light_faces.shape[0]
        if n_lights > 1:
            up, _ = uniforms(seed, pixel, sample, bounce, U_LIGHT_PRIM, dt)
            li = torch.clamp((up * n_lights).to(torch.int64), 0, n_lights - 1)
        else:
            li = torch.zeros_like(pixel)
        nf = self.light_nfaces[li]
        uf, _ = uniforms(seed, pixel, sample, bounce, U_LIGHT_FACE, dt)
        fi = torch.minimum(torch.clamp((uf * nf.to(dt)).to(torch.int64), min=0), nf - 1)
        face = self.light_faces[li, fi]
        v0, v1, v2 = (c[li, fi] for c in self.light_corners)
        u, v = uniforms(seed, pixel, sample, bounce, U_LIGHT_U, dt)
        su = torch.sqrt(u)
        a, b = (su * (1.0 - v))[:, None], (su * v)[:, None]
        p2 = a * v0 + b * v1 + (1.0 - a - b) * v2
        n2 = self.sign[face][:, None] * _normalize(torch.linalg.cross(v1 - v0, v2 - v0, dim=-1))
        return p2, n2, self.light_em[li, fi], self.pdf_a[face]
