"""The plain reference of the specular pbrt cell: the "pbrt" estimator
over lambert, metal and glass faces, with the stratified camera, in plain
PyTorch.

It imports nothing of the program. It is render_pbrt.PbrtReference (the
Threefry stream, the brute-force triangle tests, the light sampler, MIS
and Russian roulette) with what core/integrator_pbrt.py's trace_pbrt does
for the faces render_pbrt refuses, and core/camera.py's strata:

- lambert: render_pbrt's (NEE with the power heuristic, the cosine
  bounce, the throughput scaled by the albedo);
- metal: the mirror direction of the ray about the shading normal plus
  roughness times a point in the unit ball (direction from U_BSDF_0, the
  cube root of U_BSDF_2 as its radius), normalised; the throughput scaled
  by the albedo, and the lane absorbed where that direction lies below
  the surface;
- glass: about the geometric normal turned against the ray (the flipped
  normal inside), reflection where Snell cannot refract or U_BSDF_2 falls
  under Schlick's reflectance at the ior ratio, else Snell refraction;
  the throughput unchanged (clear glass);
- no NEE at a metal or glass vertex, and the emission that the next
  vertex finds after one weighted 1 (no light sample competes for it);
- the camera's jitter stratified: sample s falls in stratum s mod
  strata^2 of a strata x strata grid of the pixel (column s mod strata,
  row its quotient), jittered inside it by the same two uniforms.

The published description (upstream sontung/pyrenderer taichi_ref.py's
sphere scene, `sample_ray_dir` and `sample_direct_light`) departs from
this, and the reference follows the program where it does:
- the spheres are icospheres of 1,280 triangles each (subdivision 3),
  not analytic; their normals are the faces', not the sphere's;
- the fuzz point's radius is the cube root of a uniform and the absorbed
  lane ends its path (taichi_ref reflects without fuzz);
- Schlick's reflectance takes the ior ratio of the side the ray comes
  from as its index (eta, or 1/eta entering);
- Russian roulette from bounce `russian_roulette_start` on, continuing
  with the largest channel of the throughput clipped to [0.05, 1]
  (taichi_ref has a fixed depth of 10);
- the bounce count is the scene's 12 and the grid is ceil(sqrt(spp))
  square of the scene's renderer.spp, walked by the sample id across the
  passes past spp (taichi_ref's grid is its own spp's);
- every RNG draw is the counter-based Threefry stream of render.py.

`dtype` is the precision of every float, as in render.Reference; the
faults that a run of benchmark/control.py plants are subclasses
(drivers/progressive_specular.py). It is computed in blocks: the faces in
Morton blocks of render.BLOCK (render.Triangles' blocked layout, the same
answers as every face), 2^14 lanes a trace.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import render, render_pbrt
from benchmark.reference.render import (
    CAMERA_BOUNCE,
    INV_PI,
    U_LENS_X,
    U_PIXEL_X,
    _cosine_hemisphere,
    _dot,
    _normalize,
    _rotate_z_to,
    uniforms,
)
from benchmark.reference.render_pbrt import U_BSDF_0, U_BSDF_2, U_RR

# the program's scene/types.py material codes
MAT_LAMBERT, MAT_METAL = 0, 2
PI = math.pi


def strata_of(spp: int) -> int:
    """The side of the camera's grid for a configuration of `spp` samples
    a pixel (core/integrator.render_sample): ceil(sqrt(spp))."""
    return int(math.ceil(math.sqrt(spp)))


def camera_rays(cam, px, py, sample, seed, dtype, strata: int):
    """render.camera_rays with the pixel's jitter stratified over a strata x
    strata grid walked by `sample` (N,) int64; strata <= 1 is
    render.camera_rays."""
    if strata <= 1:
        return render.camera_rays(cam, px, py, sample, seed, dtype)
    w, h = cam["resolution"]
    pixel = py * w + px
    jx, jy = uniforms(seed, pixel, sample, CAMERA_BOUNCE, U_PIXEL_X, dtype)
    stratum = (sample & 0xFFFFFFFF) % (strata * strata)
    jx = ((stratum % strata).to(dtype) + jx) / strata
    jy = ((stratum // strata).to(dtype) + jy) / strata
    u = (px.to(dtype) + jx) / w
    v = (py.to(dtype) + jy) / h
    sensor_h = torch.tan(cam["fov_deg"] * (math.pi / 180.0) / 2) * cam["focal_dist"]
    sensor_w = sensor_h * (w / h)
    cx, cy = u - 0.5, v - 0.5
    d_cam = torch.stack([cx * sensor_w * 2.0, cy * sensor_h * 2.0,
                         -cam["focal_dist"] * torch.ones_like(cx)], dim=-1)
    lx, ly = uniforms(seed, pixel, sample, CAMERA_BOUNCE, U_LENS_X, dtype)
    ap = cam["aperture"]
    o_cam = torch.stack([torch.where(ap > 0, ap * lx - ap / 2, 0.0),
                         torch.where(ap > 0, ap * ly - ap / 2, 0.0),
                         torch.zeros_like(lx)], dim=-1)
    rot, trans = cam["iview"][:3, :3], cam["iview"][3, :3]

    def row(x):
        return x[:, 0:1] * rot[0] + x[:, 1:2] * rot[1] + x[:, 2:3] * rot[2]

    rd = row(d_cam - o_cam)
    rd = rd / torch.sqrt(torch.sum(rd * rd, dim=-1, keepdim=True))
    return row(o_cam) + trans, rd


def _safe_sqrt(x):
    nonpos = x <= 0
    return torch.where(nonpos, 0.0, torch.sqrt(torch.where(nonpos, 1.0, x)))


def _reflect(v, n):
    return v - 2.0 * _dot(v, n)[:, None] * n


def _point_in_unit_ball(u1, u2, u3):
    """A point in the unit ball: the direction from (u1, u2), the radius the
    cube root of u3 (as u3 ** (1/3))."""
    cos_t = 1.0 - 2.0 * u1
    sin_t = _safe_sqrt(1.0 - cos_t * cos_t)
    phi = 2.0 * PI * u2
    r = u3.pow(1.0 / 3.0)
    return torch.stack([r * sin_t * torch.cos(phi), r * sin_t * torch.sin(phi), r * cos_t],
                       dim=-1)


def _schlick(cosine, ref_idx):
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * (1.0 - cosine) ** 5


def _refract(uv, n, eta):
    cos_theta = torch.clamp(_dot(-uv, n), max=1.0)
    perp = eta[:, None] * (uv + cos_theta[:, None] * n)
    par = -_safe_sqrt((1.0 - _dot(perp, perp)).abs())
    return perp + par[:, None] * n


class SpecularReference(render_pbrt.PbrtReference):
    """The pbrt reference of a scene with lambert, metal and glass faces:
    `arrays` and `camera` as benchmark.reference.scene_specular.load makes
    them, `settings` the configuration's (max_bounces, triangle_test,
    render: t_min, t_max, shadow_eps, russian_roulette_start) and
    `strata`, the camera grid's side (0: no strata). pixel_sums is
    render.Reference's."""

    def __init__(self, arrays, camera, settings, device, dtype=torch.float32, strata: int = 0):
        # plain float32 products on the card, never TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.emission_table = torch.as_tensor(
            np.asarray(arrays["emission"], np.float32), device=device).to(dtype)
        mat = torch.as_tensor(np.asarray(arrays["face_material"]).astype(np.int64),
                              device=device)
        per_face = lambda x: torch.as_tensor(  # noqa: E731
            np.asarray(x, np.float32), device=device).to(dtype)[mat]
        self.mat_type = torch.as_tensor(np.asarray(arrays["mat_type"]).astype(np.int64),
                                        device=device)[mat]
        self.ior = per_face(arrays["ior"])
        self.roughness = per_face(arrays["roughness"])
        render.Reference.__init__(self, arrays, camera, settings, device, dtype)
        self.rr_start = int(settings["render"]["russian_roulette_start"])
        self.strata = int(strata)

    def set_params(self, vertices, albedo) -> None:
        """PbrtReference's rows, with the triangles in their blocked layout
        (render.Triangles: the same answers as testing every face, in
        less time and memory at thousands of faces)."""
        super().set_params(vertices, albedo)
        if not self.tris.blocked:
            f = self.faces
            self.tris._blocks(*(vertices[f[:, k]].detach() for k in range(3)), self.device)
            self.tris.blocked = True

    def metal_sample(self, rd, nrm, roughness, u1, u2, u3):
        """(wi, valid): the fuzzy mirror; the path ends where not valid."""
        wi = _normalize(_reflect(rd, nrm) + roughness[:, None] * _point_in_unit_ball(u1, u2, u3))
        return wi, _dot(wi, nrm) > 0

    def glass_sample(self, rd, n_geo, ior, u):
        """Reflection or refraction about the geometric normal n_geo (before
        any flip toward the ray), unit length."""
        front = _dot(rd, n_geo) < 0
        n_eff = torch.where(front[:, None], n_geo, -n_geo)
        eta = torch.where(front, 1.0 / ior, ior)
        cos_theta = torch.clamp(_dot(-rd, n_eff), max=1.0)
        sin_theta = _safe_sqrt(1.0 - cos_theta * cos_theta)
        reflect = (eta * sin_theta > 1.0) | (u < _schlick(cos_theta, eta))
        wi = torch.where(reflect[:, None], _reflect(rd, n_eff), _refract(rd, n_eff, eta))
        return _normalize(wi)

    def trace(self, px, py, sample, seed):
        """Radiance (N, 3) of pixel (px, py), sample `sample` (N,) each."""
        dt = self.dtype
        w = self.cam["resolution"][0]
        pixel = py * w + px
        ro, rd = camera_rays(self.cam, px, py, sample, seed, dt, self.strata)
        n = ro.shape[0]
        beta = torch.ones_like(ro)
        radiance = torch.zeros_like(ro)
        alive = torch.ones(n, dtype=torch.bool, device=ro.device)
        prev_pdf = torch.ones(n, dtype=dt, device=ro.device)
        prev_spec = torch.zeros(n, dtype=torch.bool, device=ro.device)
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
            lambert = self.mat_type[tri] == MAT_LAMBERT
            metal = self.mat_type[tri] == MAT_METAL

            # emission: against NEE's pdf of the point after a lambert
            # vertex, weight 1 at the camera and after a specular vertex
            cos_l = _dot(-rd, nrm)
            pdf_light = (self.pdf_a[tri] * torch.clamp(t * t, min=1e-12)
                         / torch.clamp(cos_l, min=1e-6))
            w_em = self.emission_weight(bounce, prev_pdf, pdf_light)
            if bounce:
                w_em = torch.where(prev_spec, 1.0, w_em)
            add = (alive & hit & self.emissive[tri] & (cos_l > 0))[:, None]
            radiance = radiance + torch.where(add, self.face_em[tri] * beta * w_em[:, None], 0.0)
            alive = alive & hit & (~self.emissive[tri])

            # NEE from lambert vertices
            p2, n2, em, pdf_a = self._light_point(pixel, sample, bounce, seed)
            to_light = p2 - p
            dist_sq = torch.clamp(_dot(to_light, to_light), min=1e-12)
            dist = torch.sqrt(dist_sq)
            wl = to_light / dist[:, None]
            cos_surf = _dot(nrm, wl)
            cos_light = _dot(n2, -wl)
            cand = alive & lambert & (cos_surf > 0) & (cos_light > 0)
            shadow_t1 = torch.where(cand, dist * (1.0 - self.shadow_eps), 0.0)
            occ = self.tris.occluded(p, wl, self.t_min, shadow_t1)
            pdf_nee = pdf_a * dist_sq / torch.clamp(cos_light, min=1e-6)
            w_nee = self.nee_weight(pdf_nee, torch.clamp(cos_surf, min=0.0) * INV_PI)
            contrib = albedo * INV_PI * em * (
                w_nee * cos_surf / torch.clamp(pdf_nee, min=1e-12))[:, None]
            radiance = radiance + torch.where((cand & (~occ))[:, None], beta * contrib, 0.0)

            # the lane's own sampler
            u1, u2 = uniforms(seed, pixel, sample, bounce, U_BSDF_0, dt)
            u3, _ = uniforms(seed, pixel, sample, bounce, U_BSDF_2, dt)
            wi_l = _rotate_z_to(nrm, _cosine_hemisphere(u1, u2))
            pdf_l = _dot(nrm, wi_l).abs() * INV_PI
            wi_m, metal_ok = self.metal_sample(rd, nrm, self.roughness[tri], u1, u2, u3)
            wi_g = self.glass_sample(rd, n_geo, self.ior[tri], u3)
            wi = torch.where(lambert[:, None], wi_l, torch.where(metal[:, None], wi_m, wi_g))
            scale = torch.where(lambert[:, None], albedo,
                                torch.where(metal[:, None], albedo * metal_ok[:, None].to(dt),
                                            torch.ones_like(albedo)))
            beta = torch.where(alive[:, None], beta * scale, beta)
            alive = alive & torch.where(metal, metal_ok, True)
            prev_pdf = torch.where(lambert, pdf_l, 1.0)
            prev_spec = ~lambert

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
