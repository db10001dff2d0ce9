"""The plain reference of the render cells: camera rays, Threefry and the
"reference" estimator at a fixed bounce count, over a brute-force
triangle test, in plain PyTorch.

It imports nothing of the program. It is a frozen copy of the port's
rng.py (Threefry-2x32, 20 rounds), core/camera.py (generate_rays without
strata), core/sampling.py and core/integrator.py's trace_reference (the
upstream renderer's core/tracing.py semantics: the hardcoded light color,
NEE without area pdf), with its own intersection: every triangle tested
for every ray, Moeller-Trumbore (core/intersect.py's order) or the
watertight test (core/watertight.py), closest hit to the lowest face id on
a tie. For a large scene the faces are grouped into blocks of BLOCK along a
Morton curve of their centroids and a ray tests only the blocks whose
padded box it crosses: the same answers as testing every face, in less
time.

It works out again everything the program derives from the scene arrays:
the per-face rows (v0, e1, e2, albedo, sign, emissive, sided) and the
light faces' corners. `dtype` is the precision of every float: float32 is
the configuration's, and bfloat16 makes the control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

LIGHT_COLOR = (0.9, 0.85, 0.7)
INV_PI = 1.0 / math.pi
BLOCK = 64
_BLOCKED_ABOVE = 4096   # faces; below it every ray tests every face

# Threefry-2x32 (Random123), 20 rounds; counter (pixel, sample << 12 |
# bounce << 4 | use), key (seed, "path")
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_U32 = 0xFFFFFFFF
_KEY_TAG = 0x70617468
_ROUNDS = 20
CAMERA_BOUNCE = 255
U_PIXEL_X, U_LENS_X, U_BSDF_0 = 0, 2, 4
U_LIGHT_PRIM, U_LIGHT_FACE, U_LIGHT_U = 7, 8, 9


def threefry(seed: int, c0, c1):
    k0, k1 = seed & _U32, _KEY_TAG
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (c0 + ks[0]) & _U32
    x1 = (c1 + ks[1]) & _U32
    for r_idx in range(_ROUNDS):
        i = r_idx // 4
        r = _ROTATIONS[i % 2][r_idx % 4]
        x0 = (x0 + x1) & _U32
        x1 = (((x1 << r) | (x1 >> (32 - r))) & _U32) ^ x0
        if (r_idx + 1) % 4 == 0:
            x0 = (x0 + ks[(i + 1) % 3]) & _U32
            x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _U32
    return x0, x1


def uniforms(seed, pixel, sample, bounce, use, dtype):
    """Both uniforms of one Threefry call, top 24 bits in float32, then
    cast to dtype."""
    c1 = ((sample << 12) | (bounce << 4) | use) & _U32
    x0, x1 = threefry(seed, pixel & _U32, c1)
    scale = 1.0 / (1 << 24)
    return tuple(((x >> 8).to(torch.float32) * scale).to(dtype) for x in (x0, x1))


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _normalize(v):
    ss = torch.sum(v * v, dim=-1, keepdim=True)
    zero = ss == 0
    return v * torch.where(zero, 0.0, 1.0 / torch.sqrt(torch.where(zero, 1.0, ss)))


def camera_rays(cam, px, py, sample, seed, dtype):
    """Pinhole camera with square-aperture jitter; px, py (N,) int64 with y
    up from the bottom row; cam holds tensors in dtype."""
    w, h = cam["resolution"]
    pixel = py * w + px
    jx, jy = uniforms(seed, pixel, sample, CAMERA_BOUNCE, U_PIXEL_X, dtype)
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


def _cosine_hemisphere(u1, u2):
    pi = math.pi
    ox, oy = 2.0 * u1 - 1.0, 2.0 * u2 - 1.0
    use_x = ox.abs() > oy.abs()
    r = torch.where(use_x, ox, oy)
    theta = torch.where(use_x, (pi / 4) * (oy / torch.where(ox == 0, 1.0, ox)),
                        (pi / 2) - (pi / 4) * (ox / torch.where(oy == 0, 1.0, oy)))
    zero = (ox == 0) & (oy == 0)
    dx = torch.where(zero, 0.0, r * torch.cos(theta))
    dy = torch.where(zero, 0.0, r * torch.sin(theta))
    z2 = 1.0 - dx * dx - dy * dy
    z = torch.where(z2 <= 0, 0.0, torch.sqrt(torch.where(z2 <= 0, 1.0, z2)))
    return torch.stack([dx, dy, z], dim=-1)


def _rotate_z_to(n, local):
    """The upstream shading frame: general branch x = normalize((-nz, 0,
    nx)), z = normalize(x cross n); near +-y the fixed axes, and local z
    mapped to +-y."""
    ny = n[:, 1]
    neg_y = (ny + 1.0).abs() < 1e-6
    pos_y = (ny - 1.0).abs() < 1e-6
    axis = neg_y | pos_y
    eye = torch.eye(3, dtype=n.dtype, device=n.device)
    gx = _normalize(torch.stack([-n[:, 2], torch.zeros_like(ny), n[:, 0]], dim=-1))
    gz = _normalize(torch.linalg.cross(gx, n, dim=-1))
    x_hat = torch.where(axis[:, None], eye[0], gx)
    z_hat = torch.where(axis[:, None], eye[2], gz)
    n_frame = torch.where(pos_y[:, None], eye[1], torch.where(neg_y[:, None], -eye[1], n))
    world = local[:, 0:1] * x_hat + local[:, 1:2] * z_hat + local[:, 2:3] * n_frame
    return _normalize(world)


# ---------------------------------------------------------------- triangles

def _mt(v0, e1, e2, ro, rd, t0, t1):
    """(N, T) Moeller-Trumbore acceptance and t, dot products summed left
    to right."""
    dx, dy, dz = (rd[:, k:k + 1] for k in range(3))
    ox, oy, oz = (ro[:, k:k + 1] for k in range(3))
    v0x, v0y, v0z = v0[..., 0], v0[..., 1], v0[..., 2]
    e1x, e1y, e1z = e1[..., 0], e1[..., 1], e1[..., 2]
    e2x, e2y, e2z = e2[..., 0], e2[..., 1], e2[..., 2]
    cx = e1y * dz - e1z * dy
    cy = e1z * dx - e1x * dz
    cz = e1x * dy - e1y * dx
    det = cx * e2x + cy * e2y + cz * e2z
    inv = 1.0 / torch.where(det == 0, 1.0, det)
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    qx = sy * e2z - sz * e2y
    qy = sz * e2x - sx * e2z
    qz = sx * e2y - sy * e2x
    t = -inv * (qx * e1x + qy * e1y + qz * e1z)
    u = -inv * (qx * dx + qy * dy + qz * dz)
    v = inv * (cx * sx + cy * sy + cz * sz)
    ok = ((det.abs() > 0) & (t > t0) & (t < t1[:, None]) & (u >= 0) & (u <= 1)
          & (v >= 0) & (1.0 - u - v >= 0))
    return ok, t


_SPLIT = 4097.0
_EDGE_REL_TOL = 2.0 ** -22


def _edge(a, b, c, d):
    """a*b - c*d, recomputed with Dekker two-products where it cancels to
    under ~2 ulp of its products."""
    p1, p2 = a * b, c * d
    e = p1 - p2
    thr = (p1.abs() + p2.abs()) * _EDGE_REL_TOL

    def two_product(x, y):
        p = x * y
        xh = x * _SPLIT
        xh = xh - (xh - x)
        xl = x - xh
        yh = y * _SPLIT
        yh = yh - (yh - y)
        yl = y - yh
        return p, ((xh * yh - p) + xh * yl + xl * yh) + xl * yl

    q1, r1 = two_product(a, b)
    q2, r2 = two_product(c, d)
    return torch.where(e.abs() <= thr, (q1 - q2) + (r1 - r2), e)


def _watertight(v0, v1, v2, ro, rd, t0, t1):
    """(N, T) watertight (PBRT shear) acceptance and t: shared edges and
    vertices never let a ray through. The corners v0, v1, v2 are (T, 3) or
    (N, T, 3)."""
    kz = torch.argmax(rd.abs(), dim=-1)
    kx = (kz + 1) % 3
    ky = (kx + 1) % 3

    def pick(v, k):
        return torch.where(k == 0, v[..., 0], torch.where(k == 1, v[..., 1], v[..., 2]))

    d = torch.stack([pick(rd, kx), pick(rd, ky), pick(rd, kz)], dim=-1)
    sx = (-d[:, 0] / d[:, 2])[:, None]
    sy = (-d[:, 1] / d[:, 2])[:, None]
    sz = (1.0 / d[:, 2])[:, None]
    kx, ky, kz = kx[:, None], ky[:, None], kz[:, None]

    def shear(p):
        pt = p - ro[:, None, :]
        px, py, pz = pick(pt, kx), pick(pt, ky), pick(pt, kz)
        return px + sx * pz, py + sy * pz, pz

    x0, y0, z0 = shear(v0)
    x1, y1, z1 = shear(v1)
    x2, y2, z2 = shear(v2)
    a0 = _edge(x1, y2, y1, x2)
    a1 = _edge(x2, y0, y2, x0)
    a2 = _edge(x0, y1, y0, x1)
    mixed = ((a0 < 0) | (a1 < 0) | (a2 < 0)) & ((a0 > 0) | (a1 > 0) | (a2 > 0))
    det = a0 + a1 + a2
    t_scaled = a0 * (z0 * sz) + a1 * (z1 * sz) + a2 * (z2 * sz)
    t = t_scaled / torch.where(det == 0, 1.0, det)
    ok = (~mixed) & (det.abs() > 0) & (t > t0) & (t < t1[:, None])
    return ok, t


class Triangles:
    """The scene's triangles for the reference's queries: corners v0, v1,
    v2 (T, 3) in the reference's dtype. Moeller-Trumbore takes e1 = v1 - v0
    and e2 = v2 - v0, the watertight test the corners themselves."""

    def __init__(self, v0, v1, v2, test: str, device):
        if test == "moller_trumbore":
            self.rows = (v0, v1 - v0, v2 - v0)
            self.test = _mt
        elif test == "watertight":
            self.rows = (v0, v1, v2)
            self.test = _watertight
        else:
            raise ValueError(f"triangle test {test!r}")
        self.blocked = v0.shape[0] > _BLOCKED_ABOVE
        if self.blocked:
            self._blocks(v0, v1, v2, device)

    def _blocks(self, v0, v1, v2, device):
        """Faces in Morton order of their centroids, BLOCK a block, each
        block's box padded by 1e-4 of the scene's extent (the cull only has
        to keep every face a ray can hit; the test decides)."""
        v0, v1, v2 = (x.float().cpu().numpy() for x in (v0, v1, v2))
        c = (v0 + v1 + v2) / 3.0
        lo, hi = c.min(0), c.max(0)
        q = ((c - lo) / np.maximum(hi - lo, 1e-12) * 1023).astype(np.uint64)

        def spread(x):
            x = (x | (x << np.uint64(16))) & np.uint64(0x030000FF)
            x = (x | (x << np.uint64(8))) & np.uint64(0x0300F00F)
            x = (x | (x << np.uint64(4))) & np.uint64(0x030C30C3)
            return (x | (x << np.uint64(2))) & np.uint64(0x09249249)

        code = (spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1))
                | (spread(q[:, 2]) << np.uint64(2)))
        order = np.argsort(code, kind="stable")
        nb = -(-order.size // BLOCK)
        ids = np.concatenate([order, np.full(nb * BLOCK - order.size, -1)]).reshape(nb, BLOCK)
        corners = np.stack([v0, v1, v2], axis=1)[np.where(ids < 0, order[-1], ids)]
        margin = 1e-4 * float(np.abs(np.stack([v0, v1, v2])).max())
        self.box_lo = torch.as_tensor(corners.min(axis=(1, 2)) - margin, device=device)
        self.box_hi = torch.as_tensor(corners.max(axis=(1, 2)) + margin, device=device)
        self.block_ids = torch.as_tensor(ids, device=device)        # -1: padding
        gather = torch.as_tensor(np.where(ids < 0, order[-1], ids), device=device)
        self.block_rows = tuple(x[gather] for x in self.rows)       # (nb, BLOCK, 3)

    def _pairs(self, ro, rd, t0, t1):
        """(ray, block) pairs whose padded box the ray may cross inside
        (t0, t1); a NaN slab keeps the pair."""
        inv = 1.0 / rd.float()
        o = ro.float()
        a = (self.box_lo[None] - o[:, None]) * inv[:, None]
        b = (self.box_hi[None] - o[:, None]) * inv[:, None]
        near = torch.minimum(a, b).amax(-1)
        far = torch.maximum(a, b).amin(-1)
        skip = (near > far) | (far < t0) | (near > t1.float()[:, None])
        return torch.nonzero(~skip, as_tuple=True)

    def _blocked_tests(self, ro, rd, t0, t1, pairs_per_batch=1 << 15):
        ray, blk = self._pairs(ro, rd, t0, t1)
        for s in range(0, ray.shape[0], pairs_per_batch):
            r, b = ray[s:s + pairs_per_batch], blk[s:s + pairs_per_batch]
            ok, t = self.test(*(x[b] for x in self.block_rows), ro[r], rd[r], t0, t1[r])
            yield r, b, ok & (self.block_ids[b] >= 0), t

    def closest(self, ro, rd, t0, t1):
        """(hit (N,) bool, face (N,) int64): the lowest id among the nearest
        accepted faces, 0 on a miss."""
        ro, rd, t1 = ro.detach(), rd.detach(), t1.detach()
        n = ro.shape[0]
        if not self.blocked:
            ok, t = self.test(*self.rows, ro, rd, t0, t1)
            best, face = torch.where(ok, t, torch.inf).min(dim=1)
            hit = torch.isfinite(best)
            return hit, torch.where(hit, face, 0)
        rays, ts, faces = [], [], []
        for r, b, ok, t in self._blocked_tests(ro, rd, t0, t1):
            pt, slot = torch.where(ok, t, torch.inf).min(dim=1)
            face = self.block_ids[b, slot]
            # a block's nearest at its lowest slot; the lowest face of equal t
            # among the blocks is taken below
            tie = torch.where(ok & (t == pt[:, None]), self.block_ids[b], face.max() + 1)
            face = tie.amin(dim=1)
            keep = torch.isfinite(pt)
            rays.append(r[keep])
            ts.append(pt[keep])
            faces.append(face[keep])
        best = torch.full((n,), torch.inf, dtype=ro.dtype, device=ro.device)
        winner = torch.zeros(n, dtype=torch.int64, device=ro.device)
        if rays:
            r, pt, face = torch.cat(rays), torch.cat(ts), torch.cat(faces)
            best = best.scatter_reduce(0, r, pt, "amin")
            at = pt == best[r]
            big = torch.iinfo(torch.int64).max
            winner = torch.full((n,), big, dtype=torch.int64, device=ro.device)
            winner = winner.scatter_reduce(0, r[at], face[at], "amin")
        hit = torch.isfinite(best)
        return hit, torch.where(hit, winner, 0)

    def occluded(self, ro, rd, t0, t1):
        ro, rd, t1 = ro.detach(), rd.detach(), t1.detach()
        if not self.blocked:
            ok, _ = self.test(*self.rows, ro, rd, t0, t1)
            return ok.any(dim=1)
        occ = torch.zeros(ro.shape[0], dtype=torch.bool, device=ro.device)
        for r, _, ok, _ in self._blocked_tests(ro, rd, t0, t1):
            occ[r[ok.any(dim=1)]] = True
        return occ


# ---------------------------------------------------------------- estimator

class Reference:
    """The reference renderer of one scene: `arrays` and `camera` as
    benchmark.reference.scene.load makes them, `settings` the
    configuration's (max_bounces, triangle_test, render: t_min, t_max,
    shadow_eps)."""

    def __init__(self, arrays, camera, settings, device, dtype=torch.float32):
        self.dtype, self.device = dtype, torch.device(device)
        f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device).to(dtype)  # noqa: E731
        i = lambda x: torch.as_tensor(np.asarray(x).astype(np.int64), device=device)  # noqa: E731
        self.faces, self.mat = i(arrays["faces"]), i(arrays["face_material"])
        self.sign = f(arrays["normal_sign"])
        self.emissive = i(arrays["emissive"])[self.mat] > 0
        self.sided = i(arrays["sided"])[self.mat] > 0
        self.light_faces, self.light_nfaces = i(arrays["light_faces"]), i(arrays["light_nfaces"])
        self.test = settings["triangle_test"]
        self.set_params(f(arrays["vertices"]), f(arrays["albedo"]))
        self.cam = dict(resolution=tuple(camera["resolution"]),
                        **{k: f(camera[k]) for k in ("iview", "fov_deg", "focal_dist",
                                                     "aperture")})
        self.bounces = int(settings["max_bounces"])
        r = settings["render"]
        self.t_min, self.t_max, self.shadow_eps = r["t_min"], r["t_max"], r["shadow_eps"]
        self.light_color = torch.tensor(LIGHT_COLOR, dtype=dtype, device=device)

    def set_params(self, vertices, albedo) -> None:
        """The per-face rows and the light faces' corners and albedo from
        (V, 3) vertices and (M, 3) albedo, which may require grad; the
        triangle tests take them detached (the hit selection carries no
        gradient)."""
        f, lf, mat = self.faces, self.light_faces, self.mat
        v0, v1, v2 = vertices[f[:, 0]], vertices[f[:, 1]], vertices[f[:, 2]]
        self.v0, self.e1, self.e2 = v0, v1 - v0, v2 - v0
        self.albedo = albedo[mat]
        self.light_em = albedo[mat[lf]]                       # (L, F, 3)
        self.light_corners = (v0[lf], v1[lf], v2[lf])         # (L, F, 3) each
        self.tris = Triangles(v0.detach(), v1.detach(), v2.detach(), self.test, self.device)

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
            emissive = self.emissive[tri]
            d1 = _dot(-rd, nrm)
            weight = torch.ones_like(d1) if bounce == 0 else d1
            add = (alive & hit & emissive & (d1 > 0))[:, None]
            radiance = radiance + torch.where(add, self.light_color * beta * weight[:, None], 0.0)
            alive = alive & hit & (~emissive)

            u1, u2 = uniforms(seed, pixel, sample, bounce, U_BSDF_0, dt)
            wi = _rotate_z_to(nrm, _cosine_hemisphere(u1, u2))
            cos_wi = _dot(nrm, wi)
            pdf = cos_wi.abs() * INV_PI
            scale = torch.clamp(cos_wi, min=0.0) / torch.where(pdf == 0, 1.0, pdf) * INV_PI
            new_beta = torch.where((cos_wi != 0)[:, None], self.albedo[tri] * scale[:, None], 0.0)
            beta = torch.where(alive[:, None], beta * new_beta, beta)

            p2, n2, em = self._light_point(pixel, sample, bounce, seed)
            to_light = p2 - p
            dist_sq = torch.clamp(_dot(to_light, to_light), min=1e-12)
            dist = torch.sqrt(dist_sq)
            wdir = to_light / dist[:, None]
            shadow_t1 = torch.where(alive, dist * (1.0 - self.shadow_eps), 0.0)
            occ = self.tris.occluded(p, wdir, self.t_min, shadow_t1)
            dot1, dot2 = _dot(nrm, wdir), _dot(n2, -wdir)
            ok = (alive & (~occ) & (dot1 > 0) & (dot2 > 0))[:, None]
            radiance = radiance + torch.where(ok, beta * (em * (dot1 * dot2 / dist_sq)[:, None]),
                                              0.0)
            ro = torch.where(alive[:, None], p, ro)
            rd = torch.where(alive[:, None], wi, rd)
        return radiance

    def _light_point(self, pixel, sample, bounce, seed):
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
        return p2, n2, self.light_em[li, fi]

    def pixel_sums(self, px, py, n_samples, seed, lanes=None):
        """((P, 3) sums, (P, 3) sums of squares), float32 NumPy: each pixel's
        radiance over samples 0 .. n_samples - 1, summed in sample order in
        float32 as a film adds passes; traced `lanes` (pixel, sample) pairs
        at a time."""
        lanes = lanes or (1 << 14 if self.tris.blocked else 1 << 16)
        p = px.shape[0]
        pxs = px.repeat_interleave(n_samples)
        pys = py.repeat_interleave(n_samples)
        ss = torch.arange(n_samples, device=px.device).repeat(p)
        out = torch.empty((p * n_samples, 3), dtype=torch.float32)
        for s in range(0, p * n_samples, lanes):
            sl = slice(s, s + lanes)
            out[sl] = self.trace(pxs[sl], pys[sl], ss[sl], seed).float().cpu()
        vals = out.numpy().reshape(p, n_samples, 3)
        acc = np.zeros((p, 3), np.float32)
        sq = np.zeros((p, 3), np.float32)
        for k in range(n_samples):
            acc += vals[:, k]
            sq += vals[:, k] * vals[:, k]
        return acc, sq
