"""Wavefront path-tracing integrator, "reference" estimator (PyTorch).

Counterpart of pyrenderer_tpu/core/integrator.py. Every bounce is one
batched closest-hit query and one shading step over the whole wavefront,
with terminated lanes masked instead of diverging; the bounce loop is a
Python loop (the JAX package's ``lax.scan``).

Intersection backends:
  "cuda"       -- the hand-written whole-table kernels (kernels/intersect.py);
                  the counterpart of the TPU's "pallas". "auto" picks it for
                  CUDA tensors of scenes up to AUTO_BRUTE_MAX_TRIS faces.
  "brute"      -- the plain broadcast test (core/intersect.py). "auto" picks
                  it for CPU tensors of such scenes.
  "cluster"    -- the cluster sweep over a ClusterScene (accel/clusters.py):
                  the CUDA kernels of kernels/cluster.py on a GPU, their
                  plain twins on the CPU. "auto" picks it above
                  AUTO_BRUTE_MAX_TRIS on every device (the JAX package picks
                  "bvh" on the CPU, which is not ported yet, ROADMAP A10).
  "cluster_binned", "cluster_streamed"
               -- the binned (bin, ray) pair traversal over the same
                  ClusterScene (kernels/binned.py), overflow rays finished
                  by the sweep or by further peel rounds. No coherence sort.
                  PYRENDERER_CLUSTER_IMPL=binned turns "cluster", and
                  "auto" past AUTO_BRUTE_MAX_TRIS, into "cluster_binned", as
                  in the JAX package. "cluster_streamed" is never chosen
                  automatically: the JAX package routes there only for a
                  scene that overflows the TPU's VMEM, a ceiling this card
                  does not have (as in the JAX package off the TPU).
  "watertight" -- the plain broadcast watertight test (core/watertight.py).

The "reference" estimator reproduces the reference renderer's
core/tracing.py: emissive hits add the hardcoded light color (beta at
bounce 0, beta*cos after), the throughput update is
attenuation*cos/pdf*(1/pi) with the 0/0 guard collapsing to zero, and NEE
adds emissive*cos1*cos2/dist^2 without area pdf or 1/pi.

The hit selection is discrete and detached; the hit geometry is then
re-derived from the face id in differentiable torch, as in the JAX path.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from pyrenderer_tpu_torch import rng
from pyrenderer_tpu_torch.accel.clusters import build_clusters
from pyrenderer_tpu_torch.config import RenderConfig
from pyrenderer_tpu_torch.core import intersect as isect
from pyrenderer_tpu_torch.core import sampling
from pyrenderer_tpu_torch.core import watertight as wt
from pyrenderer_tpu_torch.core.camera import generate_rays, morton_pixel_order
from pyrenderer_tpu_torch.core.sampling import INV_PI
from pyrenderer_tpu_torch.kernels import binned as binned_kernels
from pyrenderer_tpu_torch.kernels import cluster as cluster_kernels
from pyrenderer_tpu_torch.kernels import intersect as kernels
from pyrenderer_tpu_torch.scene.types import Camera, Scene

# Reference tracing.py:120 -- emissive surfaces contribute this hardcoded
# color in "reference" estimator mode (scene emission is ignored there).
REF_LIGHT_COLOR = (0.9, 0.85, 0.7)

# Largest triangle count the whole-table paths serve; above it "auto"
# switches to the cluster sweep. The value is the TPU's crossover, kept for
# parity; not measured on this card.
AUTO_BRUTE_MAX_TRIS = 4096

# cluster_sort="auto" and cluster_watertight="auto" switch on for scenes of
# at least this many 128-triangle clusters (~32k triangles), as in the JAX
# package. For the sort it is the TPU's crossover, not measured on this
# card; for the watertight leaves it is a policy that changes the image
# and stays as the reference has it.
AUTO_SORT_MIN_CLUSTERS = 256

# the backends that trace a ClusterScene
CLUSTER_BACKENDS = ("cluster", "cluster_binned", "cluster_streamed")
BACKENDS = ("cuda", "brute", "watertight") + CLUSTER_BACKENDS

# JAX backends and the ROADMAP item that ports each one.
_NOT_PORTED = {
    "pallas": 'A4 (its port is backend "cuda")',
    "matmul": "A14",
    "bvh": "A10",
    "cluster_chunked": "A10",
}


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def accel_backend() -> str:
    """Backend "auto" takes past AUTO_BRUTE_MAX_TRIS: "cluster" on every
    device. The JAX package takes "bvh" on the CPU; that backend is not
    ported yet (ROADMAP A10), so the CPU runs the cluster twins."""
    return "cluster"


def _cluster_impl_binned() -> bool:
    """PYRENDERER_CLUSTER_IMPL=binned: trace "cluster" queries with the
    binned traversal instead of the sweep (read at every resolve, as the
    JAX package does)."""
    return os.environ.get("PYRENDERER_CLUSTER_IMPL", "") == "binned"


def resolve_backend(backend: str, n_tris: int, device) -> str:
    """Turn "auto" into "cuda" (CUDA device) or "brute" (CPU) up to
    AUTO_BRUTE_MAX_TRIS faces and into accel_backend() above, and "cluster"
    into "cluster_binned" under PYRENDERER_CLUSTER_IMPL=binned; reject what
    is not ported instead of silently taking another path."""
    if backend in _NOT_PORTED:
        raise NotImplementedError(
            f"backend {backend!r} is not ported yet (ROADMAP {_NOT_PORTED[backend]})")
    if backend not in ("auto",) + BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "auto" and n_tris > AUTO_BRUTE_MAX_TRIS:
        backend = accel_backend()
    if backend == "cluster" and _cluster_impl_binned():
        return "cluster_binned"
    if backend != "auto":
        return backend
    return "cuda" if torch.device(device).type == "cuda" else "brute"


def resolve_cluster_sort(cfg: RenderConfig, accel) -> bool:
    """Concrete coherence-sort decision for a cluster query: "auto" sorts
    scenes of at least AUTO_SORT_MIN_CLUSTERS clusters."""
    if cfg.cluster_sort == "auto":
        return accel.n_clusters >= AUTO_SORT_MIN_CLUSTERS
    return bool(cfg.cluster_sort)


def resolve_cluster_watertight(cfg: RenderConfig, accel) -> bool:
    """Concrete leaf decision for a cluster query: "auto" takes the
    watertight (leak-free) leaves for scenes of at least
    AUTO_SORT_MIN_CLUSTERS clusters and Moeller-Trumbore below, as the JAX
    package does."""
    if cfg.cluster_watertight == "auto":
        return accel.n_clusters >= AUTO_SORT_MIN_CLUSTERS
    return bool(cfg.cluster_watertight)


def maybe_build_accel(scene: Scene, backend: str, accel=None):
    """The accelerator `backend` needs on the scene's device: a ClusterScene
    for the CLUSTER_BACKENDS (and for "auto" past AUTO_BRUTE_MAX_TRIS),
    built on the host; None for the whole-table backends. A given `accel`
    is returned as it is."""
    if accel is not None:
        return accel
    device = scene.vertices.device
    if resolve_backend(backend, scene.faces.shape[0], device) not in CLUSTER_BACKENDS:
        return None
    return build_clusters(scene.vertices, scene.faces).to(device)


def check_supported(cfg: RenderConfig) -> None:
    """Raise for configuration options this port does not implement yet."""
    if cfg.estimator != "reference":
        raise NotImplementedError(
            f"estimator {cfg.estimator!r} is not ported yet (ROADMAP A8); "
            "use estimator='reference'")
    if cfg.adaptive:
        raise NotImplementedError("adaptive sampling is not ported yet (ROADMAP A6)")
    if cfg.cluster_rounds > 1:
        raise NotImplementedError(
            "suspend/resume cluster traversal (cluster_rounds > 1) is not "
            "ported yet (ROADMAP A10)")
    if os.environ.get("PYRENDERER_WF_SORT", "0") == "1":
        raise NotImplementedError(
            "the wavefront sort (PYRENDERER_WF_SORT=1) is not ported yet "
            "(ROADMAP A10)")


def light_area_pdf(scene: Scene):
    """(T,) area-measure pdf of sampling each light face via the uniform
    prim -> uniform face -> uniform area chain: 1 / (L * nf * area).
    Zero on non-light faces."""
    v = scene.vertices
    f = scene.faces
    e1 = v[f[:, 1]] - v[f[:, 0]]
    e2 = v[f[:, 2]] - v[f[:, 0]]
    area = 0.5 * torch.linalg.vector_norm(torch.linalg.cross(e1, e2, dim=-1), dim=-1)
    n_lights = scene.light_faces.shape[0]
    nfaces = scene.light_nfaces.tolist()
    pdf = torch.zeros(f.shape[0], dtype=v.dtype, device=v.device)
    for li in range(n_lights):  # tiny
        faces = scene.light_faces[li]
        pdf = pdf.index_put(
            (faces,), 1.0 / (n_lights * nfaces[li] * torch.clamp(area[faces], min=1e-12)))
    return pdf


def pack_face_data(scene: Scene):
    """(T, 16) per-face shading table, one row fetch per hit:
    v0|e1|e2|albedo|sign|emissive|sided|pad. (The pbrt estimator's extended
    (T, 24) table comes with ROADMAP A8.)"""
    v = scene.vertices
    f = scene.faces
    v0 = v[f[:, 0]]
    mat = scene.face_material
    return torch.cat([
        v0, v[f[:, 1]] - v0, v[f[:, 2]] - v0, scene.albedo[mat],
        scene.normal_sign[:, None].to(v.dtype),
        (scene.emissive[mat] > 0)[:, None].to(v.dtype),
        (scene.sided[mat] > 0)[:, None].to(v.dtype),
        v.new_zeros((f.shape[0], 1)),
    ], dim=1)


def pack_light_data(scene: Scene):
    """(L * F_max, 16) per-light-face table: v0|v1|v2|em|sign|pdf_A|pad,
    em = the emitter's albedo ("reference" estimator; pbrt's scene emission
    comes with ROADMAP A8)."""
    v = scene.vertices
    lf = scene.light_faces.reshape(-1)
    f = scene.faces[lf]
    mat = scene.face_material[lf]
    return torch.cat([
        v[f[:, 0]], v[f[:, 1]], v[f[:, 2]], scene.albedo[mat],
        scene.normal_sign[lf][:, None].to(v.dtype),
        light_area_pdf(scene)[lf][:, None],
        v.new_zeros((lf.shape[0], 2)),
    ], dim=1)


class TraceTables:
    """Per-scene device tables shared by every sample and pass: the packed
    face and light rows, for backend "cuda" the (9, T) kernel table, for the
    CLUSTER_BACKENDS the ClusterScene (`accel`, built here unless given)
    with its resolved leaf choice and, for "cluster", sort choice (the
    binned backends need no sort), and the light color (made once: a
    host-to-device copy per trace would make the host wait for the
    device)."""

    def __init__(self, scene: Scene, cfg: RenderConfig, backend: str = "auto",
                 accel=None):
        check_supported(cfg)
        v = scene.vertices
        self.backend = resolve_backend(backend, scene.faces.shape[0], v.device)
        self.light_color = torch.tensor(REF_LIGHT_COLOR, dtype=v.dtype, device=v.device)
        self.face_data = pack_face_data(scene)
        self.light_data = pack_light_data(scene)
        self.tri_table = None
        self.accel = None
        if self.backend == "cuda":
            self.tri_table = kernels.pack_triangles(scene.vertices, scene.faces)
        elif self.backend in CLUSTER_BACKENDS:
            self.accel = maybe_build_accel(scene, self.backend, accel)
            self.cluster_sort = (self.backend == "cluster"
                                 and resolve_cluster_sort(cfg, self.accel))
            self.cluster_watertight = resolve_cluster_watertight(cfg, self.accel)

    def fetch_face(self, tri):
        """Packed shading row per hit id (a gather: the TPU's one-hot MXU
        fetch, core/lut.py, exists only for the TPU)."""
        return self.face_data.index_select(0, tri)


def _closest(scene, tables, cfg, ro, rd, t1):
    b = tables.backend
    if b == "cuda":
        return kernels.closest_hit(tables.tri_table, ro, rd, cfg.t_min, t1)
    if b == "cluster":
        # exact_t=False: the trace re-derives the hit geometry from the face
        return cluster_kernels.closest_hit(
            tables.accel, ro, rd, cfg.t_min, t1, sort=tables.cluster_sort,
            watertight=tables.cluster_watertight, exact_t=False)
    if b in ("cluster_binned", "cluster_streamed"):
        return binned_kernels.closest_hit(
            tables.accel, ro, rd, cfg.t_min, t1, watertight=tables.cluster_watertight,
            streamed=b == "cluster_streamed", exact_t=False)
    if b == "watertight":
        return wt.intersect_watertight(scene, ro, rd, cfg.t_min, t1)
    return isect.intersect_brute(scene, ro, rd, cfg.t_min, t1)


def _any_hit(scene, tables, cfg, ro, rd, t1):
    b = tables.backend
    if b == "cuda":
        return kernels.occluded(tables.tri_table, ro, rd, cfg.t_min, t1)
    if b == "cluster":
        return cluster_kernels.occluded(
            tables.accel, ro, rd, cfg.t_min, t1, sort=tables.cluster_sort,
            watertight=tables.cluster_watertight)
    if b in ("cluster_binned", "cluster_streamed"):
        return binned_kernels.occluded(
            tables.accel, ro, rd, cfg.t_min, t1, watertight=tables.cluster_watertight,
            streamed=b == "cluster_streamed")
    if b == "watertight":
        return wt.occluded_watertight(scene, ro, rd, cfg.t_min, t1)
    return isect.occluded(scene, ro, rd, cfg.t_min, t1)


def _sample_light_point(scene, tables, pixel_id, sample_id, bounce, seed, dtype):
    """Uniform light prim -> uniform face -> sqrt-barycentric point
    (reference intersection_taichi.py:194 sample_a_light -> shapes.py:63
    sample_a_point). One packed-row gather per ray.
    Returns (p2, n2, em, pdf_a)."""
    n_lights, f_max = scene.light_faces.shape
    if n_lights > 1:
        up = rng.uniform(seed, pixel_id, sample_id, bounce, rng.U_LIGHT_PRIM, dtype)
        li = torch.clamp((up * n_lights).to(torch.int64), 0, n_lights - 1)
    else:
        li = torch.zeros_like(pixel_id)
    nfaces = scene.light_nfaces[li]
    uf = rng.uniform(seed, pixel_id, sample_id, bounce, rng.U_LIGHT_FACE, dtype)
    fi = torch.minimum(torch.clamp((uf * nfaces.to(dtype)).to(torch.int64), min=0),
                       nfaces - 1)
    row = tables.light_data.index_select(0, li * f_max + fi)  # (N, 16)
    v0, v1, v2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
    em = row[:, 9:12]
    sign = row[:, 12]
    pdf_a = row[:, 13]
    u, v = rng.uniform2(seed, pixel_id, sample_id, bounce, rng.U_LIGHT_U, dtype)
    p2 = sampling.sample_triangle_point(v0, v1, v2, u, v)
    n2 = sign[:, None] * sampling.safe_normalize(torch.linalg.cross(v1 - v0, v2 - v0, dim=-1))
    return p2, n2, em, pdf_a


def trace_reference(
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
    collect_paths: bool = False,
):
    """Radiance for a wavefront of rays, "reference" estimator semantics.

    ro, rd: (N, 3); pixel_id: (N,) integer tensor; sample_id: int or (N,).
    Returns (N, 3), or (radiance, rays_traced) when with_stats:
    rays_traced (a 0-d float32 tensor, not synchronised) counts the
    closest-hit rays of live lanes plus the NEE shadow rays -- the
    Mrays/s numerator of bench.py; masked dead lanes are not counted
    although their work still happens.
    """
    if collect_paths:
        raise NotImplementedError("collect_paths (debug path records) is not "
                                  "ported yet (ROADMAP A12)")
    check_supported(cfg)
    dtype = ro.dtype
    if tables is None:
        tables = TraceTables(scene, cfg, backend)
    n = ro.shape[0]
    pixel_id = pixel_id.to(torch.int64).expand(n)
    light_color = tables.light_color

    beta = torch.ones_like(ro)
    radiance = torch.zeros_like(ro)
    alive = torch.ones(n, dtype=torch.bool, device=ro.device)
    n_rays = torch.zeros((), dtype=torch.float32, device=ro.device)
    t_max = torch.full((), cfg.t_max, dtype=dtype, device=ro.device)

    for bounce in range(cfg.max_bounces):
        n_rays = n_rays + alive.sum(dtype=torch.float32)

        # dead lanes trace with t1 = 0: they can never hit, and every result
        # is masked by `alive` below anyway
        t_clip = torch.where(alive, t_max, 0.0)
        hit, _, tri = _closest(scene, tables, cfg, ro, rd, t_clip)
        tri = torch.clamp(tri, min=0).to(torch.int64)

        # packed-row fetch, then differentiable re-evaluation of the selected
        # triangle's geometry (the selection itself is detached)
        row = tables.fetch_face(tri)
        v0, e1, e2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
        albedo = row[:, 9:12]
        sign = row[:, 12]
        emissive = row[:, 13] > 0.5
        sided = row[:, 14] > 0.5

        c_e1_d = torch.linalg.cross(e1, rd, dim=-1)
        det = _dot(c_e1_d, e2)
        safe_det = torch.where(det == 0, 1.0, det)
        s = ro - v0
        c_s_e2 = torch.linalg.cross(s, e2, dim=-1)
        t = -_dot(c_s_e2, e1) / safe_det
        p = ro + t[:, None] * rd

        n_geo = sign[:, None] * sampling.safe_normalize(torch.linalg.cross(e1, e2, dim=-1))
        flip = (~sided) & (_dot(n_geo, -rd) < 0)
        nrm = torch.where(flip[:, None], -n_geo, n_geo)

        # emissive hit (reference tracing.py:129-139): hardcoded light color,
        # weight 1 at bounce 0, cos afterwards; the path terminates either way
        d1 = _dot(-rd, nrm)
        is_light_hit = alive & hit & emissive
        le_weight = torch.ones_like(d1) if bounce == 0 else d1
        add_light = (is_light_hit & (d1 > 0))[:, None]
        radiance = radiance + torch.where(add_light, light_color * beta * le_weight[:, None], 0.0)

        alive = alive & hit & (~emissive)

        # Lambert cosine sample in the shading frame; pdf = |n.wi|/pi
        u1, u2 = rng.uniform2(seed, pixel_id, sample_id, bounce, rng.U_BSDF_0, dtype)
        wi = sampling.rotate_z_to(nrm, sampling.cosine_sample_hemisphere(u1, u2))
        cos_wi = _dot(nrm, wi)
        pdf = cos_wi.abs() * INV_PI

        # tracing.py:145-149: attenuation*cos/pdf*(1/pi); 0/0 when n.wi == 0
        # collapses to exactly 0
        safe_pdf = torch.where(pdf == 0, 1.0, pdf)
        scale = torch.clamp(cos_wi, min=0.0) / safe_pdf * INV_PI
        new_beta = torch.where((cos_wi != 0)[:, None], albedo * scale[:, None], 0.0)
        beta = torch.where(alive[:, None], beta * new_beta, beta)

        # NEE (reference tracing.py:92-108): one light point, geometric
        # coupling emissive*cos1*cos2/dist^2, visibility by a shadow ray
        # ending a relative margin short of the light
        p2, n2, em, _ = _sample_light_point(
            scene, tables, pixel_id, sample_id, bounce, seed, dtype)
        to_light = p2 - p
        dist_sq = torch.clamp(_dot(to_light, to_light), min=1e-12)
        dist = torch.sqrt(dist_sq)
        w = to_light / dist[:, None]
        shadow_t1 = torch.where(alive, dist.detach() * (1.0 - cfg.shadow_eps), 0.0)
        occ = _any_hit(scene, tables, cfg, p.detach(), w.detach(), shadow_t1)
        n_rays = n_rays + alive.sum(dtype=torch.float32)
        dot1 = _dot(nrm, w)
        dot2 = _dot(n2, -w)
        nee_ok = (alive & (~occ) & (dot1 > 0) & (dot2 > 0))[:, None]
        contrib = em * (dot1 * dot2 / dist_sq)[:, None]
        radiance = radiance + torch.where(nee_ok, beta * contrib, 0.0)

        ro = torch.where(alive[:, None], p, ro)
        rd = torch.where(alive[:, None], wi, rd)

    if with_stats:
        return radiance, n_rays
    return radiance


def render_sample(
    scene: Scene,
    camera: Camera,
    cfg: RenderConfig,
    seed: int,
    sample_id,
    pixel_x,
    pixel_y,
    tables: TraceTables | None = None,
    backend: str = "auto",
    with_stats: bool = False,
    accel=None,
):
    """Radiance for one sample of a block of pixels; pixel_x/y: (N,) ints.
    With with_stats, returns (radiance, rays_traced) as trace_reference."""
    w, _h = camera.resolution
    pixel_id = pixel_y.to(torch.int64) * w + pixel_x.to(torch.int64)
    strata = int(math.ceil(math.sqrt(cfg.spp))) if cfg.stratified else 0
    ro, rd = generate_rays(camera, pixel_x, pixel_y, sample_id, seed, strata=strata)
    if tables is None:
        tables = TraceTables(scene, cfg, backend, accel=accel)
    return trace_reference(scene, cfg, ro, rd, pixel_id, sample_id, seed,
                           tables=tables, with_stats=with_stats)


def render_block(scene, camera, cfg: RenderConfig, seed: int, spp: int,
                 pixel_x, pixel_y, backend: str = "auto",
                 tables: TraceTables | None = None, accel=None):
    """Mean radiance over `spp` samples for a block of pixels."""
    if tables is None:
        tables = TraceTables(scene, cfg, backend, accel=accel)
    total = torch.zeros((pixel_x.shape[0], 3), dtype=camera.iview.dtype,
                        device=pixel_x.device)
    for s in range(spp):
        total = total + render_sample(scene, camera, cfg, seed, s, pixel_x,
                                      pixel_y, tables=tables)
    return total / spp


def render_image(scene: Scene, camera: Camera, cfg: RenderConfig,
                 chunk: int = 1 << 16, backend: str = "auto", accel=None):
    """Full-frame mean-radiance HDR image (H, W, 3) on the scene's device,
    row 0 at the top.

    `scene` and `camera` hold tensors on one device (scene.types.to_device).
    Pixels are traced in Morton order, `chunk` rays per block (the order is
    invisible to the estimator: the RNG is keyed on pixel id). Scenes past
    AUTO_BRUTE_MAX_TRIS build their ClusterScene here unless `accel` gives
    one."""
    device = scene.vertices.device
    tables = TraceTables(scene, cfg, backend, accel=accel)
    w, h = camera.resolution
    perm, inv_perm = morton_pixel_order(w, h)
    ys, xs = np.mgrid[0:h, 0:w]
    xs = torch.as_tensor(xs.reshape(-1)[perm], device=device)
    ys = torch.as_tensor(ys.reshape(-1)[perm], device=device)
    out = [
        render_block(scene, camera, cfg, cfg.seed, cfg.spp,
                     xs[start:start + chunk], ys[start:start + chunk],
                     tables=tables)
        for start in range(0, w * h, chunk)
    ]
    img = torch.cat(out)[torch.as_tensor(inv_perm, device=device)].reshape(h, w, 3)
    # pixel y counts up from the bottom; flip so row 0 is the top
    return img.flip(0)
