"""Wavefront path-tracing integrator (PyTorch): the tables, the backends,
the "reference" estimator and the frame loop.

Counterpart of pyrenderer_tpu/core/integrator.py. Every bounce is one
batched closest-hit query and one shading step over the whole wavefront,
with terminated lanes masked instead of diverging; the bounce loop is a
Python loop (the JAX package's ``lax.scan``). The "pbrt" estimator's
bounce loop is core/integrator_pbrt.py; render_sample dispatches on
cfg.estimator.

Intersection backends:
  "cuda"       -- the hand-written whole-table kernels (kernels/intersect.py);
                  the counterpart of the TPU's "pallas". "auto" picks it for
                  CUDA tensors of scenes up to AUTO_BRUTE_MAX_TRIS faces.
  "brute"      -- the plain broadcast test (core/intersect.py). "auto" picks
                  it for CPU tensors of such scenes.
  "matmul"     -- the same test as one IEEE float32 matrix product of the
                  rays' features and the (16, 4T) coefficient matrix
                  (core/intersect.py: the JAX package's MXU formulation, a
                  jnp.dot outside any Pallas kernel there, torch.matmul
                  here). Explicit only: "auto" never picks it.
  "cluster"    -- the cluster sweep over a ClusterScene (accel/clusters.py):
                  the CUDA kernels of kernels/cluster.py on a GPU, their
                  plain twins on the CPU; cfg.cluster_rounds > 1 runs its
                  suspend/resume rounds. "auto" picks it above
                  AUTO_BRUTE_MAX_TRIS for CUDA tensors. It stays one
                  monolithic ClusterScene whatever the scene's size: the
                  JAX package chunks scenes past a TPU's VMEM, and one H100
                  holds the whole table.
  "cluster_chunked"
               -- the same sweep over a ClusterChunks (contiguous face
                  ranges of at most CHUNK_MAX_TRIS, one ClusterScene each),
                  chunk by chunk with the running best t carried. Explicit
                  only (or for a ClusterChunks given as `accel`).
  "bvh"        -- the stackless BVH walk (accel/bvh.py, plain PyTorch).
                  "auto" picks it above AUTO_BRUTE_MAX_TRIS for CPU
                  tensors, as the JAX package does off the TPU.
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

Gradients (torch autograd; dist/render.py's train_step takes them): the
image is differentiable w.r.t. the scene's vertices, albedo and emission
through the hit geometry re-derived from the face id (t, the hit point,
the normal), the packed face and light rows (core/bsdf.py's shading, the
light point, its normal and its area pdf, light_area_pdf) and the bounce
directions sampled from them. Detached, as the JAX package detaches them
with stop_gradient: the hit ids and hit masks, the visibility of the
shadow rays, and the shadow rays' origins, directions and extents. Every
kernel wrapper detaches its inputs, so backward launches no kernel. Where
torch's gradient convention at a tie differs from JAX's (clamp against
maximum, max(dim) against jnp.max, abs at 0), the code follows JAX's or
the tie carries no gradient (the comments say which).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from pyrenderer_tpu_torch import rng
from pyrenderer_tpu_torch.accel import bvh as bvh_mod
from pyrenderer_tpu_torch.accel.clusters import (
    ClusterChunks,
    build_chunked_clusters,
    build_clusters,
    sort_keys,
)
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

# the backends that trace a ClusterScene (a ClusterChunks for "cluster_chunked")
CLUSTER_BACKENDS = ("cluster", "cluster_binned", "cluster_streamed", "cluster_chunked")
BACKENDS = ("cuda", "brute", "matmul", "watertight", "bvh") + CLUSTER_BACKENDS

# JAX backends and the ROADMAP item that ports each one.
_NOT_PORTED = {
    "pallas": 'A4 (its port is backend "cuda")',
}


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def accel_backend(device) -> str:
    """Backend "auto" takes past AUTO_BRUTE_MAX_TRIS when no accelerator is
    given: "cluster" for CUDA tensors, "bvh" for CPU tensors, as the JAX
    package takes "cluster" on the TPU and "bvh" elsewhere."""
    return "cluster" if torch.device(device).type == "cuda" else "bvh"


def _cluster_impl_binned() -> bool:
    """PYRENDERER_CLUSTER_IMPL=binned: trace "cluster" queries with the
    binned traversal instead of the sweep (read at every resolve, as the
    JAX package does)."""
    return os.environ.get("PYRENDERER_CLUSTER_IMPL", "") == "binned"


def resolve_backend(backend: str, n_tris: int, device, accel=None) -> str:
    """Turn "auto" into "cuda" (CUDA device) or "brute" (CPU) up to
    AUTO_BRUTE_MAX_TRIS faces, and above into the backend of the given
    accelerator (a FlatBVH "bvh", a ClusterScene "cluster", a ClusterChunks
    "cluster_chunked") or, with none, into accel_backend(device); "cluster"
    into "cluster_binned" under PYRENDERER_CLUSTER_IMPL=binned. As in the
    JAX package, "cluster" or "cluster_chunked" with a ClusterChunks resolve
    to "cluster_chunked", and "cluster_chunked" with a ClusterScene to
    "cluster". Reject what is not ported instead of silently taking
    another path."""
    if backend in _NOT_PORTED:
        raise NotImplementedError(
            f"backend {backend!r} is not ported yet (ROADMAP {_NOT_PORTED[backend]})")
    if backend not in ("auto",) + BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "auto" and n_tris > AUTO_BRUTE_MAX_TRIS:
        if isinstance(accel, bvh_mod.FlatBVH):
            backend = "bvh"
        elif accel is not None:
            backend = "cluster"
        else:
            backend = accel_backend(device)
    if backend in ("cluster", "cluster_chunked") and accel is not None:
        backend = "cluster_chunked" if isinstance(accel, ClusterChunks) else "cluster"
    if backend == "cluster" and _cluster_impl_binned():
        return "cluster_binned"
    if backend != "auto":
        return backend
    return "cuda" if torch.device(device).type == "cuda" else "brute"


def resolve_cluster_sort(cfg: RenderConfig, accel) -> bool:
    """Concrete coherence-sort decision for a cluster query: "auto" sorts
    scenes of at least AUTO_SORT_MIN_CLUSTERS clusters, and never a
    ClusterChunks (the JAX package's choice, from a TPU measurement)."""
    if cfg.cluster_sort == "auto":
        if isinstance(accel, ClusterChunks):
            return False
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
    """The accelerator `backend` needs on the scene's device, built on the
    host: a FlatBVH for "bvh" (and for "auto" past AUTO_BRUTE_MAX_TRIS on
    the CPU), build_chunked_clusters' result for "cluster_chunked" (a plain
    ClusterScene when one chunk holds the scene), a ClusterScene for the
    other CLUSTER_BACKENDS (and for "auto" past AUTO_BRUTE_MAX_TRIS on
    CUDA); None for the whole-table backends. A given `accel` is returned
    as it is."""
    if accel is not None:
        return accel
    device = scene.vertices.device
    backend = resolve_backend(backend, scene.faces.shape[0], device)
    if backend == "bvh":
        return bvh_mod.build_bvh(scene.vertices, scene.faces).to(device)
    if backend == "cluster_chunked":
        return build_chunked_clusters(scene.vertices, scene.faces).to(device)
    if backend in CLUSTER_BACKENDS:
        return build_clusters(scene.vertices, scene.faces).to(device)
    return None


def check_supported(cfg: RenderConfig) -> None:
    """Raise for an estimator this port does not know."""
    if cfg.estimator not in ("reference", "pbrt"):
        raise ValueError(f"unknown estimator {cfg.estimator!r}")


def light_area_pdf(scene: Scene):
    """(T,) area-measure pdf of sampling each light face via the uniform
    prim -> uniform face -> uniform area chain: 1 / (L * nf * area).
    Zero on non-light faces. Each prim scatters its nf real faces only:
    light_faces pads a shorter row by repeating a face, and index_put
    would pass the gradient to every copy (the JAX package's scatter
    passes it to one)."""
    v = scene.vertices
    f = scene.faces
    e1 = v[f[:, 1]] - v[f[:, 0]]
    e2 = v[f[:, 2]] - v[f[:, 0]]
    area = 0.5 * torch.linalg.vector_norm(torch.linalg.cross(e1, e2, dim=-1), dim=-1)
    n_lights = scene.light_faces.shape[0]
    nfaces = scene.light_nfaces.tolist()
    pdf = torch.zeros(f.shape[0], dtype=v.dtype, device=v.device)
    for li in range(n_lights):  # tiny
        faces = scene.light_faces[li, :nfaces[li]]
        pdf = pdf.index_put(
            (faces,), 1.0 / (n_lights * nfaces[li] * sampling.maximum(area[faces], 1e-12)))
    return pdf


def pack_face_data(scene: Scene, extended: bool = False):
    """Per-face shading table, one row fetch per hit.

    Base (T, 16): v0|e1|e2|albedo|sign|emissive|sided|pad.
    Extended, for the pbrt estimator, (T, 24): ...|sided|mat_type|
    emission(3)|ior|roughness|light_pdf_A|pad(2)."""
    v = scene.vertices
    f = scene.faces
    v0 = v[f[:, 0]]
    mat = scene.face_material
    cols = [
        v0, v[f[:, 1]] - v0, v[f[:, 2]] - v0, scene.albedo[mat],
        scene.normal_sign[:, None].to(v.dtype),
        (scene.emissive[mat] > 0)[:, None].to(v.dtype),
        (scene.sided[mat] > 0)[:, None].to(v.dtype),
    ]
    if not extended:
        cols.append(v.new_zeros((f.shape[0], 1)))
    else:
        cols += [
            scene.mat_type[mat][:, None].to(v.dtype),
            scene.emission[mat],
            scene.ior[mat][:, None].to(v.dtype),
            scene.roughness[mat][:, None].to(v.dtype),
            light_area_pdf(scene)[:, None],
            v.new_zeros((f.shape[0], 2)),
        ]
    return torch.cat(cols, dim=1)


def pack_light_data(scene: Scene, use_emission: bool = False):
    """(L * F_max, 16) per-light-face table: v0|v1|v2|em|sign|pdf_A|pad.
    em is the emitter's albedo ("reference" estimator, reference
    core/bsdf.py:54) or its scene emission radiance (pbrt)."""
    v = scene.vertices
    lf = scene.light_faces.reshape(-1)
    f = scene.faces[lf]
    mat = scene.face_material[lf]
    em = scene.emission[mat] if use_emission else scene.albedo[mat]
    return torch.cat([
        v[f[:, 0]], v[f[:, 1]], v[f[:, 2]], em,
        scene.normal_sign[lf][:, None].to(v.dtype),
        light_area_pdf(scene)[lf][:, None],
        v.new_zeros((lf.shape[0], 2)),
    ], dim=1)


class TraceTables:
    """Per-scene device tables shared by every sample and pass: the packed
    face and light rows (extended for the pbrt estimator), for backend
    "cuda" the (9, T) kernel table, for "matmul" the (16, T, 4) coefficient
    matrix (differentiable w.r.t. the vertices), for "bvh" the FlatBVH (`accel`) and the
    triangles in its traversal order, for the CLUSTER_BACKENDS the
    ClusterScene or ClusterChunks (`accel`) with its resolved leaf choice
    and, for the sweep, sort choice (the binned backends need no sort), and
    the light color (made once: a host-to-device copy per trace would make
    the host wait for the device). The accelerator is built here
    (maybe_build_accel) unless `accel` gives one; the backend is resolved
    with it."""

    def __init__(self, scene: Scene, cfg: RenderConfig, backend: str = "auto",
                 accel=None):
        check_supported(cfg)
        v = scene.vertices
        self.accel = maybe_build_accel(scene, backend, accel)
        self.backend = resolve_backend(backend, scene.faces.shape[0], v.device, self.accel)
        self.light_color = torch.tensor(REF_LIGHT_COLOR, dtype=v.dtype, device=v.device)
        extended = cfg.estimator != "reference"
        self.face_data = pack_face_data(scene, extended=extended)
        self.light_data = pack_light_data(scene, use_emission=extended)
        self.tri_table = None
        if self.backend == "cuda":
            self.tri_table = kernels.pack_triangles(scene.vertices, scene.faces)
        elif self.backend == "matmul":
            self.tri_table = isect.build_tri_matrix(scene)
        elif self.backend == "bvh":
            ordered = scene.faces[self.accel.order.to(torch.int64)]
            vd = v.detach()
            self.bvh_v0 = vd[ordered[:, 0]]
            self.bvh_e1 = vd[ordered[:, 1]] - self.bvh_v0
            self.bvh_e2 = vd[ordered[:, 2]] - self.bvh_v0
        elif self.backend in CLUSTER_BACKENDS:
            self.cluster_sort = (self.backend in ("cluster", "cluster_chunked")
                                 and resolve_cluster_sort(cfg, self.accel))
            self.cluster_watertight = resolve_cluster_watertight(cfg, self.accel)

    def fetch_face(self, tri):
        """Packed shading row per hit id (a gather: the TPU's one-hot MXU
        fetch, core/lut.py, exists only for the TPU)."""
        return self.face_data.index_select(0, tri)


def _closest(scene, tables, cfg, ro, rd, t1, sort=None):
    """Closest-hit query of the tables' backend; `sort` overrides the
    cluster sweep's coherence sort (the wavefront sort turns it off)."""
    b = tables.backend
    if b == "cuda":
        return kernels.closest_hit(tables.tri_table, ro, rd, cfg.t_min, t1)
    if b == "matmul":
        return isect.intersect_matmul(scene, ro, rd, cfg.t_min, t1, tables.tri_table)
    if b in ("cluster", "cluster_chunked"):
        fn = (cluster_kernels.closest_hit if b == "cluster"
              else cluster_kernels.closest_hit_chunked)
        # exact_t=False: the trace re-derives the hit geometry from the face
        return fn(tables.accel, ro, rd, cfg.t_min, t1,
                  sort=tables.cluster_sort if sort is None else sort,
                  watertight=tables.cluster_watertight, exact_t=False,
                  rounds=cfg.cluster_rounds, budget=cfg.cluster_budget)
    if b == "bvh":
        return bvh_mod.traverse(tables.accel, tables.bvh_v0, tables.bvh_e1, tables.bvh_e2,
                                ro, rd, cfg.t_min, t1)
    if b in ("cluster_binned", "cluster_streamed"):
        return binned_kernels.closest_hit(
            tables.accel, ro, rd, cfg.t_min, t1, watertight=tables.cluster_watertight,
            streamed=b == "cluster_streamed", exact_t=False)
    if b == "watertight":
        return wt.intersect_watertight(scene, ro, rd, cfg.t_min, t1)
    return isect.intersect_brute(scene, ro, rd, cfg.t_min, t1)


def _any_hit(scene, tables, cfg, ro, rd, t1, sort=None):
    b = tables.backend
    if b == "cuda":
        return kernels.occluded(tables.tri_table, ro, rd, cfg.t_min, t1)
    if b == "matmul":
        return isect.occluded_matmul(scene, ro, rd, cfg.t_min, t1, tables.tri_table)
    if b in ("cluster", "cluster_chunked"):
        fn = (cluster_kernels.occluded if b == "cluster"
              else cluster_kernels.occluded_chunked)
        return fn(tables.accel, ro, rd, cfg.t_min, t1,
                  sort=tables.cluster_sort if sort is None else sort,
                  watertight=tables.cluster_watertight)
    if b == "bvh":
        return bvh_mod.traverse(tables.accel, tables.bvh_v0, tables.bvh_e1, tables.bvh_e2,
                                ro, rd, cfg.t_min, t1, any_hit=True)[0]
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


def use_wavefront_sort(tables: TraceTables) -> bool:
    """True when the bounce loop sorts the whole wavefront state once per
    bounce (PYRENDERER_WF_SORT=1, read at every trace) instead of letting
    each cluster query sort its own rays: only on backend "cluster" with
    its coherence sort on, as in the JAX package
    (pyrenderer_tpu/core/integrator.py:481-501). On the TPU it measured
    slower than the per-query sort; the default stays off."""
    if os.environ.get("PYRENDERER_WF_SORT", "0") != "1":
        return False
    return tables.backend == "cluster" and tables.cluster_sort


def wavefront_sort_perm(accel, ro, rd, alive):
    """(N,) permutation: live rays in coherence-key order
    (accel/clusters.sort_keys), dead lanes last; stable, so rays of equal
    keys keep their order from the bounce before."""
    keys = torch.where(alive, sort_keys(accel, ro.detach(), rd.detach()), 0xFFFFFFFF)
    return torch.argsort(keys, stable=True)


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

    Under use_wavefront_sort the whole state is re-sorted at the start of
    each bounce: pixel and sample ids travel with their lanes (the RNG is
    keyed on them, so each pixel's radiance is the same), and the radiance
    is scattered back to the caller's lane order at the end.

    With collect_paths, returns (radiance, records) instead: each bounce's
    hit records (the debug log of debug/logger.py), a dict of detached
    tensors stacked to (B, N, ...) in the caller's lane order: hit_point,
    normal, wi, t, tri, hit (the closest hit of a lane alive before the
    bounce), alive (after it), beta, radiance (running), nee_visible (the
    shadow ray of a live lane unoccluded) and light_point. The radiance is
    the one the call returns without them.
    """
    check_supported(cfg)
    dtype = ro.dtype
    if tables is None:
        tables = TraceTables(scene, cfg, backend)
    n = ro.shape[0]
    pixel_id = pixel_id.to(torch.int64).expand(n)
    light_color = tables.light_color
    wf_sort = use_wavefront_sort(tables)
    sort = False if wf_sort else None

    beta = torch.ones_like(ro)
    radiance = torch.zeros_like(ro)
    alive = torch.ones(n, dtype=torch.bool, device=ro.device)
    n_rays = torch.zeros((), dtype=torch.float32, device=ro.device)
    t_max = torch.full((), cfg.t_max, dtype=dtype, device=ro.device)
    if wf_sort:
        sample_id = torch.as_tensor(sample_id, device=ro.device).to(torch.int64).expand(n)
        orig = torch.arange(n, device=ro.device)
    records = []

    for bounce in range(cfg.max_bounces):
        if wf_sort:
            perm = wavefront_sort_perm(tables.accel, ro, rd, alive)
            ro, rd, beta, radiance, alive, pixel_id, sample_id, orig = (
                x[perm] for x in (ro, rd, beta, radiance, alive, pixel_id, sample_id, orig))
        alive_in = alive
        n_rays = n_rays + alive.sum(dtype=torch.float32)

        # dead lanes trace with t1 = 0: they can never hit, and every result
        # is masked by `alive` below anyway
        t_clip = torch.where(alive, t_max, 0.0)
        hit, _, tri = _closest(scene, tables, cfg, ro, rd, t_clip, sort=sort)
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
        # collapses to exactly 0. The abs and the clamp need not follow
        # jnp's gradient at n.wi == 0 (1 for abs, half for maximum): that
        # lane's new_beta is the constant 0
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
        dist_sq = sampling.maximum(_dot(to_light, to_light), 1e-12)
        dist = torch.sqrt(dist_sq)
        w = to_light / dist[:, None]
        shadow_t1 = torch.where(alive, dist.detach() * (1.0 - cfg.shadow_eps), 0.0)
        occ = _any_hit(scene, tables, cfg, p.detach(), w.detach(), shadow_t1, sort=sort)
        n_rays = n_rays + alive.sum(dtype=torch.float32)
        dot1 = _dot(nrm, w)
        dot2 = _dot(n2, -w)
        nee_ok = (alive & (~occ) & (dot1 > 0) & (dot2 > 0))[:, None]
        contrib = em * (dot1 * dot2 / dist_sq)[:, None]
        radiance = radiance + torch.where(nee_ok, beta * contrib, 0.0)

        ro = torch.where(alive[:, None], p, ro)
        rd = torch.where(alive[:, None], wi, rd)
        if collect_paths:
            rec = dict(hit_point=p, normal=nrm, wi=wi, t=t, tri=tri, hit=hit & alive_in,
                       alive=alive, beta=beta, radiance=radiance,
                       nee_visible=(~occ) & alive, light_point=p2)
            rec = {k: v.detach() for k, v in rec.items()}
            if wf_sort:
                # this bounce's lanes are in its sorted order: scatter each
                # record back to the caller's lane order
                rec = {k: torch.zeros_like(v).index_put((orig,), v) for k, v in rec.items()}
            records.append(rec)

    if wf_sort:
        # lanes end in the last bounce's order; orig maps each back
        radiance = torch.zeros_like(radiance).index_put((orig,), radiance)
    if collect_paths:
        return radiance, {k: torch.stack([r[k] for r in records]) for k in records[0]}
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
    """Radiance for one sample of a block of pixels; pixel_x/y: (N,) ints;
    sample_id: an int, or an (N,) integer tensor of per-pixel ids (the
    adaptive passes of render/driver.py). Traces with trace_reference or
    trace_pbrt, as cfg.estimator says. With with_stats, returns
    (radiance, rays_traced) as trace_reference."""
    w, _h = camera.resolution
    pixel_id = pixel_y.to(torch.int64) * w + pixel_x.to(torch.int64)
    strata = int(math.ceil(math.sqrt(cfg.spp))) if cfg.stratified else 0
    ro, rd = generate_rays(camera, pixel_x, pixel_y, sample_id, seed, strata=strata)
    if tables is None:
        tables = TraceTables(scene, cfg, backend, accel=accel)
    trace = trace_reference
    if cfg.estimator == "pbrt":
        from pyrenderer_tpu_torch.core.integrator_pbrt import trace_pbrt as trace
    return trace(scene, cfg, ro, rd, pixel_id, sample_id, seed, tables=tables,
                 with_stats=with_stats)


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
    invisible to the estimator: the RNG is keyed on pixel id). The
    accelerator the backend needs is built here unless `accel` gives one
    (maybe_build_accel)."""
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
