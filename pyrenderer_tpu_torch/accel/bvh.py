"""BVH accelerator: SAH or Morton-ordered build, stackless escape-pointer
traversal.

Counterpart of pyrenderer_tpu/accel/bvh.py, the backend "bvh" that "auto"
takes past AUTO_BRUTE_MAX_TRIS on the CPU (core/integrator.accel_backend):

- build: the native 12-bucket SAH builder (native/bvh_builder.cpp) when it
  compiles, else a Morton-code sort with median splits (``build_lbvh``);
  both in NumPy/C++ on the host at scene-load time;
- layout: flattened pre-order nodes with escape pointers, as parallel
  arrays (``FlatBVH``);
- traversal: the JAX package runs one ``while_loop`` per ray under
  ``vmap``; here one lockstep walk over the rays still walking, in plain
  PyTorch. Every step takes each such ray one node further, in the same
  visit order (into the first child on a box hit, else along the escape
  pointer), with the same widened slab test and the same Moeller-Trumbore
  association (-inv * sum for t, u and v); a leaf's triangles update the
  best hit in leaf order with a strict ``t < min(t_best, t1)``, so the
  first triangle found keeps a tie. The faces are then the JAX package's.

On a GPU each step reads the device once (how many rays still walk), so
this backend is slow there; the GPU's default is the cluster sweep.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pyrenderer_tpu_torch.accel.clusters import GAMMA2_3

DEFAULT_LEAF_SIZE = 4


@dataclasses.dataclass(frozen=True)
class FlatBVH:
    """Parallel node arrays, pre-order, every field a tensor on one device.
    An inner node's first child is node + 1; ``escape`` is where to go on a
    miss (or after a leaf), -1 ends the walk."""

    bbox_min: torch.Tensor   # (M, 3) f32
    bbox_max: torch.Tensor   # (M, 3) f32
    first: torch.Tensor      # (M,) i32: first triangle in `order` (leaves), -1 inner
    count: torch.Tensor      # (M,) i32: leaf triangle count, 0 for inner nodes
    escape: torch.Tensor     # (M,) i32
    order: torch.Tensor      # (T,) i32: traversal position -> original face id
    leaf_size: int = DEFAULT_LEAF_SIZE

    @property
    def n_nodes(self) -> int:
        return self.bbox_min.shape[0]

    def to(self, device) -> "FlatBVH":
        return FlatBVH(*[getattr(self, f.name).to(device) for f in dataclasses.fields(self)
                         if f.name != "leaf_size"], leaf_size=self.leaf_size)


def _host(x, dtype):
    return np.asarray(x.detach().cpu().numpy() if torch.is_tensor(x) else x, dtype)


def _flat(bmin, bmax, first, count, escape, order, leaf_size) -> FlatBVH:
    return FlatBVH(*(torch.from_numpy(np.ascontiguousarray(a))
                     for a in (bmin, bmax, first, count, escape, order)), leaf_size=leaf_size)


def _morton3(x: np.ndarray) -> np.ndarray:
    """Interleave 10-bit coords -> 30-bit Morton codes. x: (T, 3) in [0, 1)."""
    q = np.clip((x * 1024.0).astype(np.uint32), 0, 1023)

    def spread(v):
        v = (v | (v << 16)) & np.uint32(0x030000FF)
        v = (v | (v << 8)) & np.uint32(0x0300F00F)
        v = (v | (v << 4)) & np.uint32(0x030C30C3)
        v = (v | (v << 2)) & np.uint32(0x09249249)
        return v

    return (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])


def build_bvh(vertices, faces, leaf_size: int = DEFAULT_LEAF_SIZE,
              method: str = "auto") -> FlatBVH:
    """Host-side build; the result is on the CPU (``FlatBVH.to`` moves it).

    method: "sah" (the native C++ SAH builder; raises if it cannot be
    built), "lbvh" (Python Morton median split), or "auto" (SAH when the
    native library builds, else LBVH)."""
    if method in ("auto", "sah"):
        from pyrenderer_tpu_torch import native

        tri = _host(vertices, np.float64)[_host(faces, np.int64)]
        out = native.build_sah_bvh_native(tri.min(axis=1).astype(np.float32),
                                          tri.max(axis=1).astype(np.float32), leaf_size)
        if out is not None:
            return _flat(out["bbox_min"], out["bbox_max"], out["first"], out["count"],
                         out["escape"], out["order"], leaf_size)
        if method == "sah":
            raise RuntimeError("native SAH builder unavailable (g++ failed)")
    return build_lbvh(vertices, faces, leaf_size)


def build_lbvh(vertices, faces, leaf_size: int = DEFAULT_LEAF_SIZE) -> FlatBVH:
    """Morton-ordered median-split build. vertices (V, 3), faces (T, 3),
    NumPy arrays or tensors; the JAX package's arrays bit for bit."""
    vertices = _host(vertices, np.float64)
    faces = _host(faces, np.int64)
    tri = vertices[faces]                       # (T, 3, 3)
    tri_min = tri.min(axis=1)
    tri_max = tri.max(axis=1)
    centroids = 0.5 * (tri_min + tri_max)
    lo = centroids.min(axis=0)
    span = np.maximum(centroids.max(axis=0) - lo, 1e-12)
    order = np.argsort(_morton3((centroids - lo) / span), kind="stable").astype(np.int32)

    t = faces.shape[0]
    max_nodes = 4 * t + 1
    bmin = np.empty((max_nodes, 3), np.float32)
    bmax = np.empty((max_nodes, 3), np.float32)
    first = np.full(max_nodes, -1, np.int32)
    count = np.zeros(max_nodes, np.int32)
    escape = np.full(max_nodes, -1, np.int32)
    n_nodes = 0

    # iterative pre-order build over ranges of the Morton-sorted order
    stack = [(0, t, -1)]  # (lo, hi, escape)
    while stack:
        lo_i, hi_i, esc = stack.pop()
        idx = n_nodes
        n_nodes += 1
        ids = order[lo_i:hi_i]
        bmin[idx] = tri_min[ids].min(axis=0)
        bmax[idx] = tri_max[ids].max(axis=0)
        escape[idx] = esc
        if hi_i - lo_i <= leaf_size:
            first[idx] = lo_i
            count[idx] = hi_i - lo_i
        else:
            mid = (lo_i + hi_i) // 2
            # pre-order: the left child is idx + 1 (pushed last, popped
            # first); its escape is the right child, idx + 1 + size(left)
            right_idx = idx + 1 + _subtree_size(mid - lo_i, leaf_size)
            stack.append((mid, hi_i, esc))          # right
            stack.append((lo_i, mid, right_idx))    # left
    assert n_nodes <= max_nodes
    return _flat(bmin[:n_nodes], bmax[:n_nodes], first[:n_nodes], count[:n_nodes],
                 escape[:n_nodes], order, leaf_size)


def _subtree_size(n_tris: int, leaf_size: int) -> int:
    """Node count of the deterministic median-split subtree over n_tris."""
    if n_tris <= leaf_size:
        return 1
    mid = n_tris // 2
    return 1 + _subtree_size(mid, leaf_size) + _subtree_size(n_tris - mid, leaf_size)


def _dot3(a, b):
    return (a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1]) + a[:, 2] * b[:, 2]


def _cross(a, b):
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=1)


def _slab_hit(bmin, bmax, o, inv_d, t0, t1):
    """Conservative slab test of one box per ray (reference
    bvh_taichi.py:169-190): the far distances widened by 1 + 2 gamma(3)."""
    lo = (bmin - o) * inv_d
    hi = (bmax - o) * inv_d
    t_near = torch.minimum(lo, hi)
    t_far = torch.maximum(lo, hi) * (1.0 + GAMMA2_3)
    tmin = torch.maximum(t_near.amax(dim=1), torch.full_like(t1, t0))
    tmax = torch.minimum(t_far.amin(dim=1), t1)
    return tmin <= tmax


def traverse(bvh: FlatBVH, tri_v0, tri_e1, tri_e2, ro, rd, t0, t1, any_hit=False):
    """Stackless closest-hit (or any-hit) walk, all rays in lockstep.

    tri_v0/e1/e2: (T, 3) in TRAVERSAL order (permuted by bvh.order).
    ro, rd: (N, 3); t1 scalar or (N,). Returns (hit (N,) bool, t (N,) with 0
    on a miss, face (N,) int32 original ids, 0 on a miss). An any-hit ray
    stops after the leaf in which it found a hit."""
    ro, rd = ro.detach(), rd.detach()
    n = ro.shape[0]
    dev = ro.device
    t1v = torch.as_tensor(t1, dtype=ro.dtype, device=dev).detach().expand(n)
    inv_d = 1.0 / torch.where(rd == 0, 1e-20, rd)
    n_tri = tri_v0.shape[0]
    count = bvh.count.to(torch.int64)
    first = bvh.first.to(torch.int64)
    escape = bvh.escape.to(torch.int64)
    cur = torch.zeros(n, dtype=torch.int64, device=dev)
    t_best = torch.full((n,), float("inf"), dtype=ro.dtype, device=dev)
    tri_best = torch.full((n,), -1, dtype=torch.int64, device=dev)
    walking = torch.arange(n, device=dev)
    while walking.numel():
        node = cur[walking]
        o, d, inv = ro[walking], rd[walking], inv_d[walking]
        limit = t1v[walking]
        tb, tri = t_best[walking], tri_best[walking]
        is_leaf = count[node] > 0
        hit_box = _slab_hit(bvh.bbox_min[node], bvh.bbox_max[node], o, inv, t0,
                            torch.minimum(tb, limit))
        leaf = (is_leaf & hit_box).nonzero()[:, 0]
        if leaf.numel():
            lo, ld, lim = o[leaf], d[leaf], limit[leaf]
            lt, ltri = tb[leaf], tri[leaf]
            base, cnt = first[node[leaf]], count[node[leaf]]
            for i in range(bvh.leaf_size):
                tj = torch.clamp(base + i, 0, n_tri - 1)
                v0, e1, e2 = tri_v0[tj], tri_e1[tj], tri_e2[tj]
                c_e1_d = _cross(e1, ld)
                det = _dot3(c_e1_d, e2)
                inv_det = 1.0 / torch.where(det == 0, 1.0, det)
                s = lo - v0
                c_s_e2 = _cross(s, e2)
                tt = -inv_det * _dot3(c_s_e2, e1)
                uu = -inv_det * _dot3(c_s_e2, ld)
                vv = inv_det * _dot3(c_e1_d, s)
                ok = ((i < cnt) & (det.abs() > 0) & (tt > t0) & (tt < torch.minimum(lt, lim))
                      & (uu >= 0) & (uu <= 1) & (vv >= 0) & (1 - uu - vv >= 0))
                lt = torch.where(ok, tt, lt)
                ltri = torch.where(ok, tj, ltri)
            tb = tb.index_put((leaf,), lt)
            tri = tri.index_put((leaf,), ltri)
            t_best[walking] = tb
            tri_best[walking] = tri
        # next node: into the first child on an inner box hit, else escape
        nxt = torch.where(hit_box & ~is_leaf, node + 1, escape[node])
        cur[walking] = nxt
        go_on = nxt >= 0
        if any_hit:
            go_on = go_on & (tri < 0)
        walking = walking[go_on]
    hit = tri_best >= 0
    face = torch.where(hit, bvh.order[tri_best.clamp(min=0)].to(torch.int64), 0)
    return hit, torch.where(hit, t_best, 0.0), face.to(torch.int32)
