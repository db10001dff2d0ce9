"""Cluster two-level acceleration structure for large scenes, and its twins.

Counterpart of pyrenderer_tpu/accel/clusters.py, the part the cluster sweep
needs. Triangles are ordered by a recursive largest-axis median split and
cut into CLUSTERS of 128; 16 clusters form a SUPERCLUSTER; both levels carry
axis-aligned boxes. The sweep (kernels/cluster.py, csrc/cluster.cu) walks
superclusters front to back, slab-tests their boxes and those of their 16
children against each ray's running closest t, and tests the 128 triangles
of every child it crosses. The kernels read compact copies of the two box
tables (32 bytes a box instead of a 512-byte row), so that the 16 children
of a supercluster are one 512-byte read; the binned prepass reads the
compact copy of the bin boxes likewise.

The build runs in NumPy on the host (scene-load time) and returns tensors;
the median split goes through the native C++ orderer (native/
cluster_order.cpp) when it compiles, and through the bit-identical Python
recursion otherwise. ``closest_hit_ref`` and ``occluded_ref`` are the plain
PyTorch twins of the two CUDA kernels: clusters in ascending index, a
strict ``<`` update, the first minimum inside a cluster -- so the result is
the exact minimum t, ties to the lowest slot. ``closest_hit_resume_ref`` is
the twin of the closest-hit kernel's resume mode (suspend/resume rounds):
the launch's front-to-back walk with carried state and a visit budget.

``ClusterChunks`` (``build_chunked_clusters``) cuts a scene into contiguous
face ranges of at most CHUNK_MAX_TRIS, one ClusterScene each, for backend
"cluster_chunked" (kernels/cluster.closest_hit_chunked). The JAX package
chunks scenes that overflow a TPU's VMEM; here chunking is explicit only.

The binned traversal (kernels/binned.py, csrc/binned.cu) groups BIN
adjacent clusters into a bin of BIN_TRIS triangles; ``bin_box`` holds the
bins' boxes.

Not ported: the ``bitw`` array of the TPU's bit packing and the dummy
child rows of its pair-peeled sweep.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from pyrenderer_tpu_torch.core.intersect import _mt_terms
from pyrenderer_tpu_torch.core.watertight import watertight_terms

LANE_TRIS = 128   # triangles per cluster
GROUP = 16        # clusters per supercluster
TRI_ROWS = 16     # rows per cluster in the packed (K*16, 128) table (9 used)
# clusters per bin of the binned traversal: 4 x 128 = 512 adjacent
# (median-split sibling) triangles. Read once at import, as the JAX package
# does; a ClusterScene must be built and traversed under the same value. The
# CUDA leaf kernels are compiled for 1, 2 and 4 (csrc/binned.cu
# leaf_kernel_for; PYRENDERER_BIN=1 or 2 is perf/binnedgran.py's knob).
BIN = int(os.environ.get("PYRENDERER_BIN", "4"))
BIN_TRIS = BIN * LANE_TRIS

MISS_T = 3.0e38
# floats per row of the compact box copies the cluster-sweep kernels read
# (csrc/cluster.cu kBoxRow): bmin.xyz | bmax.xyz | 0 | 0, 32 bytes
BOX_ROW = 8

# float32 machine-epsilon-based conservative bound, PBRT gamma(3)
# (pyrenderer_tpu/accel/bvh.py:32-35; reference mathematics/constants.py)
_MACHINE_EPS = np.float32(np.finfo(np.float32).eps * 0.5)
GAMMA2_3 = float(2.0 * (3.0 * _MACHINE_EPS) / (1.0 - 3.0 * _MACHINE_EPS))
# the slab test's far-distance widening as the float32 the kernel uses
SLAB_WIDEN = float(np.float32(1.0 + GAMMA2_3))


@dataclasses.dataclass(frozen=True)
class ClusterScene:
    """Clustered geometry, every field a tensor on one device.

    K = padded cluster count (a multiple of GROUP), S = K // GROUP, S_pad =
    S rounded up to a multiple of 32. Padded clusters and padded
    supercluster rows carry all-NaN boxes: every slab comparison against
    NaN is false, so the cull itself rejects padding. Padded triangle slots
    of a partly filled real cluster duplicate its last face (the same
    surface at the same t); fully padded clusters are zero-filled.
    """

    tri: torch.Tensor         # (K * TRI_ROWS, 128) f32: rows v0|e1|e2 (9) + pad
    child_box: torch.Tensor   # (K, 128) f32: one row per cluster, lanes
    #                           bmin.xyz|bmax.xyz (6 used)
    bin_box: torch.Tensor     # (KB_pad32, 128) f32: one row per bin of BIN
    #                           clusters, lanes 0..5 = bmin|bmax; NaN rows for
    #                           empty bins and for the padding to a multiple
    #                           of 32 bins
    super_box: torch.Tensor   # (6, S) f32: bmin.xyz|bmax.xyz per supercluster
    super_cols: torch.Tensor  # (S_pad, 128) f32: the same boxes one row each,
    #                           lanes 0..5, NaN rows past S
    child_box8: torch.Tensor  # (K, BOX_ROW) f32: child_box's first 8 lanes,
    #                           the copy the sweep kernels read
    super_cols8: torch.Tensor  # (S_pad, BOX_ROW) f32: super_cols' first 8
    #                            lanes, likewise
    bin_box8: torch.Tensor    # (KB_pad32, BOX_ROW) f32: bin_box's first 8
    #                           lanes, the copy the binned prepass reads
    order: torch.Tensor       # (K * 128,) i32: packed slot -> original face id
    world_lo: torch.Tensor    # (3,) f32 scene box corner (sort quantization)
    world_inv_span: torch.Tensor  # (3,) f32

    @property
    def n_superclusters(self) -> int:
        return self.super_box.shape[1]

    @property
    def n_clusters(self) -> int:
        return self.tri.shape[0] // TRI_ROWS

    def to(self, device) -> "ClusterScene":
        return ClusterScene(*[getattr(self, f.name).to(device)
                              for f in dataclasses.fields(self)])


@dataclasses.dataclass(frozen=True)
class ClusterChunks:
    """A scene as a tuple of ClusterScenes over contiguous face ranges,
    padded to equal triangle counts: chunk i holds the global faces
    [i * faces_per_chunk, (i + 1) * faces_per_chunk)."""

    chunks: tuple            # tuple[ClusterScene, ...]
    faces_per_chunk: int = 0

    @property
    def n_clusters(self) -> int:
        """Total clusters (what the sort and watertight policies read)."""
        return sum(c.n_clusters for c in self.chunks)

    def to(self, device) -> "ClusterChunks":
        return ClusterChunks(tuple(c.to(device) for c in self.chunks), self.faces_per_chunk)


# Largest triangle count of one chunk: the JAX package's value, set by a
# TPU's VMEM; not measured on this card.
CHUNK_MAX_TRIS = 160_000


def build_chunked_clusters(vertices, faces, max_tris: int = CHUNK_MAX_TRIS):
    """Host-side build of a ClusterChunks: contiguous face ranges of equal
    size, each chunk its own ClusterScene, the short last one padded with
    zero faces (v0 with e1 = e2 = 0: det == 0, never hit). A scene of at
    most `max_tris` faces gives a plain ClusterScene, as in the JAX
    package."""
    f = _host(faces)
    t = f.shape[0]
    n_chunks = -(-t // max_tris)
    if n_chunks <= 1:
        return build_clusters(vertices, faces)
    per = -(-t // n_chunks)
    chunks = []
    for i in range(n_chunks):
        fl = f[i * per:(i + 1) * per]
        pad = per - fl.shape[0]
        if pad:
            fl = np.concatenate([fl, np.zeros((pad, 3), f.dtype)])
        chunks.append(build_clusters(vertices, fl))
    return ClusterChunks(chunks=tuple(chunks), faces_per_chunk=per)


def _median_split_order(cent, leaf_size=LANE_TRIS):
    """Permutation putting spatially compact groups of `leaf_size`
    triangles into contiguous blocks: recursive largest-axis median split,
    the split point rounded to a leaf_size multiple so every block except
    the last is full. Recursion order doubles as the supercluster grouping
    (adjacent leaves share a subtree, hence a compact parent box). The
    native orderer gives the same permutation bit for bit, faster; the
    Python recursion below runs where it cannot be built."""
    from pyrenderer_tpu_torch import native

    order = native.cluster_median_order_native(cent, leaf_size)
    if order is not None:
        return order

    def split(idx):
        if idx.shape[0] <= leaf_size:
            return [idx]
        c = cent[idx]
        ax = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        idx = idx[np.argsort(c[:, ax], kind="stable")]
        half = idx.shape[0] // 2
        half = max(leaf_size, int(round(half / leaf_size)) * leaf_size)
        return split(idx[:half]) + split(idx[half:])

    return np.concatenate(split(np.arange(cent.shape[0], dtype=np.int64)))


def _host(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def build_clusters(vertices, faces) -> ClusterScene:
    """Host-side build: median-split order -> 128-tri clusters -> boxes.
    `vertices`/`faces` are NumPy arrays or tensors; the result is on the CPU
    (``ClusterScene.to`` moves it)."""
    v = _host(vertices).astype(np.float64)
    f = _host(faces).astype(np.int64)
    t = f.shape[0]
    tri = v[f]                                  # (T, 3, 3)
    tmin = tri.min(axis=1)
    tmax = tri.max(axis=1)
    order = _median_split_order(0.5 * (tmin + tmax))

    k_real = -(-t // LANE_TRIS)
    k = -(-k_real // GROUP) * GROUP
    s = k // GROUP

    # pad the order with duplicates of the last sorted face up to full
    # clusters; fully padded clusters are masked out by NaN boxes
    slots = k_real * LANE_TRIS
    order_p = np.concatenate([order, np.full(slots - t, order[-1], np.int64)])
    idx = order_p.reshape(k_real, LANE_TRIS)    # (K_real, 128) face ids

    fo = f[idx]                                  # (K_real, 128, 3)
    v0 = v[fo[:, :, 0]]
    e1 = v[fo[:, :, 1]] - v0
    e2 = v[fo[:, :, 2]] - v0
    planes = np.stack(
        [v0[..., 0], v0[..., 1], v0[..., 2],
         e1[..., 0], e1[..., 1], e1[..., 2],
         e2[..., 0], e2[..., 1], e2[..., 2]],
        axis=1,
    ).astype(np.float32)                         # (K_real, 9, 128)
    tri_rows = np.zeros((k, TRI_ROWS, LANE_TRIS), np.float32)
    tri_rows[:k_real, :9] = planes

    # one-ulp outward rounding: the f64 -> f32 casts of the boxes and of the
    # packed planes round independently; widening keeps every f32 triangle
    # inside its f32 box
    cmin = np.full((k, 3), np.inf, np.float32)
    cmax = np.full((k, 3), -np.inf, np.float32)
    cmin[:k_real] = np.nextafter(
        tmin[idx].min(axis=1).astype(np.float32), np.float32(-np.inf))
    cmax[:k_real] = np.nextafter(
        tmax[idx].max(axis=1).astype(np.float32), np.float32(np.inf))

    # supercluster boxes before the padding boxes become NaN (inf/-inf
    # padding vanishes under min/max here)
    smin = cmin.reshape(s, GROUP, 3).min(axis=1)
    smax = cmax.reshape(s, GROUP, 3).max(axis=1)
    super_box = np.concatenate([smin.T, smax.T], axis=0).astype(np.float32)

    # bin boxes the same way: padded clusters vanish, fully padded bins stay
    # inverted (inf/-inf) and become NaN
    kb = k // BIN
    bmin = cmin.reshape(kb, BIN, 3).min(axis=1)
    bmax = cmax.reshape(kb, BIN, 3).max(axis=1)
    empty = ~np.isfinite(bmin).all(axis=1)
    bin_box = np.zeros((-(-kb // 32) * 32, LANE_TRIS), np.float32)
    bin_box[:, 0:6] = np.nan
    bin_box[:kb, 0:3] = np.where(empty[:, None], np.nan, bmin)
    bin_box[:kb, 3:6] = np.where(empty[:, None], np.nan, bmax)

    cmin[k_real:] = np.nan
    cmax[k_real:] = np.nan
    child = np.zeros((k, LANE_TRIS), np.float32)
    child[:, 0:3] = cmin
    child[:, 3:6] = cmax

    s_pad = -(-s // 32) * 32
    super_cols = np.zeros((s_pad, LANE_TRIS), np.float32)
    super_cols[:, 0:6] = np.nan          # padded rows: NaN boxes never cross
    super_cols[:s, 0:3] = smin
    super_cols[:s, 3:6] = smax

    order_full = np.concatenate(
        [order_p, np.zeros((k - k_real) * LANE_TRIS, np.int64)]).astype(np.int32)

    wlo = tmin.min(axis=0)
    wspan = np.maximum(tmax.max(axis=0) - wlo, 1e-12)
    return ClusterScene(
        tri=torch.from_numpy(tri_rows.reshape(k * TRI_ROWS, LANE_TRIS)),
        child_box=torch.from_numpy(child),
        bin_box=torch.from_numpy(bin_box),
        super_box=torch.from_numpy(super_box),
        super_cols=torch.from_numpy(super_cols),
        child_box8=torch.from_numpy(np.ascontiguousarray(child[:, :BOX_ROW])),
        super_cols8=torch.from_numpy(np.ascontiguousarray(super_cols[:, :BOX_ROW])),
        bin_box8=torch.from_numpy(np.ascontiguousarray(bin_box[:, :BOX_ROW])),
        order=torch.from_numpy(order_full),
        world_lo=torch.from_numpy(wlo.astype(np.float32)),
        world_inv_span=torch.from_numpy((1.0 / wspan).astype(np.float32)),
    )


# ---------------------------------------------------------------------------
# wavefront ray sorting
# ---------------------------------------------------------------------------

def _spread2(v):
    """Interleave 10-bit lanes with 2 zero bits (int64 in, int64 out)."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def sort_keys(cs: ClusterScene, ro, rd):
    """(N,) int64 coherence keys, the JAX package's uint32 keys bit for bit:
    origin Morton cell (15 bits, 5 per axis, major) | quantized direction
    (9 bits, 3 per axis, minor). Rays sharing a key start in the same cell
    heading the same way. int64 because torch's uint32 shifts and compares
    are incomplete."""
    q = torch.clamp((ro - cs.world_lo) * cs.world_inv_span * 32.0, 0.0, 31.0)
    q = q.to(torch.int64)
    m = ((_spread2(q[:, 0]) << 2) | (_spread2(q[:, 1]) << 1)
         | _spread2(q[:, 2])) & 0x7FFF
    d8 = torch.clamp((rd + 1.0) * 4.0, 0.0, 7.0).to(torch.int64)
    dir9 = (d8[:, 0] << 6) | (d8[:, 1] << 3) | d8[:, 2]
    return (m << 9) | dir9


# ---------------------------------------------------------------------------
# plain PyTorch twins of the sweep kernels
# ---------------------------------------------------------------------------

def _slab(bmin, bmax, o, inv_d, t0, t1):
    """Slab test of one box, bmin/bmax (3,), against rays o, inv_d (N, 3)
    with per-ray t1 (N,); the trailing axis holds x, y, z, so (B, 3) boxes
    against (N, 1, 3) rays and (N, 1) t1 give the (N, B) grid. min/max
    propagate NaN, so a NaN box never crosses. The association is the
    kernels' (csrc/leaf.cuh slab)."""
    lo = (bmin - o) * inv_d
    hi = (bmax - o) * inv_d
    mn = torch.minimum(lo, hi)
    mx = torch.maximum(lo, hi)
    # clamp(min=) is max(x, t0) and keeps a NaN x, as torch.maximum does
    t_near = torch.maximum(torch.maximum(mn[..., 0], mn[..., 1]),
                           mn[..., 2].clamp(min=t0))
    t_far = torch.minimum(torch.minimum(mx[..., 0], mx[..., 1]), mx[..., 2]) * SLAB_WIDEN
    return t_near <= torch.minimum(t_far, t1)


def _leaf(rows, ro, rd, t0, t_lim, watertight):
    """(n, 128) accepted-t grid of one cluster, MISS_T where rejected.
    rows: the cluster's (TRI_ROWS, 128) table slice; t_lim (n,)."""
    v0, e1, e2 = rows[0:3].T, rows[3:6].T, rows[6:9].T
    if watertight:
        ok, t = watertight_terms(v0, v0 + e1, v0 + e2, ro, rd)
    else:
        det, t, u, v = _mt_terms(v0, e1, e2, ro, rd)
        ok = (det.abs() > 0) & (u >= 0) & (u <= 1) & (v >= 0) & (1.0 - u - v >= 0)
    ok = ok & (t > t0) & (t < t_lim[:, None])
    return torch.where(ok, t, MISS_T)


def closest_hit_ref(cs: ClusterScene, ro, rd, t0, t1, watertight=False):
    """Plain twin of the closest-hit sweep kernel: every cluster in
    ascending index, culled by its box against each ray's running bound
    min(t_best, t1), then an (n, 128) Moeller-Trumbore or watertight leaf
    over the rays that crossed it. Returns (hit (N,) bool, t (N,),
    slot (N,) int32), t = 0 and slot = -1 on a miss.

    Computing the leaf only for the rays that crossed the box gives the
    JAX twin's result (a culled ray's leaf is rejected there) at a
    fraction of its work."""
    ro, rd = ro.detach(), rd.detach()
    n = ro.shape[0]
    k = cs.n_clusters
    inv_d = 1.0 / torch.where(rd == 0, 1e-20, rd)
    t1v = torch.as_tensor(t1, dtype=ro.dtype, device=ro.device).detach().expand(n)
    t_best = torch.full((n,), MISS_T, dtype=ro.dtype, device=ro.device)
    slot_best = torch.full((n,), -1, dtype=torch.int32, device=ro.device)
    cmin, cmax = cs.child_box[:, 0:3], cs.child_box[:, 3:6]
    tri = cs.tri.reshape(k, TRI_ROWS, LANE_TRIS)
    for j in range(k):
        bound = torch.minimum(t_best, t1v)
        idx = _slab(cmin[j], cmax[j], ro, inv_d, t0, bound).nonzero()[:, 0]
        if idx.numel() == 0:
            continue
        tm = _leaf(tri[j], ro[idx], rd[idx], t0, bound[idx], watertight)
        t_new, lane = tm.min(dim=1)             # the first minimum
        old_t = t_best[idx]
        better = t_new < old_t
        t_best[idx] = torch.where(better, t_new, old_t)
        slot_best[idx] = torch.where(better, (j * LANE_TRIS + lane).to(torch.int32),
                                     slot_best[idx])
    hit = slot_best >= 0
    return hit, torch.where(hit, t_best, 0.0), slot_best


def occluded_ref(cs: ClusterScene, ro, rd, t0, t1, watertight=False):
    """Plain twin of the any-hit sweep kernel: True where some triangle of a
    crossed cluster lies in (t0, t1) -- the closest-hit twin's hit mask, as
    in the JAX package."""
    return closest_hit_ref(cs, ro, rd, t0, t1, watertight=watertight)[0]


def pack_key(t, slot):
    """int64 (float bits of t << 32 | slot as uint32) keys, csrc/leaf.cuh
    pack_key: for t > 0 the minimum key is the minimum t, ties to the
    lowest slot, and slot -1 (a miss) loses every tie."""
    return ((t.float().view(torch.int32).to(torch.int64) << 32)
            | (slot.to(torch.int64) & 0xFFFFFFFF))


def unpack_key(key):
    """(t float32, slot int32) of pack_key's keys."""
    low = key & 0xFFFFFFFF
    slot = torch.where(low >= 1 << 31, low - (1 << 32), low).to(torch.int32)
    return (key >> 32).to(torch.int32).view(torch.float32), slot


def closest_hit_resume_ref(cs: ClusterScene, rays, order, super_sorted, t_in, slot_in, t0,
                           budget, watertight=False):
    """Plain twin of one launch of the closest-hit kernel's resume mode
    (csrc/cluster.cu, Resume = true): the launch's walk, vectorised over
    rays. rays (N, 8) [o | d | t1 | 0] in launch order; order (S_pad,) and
    super_sorted (S_pad, >= 6) the launch's front-to-back supercluster rank
    (kernels/cluster._sc_order); t_in (N,) f32 and slot_in (N,) i32 the
    carried best hit (3e38 and -1: none). Returns (t (N,) f32, 3e38 on a
    miss; slot (N,) i32; done (N,) i32), all in launch order.

    A live ray (t1 > t0) starts from pack_key(t_in, slot_in) and walks the
    ranks in order. It visits a supercluster whose box crosses under its
    current bound min(t_best, t1); a visit slab-tests the 16 children in
    order, each under the current bound, and runs the leaf of each child
    that crosses: every triangle accepted against t1, the best hit the
    minimum key. With budget > 0 the ray stops after its budget-th visit;
    done is 0 when a later rank still crosses under its bound then, and 1
    otherwise (also for a ray that ran out of crossing ranks first, and
    for a dead ray, which keeps its carried state)."""
    ro, rd, t1 = rays[:, 0:3], rays[:, 3:6], rays[:, 6]
    n = rays.shape[0]
    inv_d = 1.0 / torch.where(rd == 0, 1e-20, rd)
    key = pack_key(t_in, slot_in)
    walking = t1 > t0
    stopped = torch.zeros(n, dtype=torch.bool, device=rays.device)
    pending = torch.zeros_like(stopped)
    visits = torch.zeros(n, dtype=torch.int64, device=rays.device)
    cmin, cmax = cs.child_box[:, 0:3], cs.child_box[:, 3:6]
    tri = cs.tri.reshape(cs.n_clusters, TRI_ROWS, LANE_TRIS)

    def bound(idx):
        return torch.minimum(unpack_key(key[idx])[0], t1[idx])

    for rank, s in enumerate(order.tolist()):
        every = torch.arange(n, device=rays.device)
        cross = _slab(super_sorted[rank, 0:3], super_sorted[rank, 3:6], ro, inv_d, t0,
                      bound(every))
        pending |= stopped & cross
        idx = (walking & cross).nonzero()[:, 0]
        if idx.numel() == 0:
            continue
        for j in range(s * GROUP, (s + 1) * GROUP):
            sub = idx[_slab(cmin[j], cmax[j], ro[idx], inv_d[idx], t0, bound(idx))]
            if sub.numel() == 0:
                continue
            t_new, lane = _leaf(tri[j], ro[sub], rd[sub], t0, t1[sub], watertight).min(dim=1)
            cand = pack_key(t_new, j * LANE_TRIS + lane)
            key[sub] = torch.where((t_new < MISS_T) & (cand < key[sub]), cand, key[sub])
        visits[idx] += 1
        if budget > 0:
            out = idx[visits[idx] == budget]
            walking[out] = False
            stopped[out] = True
    t, slot = unpack_key(key)
    return t, slot, (~pending).to(torch.int32)


def slot_to_face(cs: ClusterScene, slot):
    """Map packed (cluster*128 + lane) slots to original face ids (miss -> 0)."""
    return torch.where(slot >= 0, cs.order[slot.clamp(min=0).to(torch.int64)], 0)


def exact_t_for_slot(cs: ClusterScene, slot, ro, rd, t_leaf):
    """Moeller-Trumbore t of each ray's winning slot, re-derived from the
    packed table (one nine-element gather per ray), where the JAX kernel
    path restores its exact-t contract. Keeps `t_leaf` where the
    determinant vanishes (a watertight hit MT cannot re-derive)."""
    s = slot.clamp(min=0).to(torch.int64)
    base = (s // LANE_TRIS) * (TRI_ROWS * LANE_TRIS) + s % LANE_TRIS
    rows = cs.tri.reshape(-1)[base[:, None] + torch.arange(
        9, device=s.device) * LANE_TRIS].to(ro.dtype)       # (N, 9)
    v0, e1, e2 = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]
    c = torch.linalg.cross(e1, rd, dim=-1)
    det = c[:, 0] * e2[:, 0] + c[:, 1] * e2[:, 1] + c[:, 2] * e2[:, 2]
    q = torch.linalg.cross(ro - v0, e2, dim=-1)
    qe1 = q[:, 0] * e1[:, 0] + q[:, 1] * e1[:, 1] + q[:, 2] * e1[:, 2]
    t = -qe1 / torch.where(det == 0, 1.0, det)
    return torch.where(det != 0, t, t_leaf)
