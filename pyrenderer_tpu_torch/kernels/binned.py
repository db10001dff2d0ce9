"""Binned (bin, ray) pair traversal: CUDA kernels, their twins, and the glue.

Counterpart of pyrenderer_tpu/kernels/pallas_binned.py. A bin is BIN
adjacent clusters of an accel/clusters.ClusterScene (512 triangles). A
query runs four stages:

  1. PREPASS (kernel ``prepass``): each ray against every bin box; the first
     W crossing bins per ray, ascending, as an (N, W) candidate table with
     SENTINEL in the empty slots, and an overflow flag for rays that cross
     more.
  2. SORT (glue): one stable ``torch.sort`` of the flat (N * W,) table
     groups the (bin, ray) pairs by bin; the pair's ray is perm // W.
  3. LEAF (kernel ``leaf``, or ``leaf_streamed``): each pair's ray against
     the bin's 512 triangles, Moeller-Trumbore or watertight; per pair the
     exact float32 minimum t and its slot (cluster * 128 + lane, the
     sweep's slot space), ties to the lowest slot, packed into one int64
     key (float bits << 32 | slot).
  4. REDUCE (glue): one ``scatter_reduce`` (amin) of the keys per ray.
     t > t0 > 0, so the float bits order like the floats: the result is
     the minimum t, ties to the lowest slot, which is what the sweep twin
     accel/clusters.closest_hit_ref returns.

Overflow rays (more than W crossing bins) are finished in one of two ways:

  - resident (``streamed=False``, backend "cluster_binned"): re-traced
    through the cluster sweep (kernels/cluster.py, unsorted) with t1 = 0
    on the other rays;
  - streamed (``streamed=True``, backend "cluster_streamed"): the prepass
    also returns each ray's crossing bits left after the peel, and rounds
    of ``peel`` (the next W bins) -> sort -> ``leaf_streamed`` -> reduce,
    min-merged, run until no ray has bits left. ``leaf_streamed`` gives
    each CUDA block one bin's run of up to RUN_PAIRS sorted pairs (the
    blockify step, ``blocks_for``) and stages the bin's triangles in shared
    memory.

The leaf runs over the real pairs only: the one device-to-host read of a
query (resident) or of a round (streamed), ``_count``, returns the number
of rays that overflowed together with the number of real pairs (and, on a
query's first read inside a recording() block, the live rays the prepass
tested), and the sorted stream is cut to that prefix (the TPU's
``_tier_caps`` picked a static prefix for XLA's static shapes instead).
Rays need no padding: a CUDA block per span of rays, one warp per live
ray (prepass) or per ray with bits left (peel), one warp per pair (both
leaves).

Inside a recording() block (utils/profiling) a query records four spans:
``bin_prepass`` (the prepass, or a streamed round's peel, and its
``_count`` read: the query's host wait), ``bin_sort`` (the pair sort and
its cut; the streamed path's blockify), ``bin_leaf`` (the leaf and the
scatter-min) and ``bin_overflow`` (the
resident path's residual sweep of the overflow rays, where some ray
overflowed), each launch a ``launch`` span inside them; and three
counters, host numbers from ``_count``'s read, so counting adds no wait:
``binned_rays`` (the live rays the prepass tested: t1 >= t0, the
kernel's rule), ``binned_pairs`` (the real pairs the leaves tested, every
round) and ``overflow_rays`` (the rays the residual sweep finishes; the
resident path only).

Each kernel wrapper (``prepass``, ``peel``, ``leaf``, ``leaf_streamed``)
takes the device from its tensors: on a CUDA tensor it launches the kernel
(csrc/binned.cu) or raises, on a CPU tensor it runs the plain twin beside
it (``*_ref``), and it counts both (``launches``, ``twin_calls``). There
is no fallback from one to the other. The public ``closest_hit`` and
``occluded`` have the contract of kernels/cluster.py.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from pyrenderer_tpu_torch.accel.clusters import (
    BIN,
    BOX_ROW,
    LANE_TRIS,
    MISS_T,
    TRI_ROWS,
    ClusterScene,
    _leaf,
    _slab,
    exact_t_for_slot,
    slot_to_face,
)
from pyrenderer_tpu_torch.kernels import build
from pyrenderer_tpu_torch.kernels import cluster as sweep
from pyrenderer_tpu_torch.utils.profiling import count, counting, span

# Candidate bins per ray and pass. Both defaults are the TPU's (W = 6 covers
# ~p95 of its bounce and shadow wavefronts; the streamed path pays a whole
# round per overflow, so it peels 10); they only choose a speed and are not
# measured on this card. PYRENDERER_BINNED_W is read at every call; tests
# monkeypatch W_SLOTS to force overflow.
_W_DEFAULT = 6
W_SLOTS = int(os.environ.get("PYRENDERER_BINNED_W", str(_W_DEFAULT)))
W_SLOTS_STREAMED = 10


def _w_slots(streamed: bool = False) -> int:
    """W for this call: the env var, then a changed W_SLOTS, then the
    per-variant default."""
    env = os.environ.get("PYRENDERER_BINNED_W")
    if env is not None:
        return int(env)
    if W_SLOTS != _W_DEFAULT:
        return W_SLOTS
    return W_SLOTS_STREAMED if streamed else W_SLOTS


SENTINEL = 0x7FFFFFFF   # an empty candidate slot: sorts after every bin id
# a pair's key on a miss: MISS_T's bits over slot -1 (all ones)
MISS_KEY = (int(np.float32(MISS_T).view(np.int32)) << 32) | 0xFFFFFFFF
# most sorted pairs per CUDA block of the streamed leaf (blocks_for); its 4
# warps take them in turn. On the terrain100k bounce-1 wavefront the kernel
# took 0.155 ms with runs of 16 against 0.179 (32), 0.221 (64) and 0.298
# (128) (NVIDIA H100 80GB HBM3, 700 W; perf/clusterbench.py kernels binned).
RUN_PAIRS = 16
# rays per CUDA block of the prepass and of the peel (multiples of 8 up to
# 128); each block packs its rays with work and gives its 4 warps one at a
# time. On the terrain100k bounce-1 wavefront the prepass took 0.0154 ms at
# a span of 32 against 0.0173 (16), 0.0165 (64) and 0.0190 (128), the peel
# at W = 6 0.0065-0.0067 at 32 and 64 against 0.0070 at 128 (NVIDIA H100
# 80GB HBM3, 700 W; perf/clusterbench.py kernels binned).
PREPASS_SPAN = 32
PEEL_SPAN = 64
# the values of accel/clusters.BIN the leaf kernels are instantiated for
# (csrc/binned.cu leaf_kernel_for): 4, the default, and the finer bins
# perf/binnedgran.py measures
BIN_KERNELS = (1, 2, 4)


# ---------------------------------------------------------------------------
# plain PyTorch twins of the four kernels
# ---------------------------------------------------------------------------

def _u32(words):
    """int32 words -> int64 in [0, 2^32) (torch has no uint32 shifts)."""
    return words.to(torch.int64) & 0xFFFFFFFF


def _i32(words):
    """int64 words in [0, 2^32) -> the int32 of the same bits."""
    return (words - ((words >> 31) << 32)).to(torch.int32)


def _peel_words(words, w):
    """Peel the lowest w set bits of each row of int64 `words` (N, n_words):
    -> (ids (N, w) int32, ascending, SENTINEL past the last; overflow (N,)
    bool; the words left)."""
    n_words = words.shape[1]
    col = torch.arange(n_words, device=words.device)
    ids = []
    for _ in range(w):
        first = torch.where(words != 0, col, n_words).amin(dim=1)   # (N,)
        has = first < n_words
        first = first.clamp(max=n_words - 1)
        cand = words.gather(1, first[:, None])[:, 0]
        low = cand & -cand
        bit = torch.frexp(low.to(torch.float64)).exponent - 1      # log2(low)
        ids.append(torch.where(has, first * 32 + bit, SENTINEL).to(torch.int32))
        # no bit left: cand is 0 and so is the word it rewrites
        words = words.scatter(1, first[:, None], (cand & (cand - 1))[:, None])
    return torch.stack(ids, dim=1), (words != 0).any(dim=1), words


def prepass_ref(cs: ClusterScene, rays, t0, w, emit_words=False):
    """Twin of the prepass kernel. rays (N, 8) f32 [o | d | t1 | pad].
    Returns (ids (N, w) int32, overflow (N,) bool[, words (N, n_words)
    int32: the crossing bits left after the peel, bit b of word k = bin
    32 k + b])."""
    n = rays.shape[0]
    o, d, t1 = rays[:, 0:3], rays[:, 3:6], rays[:, 6]
    inv_d = 1.0 / torch.where(d == 0, 1e-20, d)
    box = cs.bin_box[:, 0:6]
    crossed = _slab(box[:, 0:3], box[:, 3:6], o[:, None], inv_d[:, None], t0,
                    t1[:, None])                                   # (N, KB_pad32)
    bits = crossed.reshape(n, -1, 32).to(torch.int64) << torch.arange(
        32, device=rays.device)
    ids, ovf, words = _peel_words(bits.sum(dim=2), w)
    return (ids, ovf, _i32(words)) if emit_words else (ids, ovf)


def peel_ref(words, w):
    """Twin of the peel kernel: the next w bins from int32 words (N,
    n_words) -> (ids, overflow, words left) as prepass_ref."""
    ids, ovf, left = _peel_words(_u32(words), w)
    return ids, ovf, _i32(left)


def _pack(t, slot):
    return (t.view(torch.int32).to(torch.int64) << 32) | (slot.to(torch.int64) & 0xFFFFFFFF)


def _leaf_pairs(cs: ClusterScene, bins, pair_ray, rays, t0, watertight):
    """Keys (P,) int64 of the pairs (bins[q], ray pair_ray[q]): per distinct
    bin, the sweep twin's cluster leaf (accel/clusters._leaf) over the bin's
    clusters in ascending order with a strict <, so the minimum t with the
    lowest slot, as the kernels scan."""
    keys = torch.full(bins.shape, MISS_KEY, dtype=torch.int64, device=bins.device)
    tri = cs.tri.reshape(-1, TRI_ROWS, LANE_TRIS)
    uniq, which = torch.unique(bins, return_inverse=True)
    for j, b in enumerate(uniq.tolist()):
        idx = (which == j).nonzero()[:, 0]
        r = rays[pair_ray[idx]]
        best_t = torch.full((idx.shape[0],), MISS_T, dtype=rays.dtype, device=rays.device)
        best = torch.full((idx.shape[0],), -1, dtype=torch.int64, device=rays.device)
        for c in range(b * BIN, (b + 1) * BIN):
            t_new, lane = _leaf(tri[c], r[:, 0:3], r[:, 3:6], t0, r[:, 6],
                                watertight).min(dim=1)
            better = t_new < best_t
            best_t = torch.where(better, t_new, best_t)
            best = torch.where(better, c * LANE_TRIS + lane, best)
        keys[idx] = _pack(best_t, best)
    return keys


def leaf_ref(cs: ClusterScene, sortd, pair_ray, rays, t0, watertight=False):
    """Twin of the resident leaf kernel: keys (P,) int64 of the sorted pairs
    (sortd (P,) int32 bins, SENTINEL for none; pair_ray (P,) int64)."""
    real = (sortd != SENTINEL).nonzero()[:, 0]
    keys = torch.full(sortd.shape, MISS_KEY, dtype=torch.int64, device=sortd.device)
    keys[real] = _leaf_pairs(cs, sortd[real], pair_ray[real], rays, t0, watertight)
    return keys


def leaf_streamed_ref(cs: ClusterScene, blocks, pair_ray, rays, t0, watertight=False):
    """Twin of the streamed leaf kernel over the blockified stream: blocks
    (B, 3) int32 rows (bin, start, count) cover the P sorted pairs; keys
    (P,) int64 (MISS_KEY where no row covers a pair)."""
    lane = torch.arange(RUN_PAIRS, device=blocks.device)
    blocks = blocks.to(torch.int64)
    ok = (lane < blocks[:, 2:3]) & (blocks[:, 0:1] >= 0)
    pos = (blocks[:, 1:2] + lane)[ok]
    bins = blocks[:, 0:1].expand(-1, RUN_PAIRS)[ok]
    keys = torch.full(pair_ray.shape, MISS_KEY, dtype=torch.int64, device=pair_ray.device)
    keys[pos] = _leaf_pairs(cs, bins, pair_ray[pos], rays, t0, watertight)
    return keys


# ---------------------------------------------------------------------------
# kernel wrappers: a CUDA tensor launches, a CPU tensor runs the twin
# ---------------------------------------------------------------------------

def _check_table(x, dtype, name, device):
    if x.device != device or x.dtype != dtype or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor on {device}, "
                         f"got {x.dtype} on {x.device}")


def prepass(cs: ClusterScene, rays, t0, w, emit_words=False):
    """The first w crossing bins of each ray: (ids (N, w) int32, overflow
    (N,) bool[, words (N, n_words) int32]), as prepass_ref."""
    if not build.on_cuda(rays, "prepass"):
        prepass.twin_calls += 1
        return prepass_ref(cs, rays, t0, w, emit_words)
    dev = rays.device
    _check_table(rays, torch.float32, "rays", dev)
    _check_table(cs.bin_box8, torch.float32, "ClusterScene.bin_box8", dev)
    if cs.bin_box8.shape[1] != BOX_ROW or cs.bin_box8.shape[0] % 32 or \
            cs.bin_box8.data_ptr() % 16 or rays.data_ptr() % 16:
        raise ValueError(f"ClusterScene.bin_box8 must be (32 k, {BOX_ROW}), and it and the "
                         "rays 16-byte aligned")
    n, n_words = rays.shape[0], cs.bin_box8.shape[0] // 32
    ids = torch.empty((n, w), dtype=torch.int32, device=dev)
    ovf = torch.empty(n, dtype=torch.bool, device=dev)
    words = torch.empty((n, n_words), dtype=torch.int32, device=dev) if emit_words else None
    build.launch("pr_binned_prepass", dev, cs.bin_box8.data_ptr(), n_words, rays.data_ptr(),
                 float(t0), n, PREPASS_SPAN, w, ids.data_ptr(), ovf.data_ptr(),
                 words.data_ptr() if emit_words else None)
    prepass.launches += 1
    return (ids, ovf, words) if emit_words else (ids, ovf)


def peel(words, w):
    """The next w bins from carried words: (ids, overflow, words left)."""
    if not build.on_cuda(words, "peel"):
        peel.twin_calls += 1
        return peel_ref(words, w)
    dev = words.device
    _check_table(words, torch.int32, "words", dev)
    n, n_words = words.shape
    ids = torch.empty((n, w), dtype=torch.int32, device=dev)
    ovf = torch.empty(n, dtype=torch.bool, device=dev)
    left = torch.empty_like(words)
    build.launch("pr_binned_peel", dev, words.data_ptr(), n_words, n, PEEL_SPAN, w,
                 ids.data_ptr(), ovf.data_ptr(), left.data_ptr())
    peel.launches += 1
    return ids, ovf, left


def _check_leaf_args(cs, pair_ray, rays):
    dev = rays.device
    _check_table(rays, torch.float32, "rays", dev)
    _check_table(pair_ray, torch.int64, "pair_ray", dev)
    _check_table(cs.tri, torch.float32, "ClusterScene.tri", dev)
    if cs.tri.data_ptr() % 16:
        raise ValueError("ClusterScene.tri must be 16-byte aligned (the streamed leaf copies "
                         "it in 16-byte pieces)")
    if BIN not in BIN_KERNELS:
        raise ValueError(f"the binned leaf kernels are compiled for BIN in {BIN_KERNELS}, "
                         f"not {BIN}")


def leaf(cs: ClusterScene, sortd, pair_ray, rays, t0, watertight=False):
    """Resident leaf over the sorted pairs: keys (P,) int64, as leaf_ref."""
    if not build.on_cuda(rays, "leaf"):
        leaf.twin_calls += 1
        return leaf_ref(cs, sortd, pair_ray, rays, t0, watertight)
    _check_leaf_args(cs, pair_ray, rays)
    _check_table(sortd, torch.int32, "sortd", rays.device)
    keys = torch.empty(sortd.shape[0], dtype=torch.int64, device=rays.device)
    build.launch("pr_binned_leaf", rays.device, cs.tri.data_ptr(), sortd.data_ptr(),
                 pair_ray.data_ptr(), sortd.shape[0], rays.data_ptr(), float(t0),
                 int(bool(watertight)), BIN, keys.data_ptr())
    leaf.launches += 1
    return keys


def leaf_streamed(cs: ClusterScene, blocks, pair_ray, rays, t0, watertight=False):
    """Streamed leaf, one CUDA block per row of `blocks`: keys (P,) int64,
    as leaf_streamed_ref."""
    if not build.on_cuda(rays, "leaf_streamed"):
        leaf_streamed.twin_calls += 1
        return leaf_streamed_ref(cs, blocks, pair_ray, rays, t0, watertight)
    _check_leaf_args(cs, pair_ray, rays)
    _check_table(blocks, torch.int32, "blocks", rays.device)
    # a pair no row covers (a SENTINEL pair) keeps the miss, as in the twin
    keys = torch.full((pair_ray.shape[0],), MISS_KEY, dtype=torch.int64, device=rays.device)
    build.launch("pr_binned_leaf_streamed", rays.device, cs.tri.data_ptr(), blocks.data_ptr(),
                 blocks.shape[0], pair_ray.data_ptr(), rays.data_ptr(), float(t0),
                 int(bool(watertight)), BIN, keys.data_ptr())
    leaf_streamed.launches += 1
    return keys


def reset_counters() -> None:
    for fn in (prepass, peel, leaf, leaf_streamed):
        fn.launches = 0
        fn.twin_calls = 0


reset_counters()


# ---------------------------------------------------------------------------
# glue (torch ops) and the public queries
# ---------------------------------------------------------------------------

def _count(ids, ovf, live=None):
    """The one device-to-host read of a query or round: [the rays that
    overflowed, the real pairs] and, with the (N,) bool `live`, its
    count."""
    parts = [ovf.sum(), (ids != SENTINEL).sum()]
    return torch.stack(parts if live is None else parts + [live.sum()]).tolist()


def sort_pairs(ids, n_real):
    """The real (bin, ray) pairs of an (N, W) candidate table, grouped by
    bin: (bins (n_real,) int32 ascending, rays (n_real,) int64). The sort is
    stable, so a bin's pairs keep ray order; SENTINEL slots sort last and
    are cut."""
    sortd, perm = torch.sort(ids.reshape(-1), stable=True)
    return sortd[:n_real], perm[:n_real] // ids.shape[1]


def blocks_for(sortd, n_bins):
    """The blockify step of the streamed leaf: (B, 3) int32 rows (bin,
    start, count) cutting each bin's run of the sorted pairs into pieces of
    at most RUN_PAIRS, one per CUDA block. B is the static bound
    ceil(P / RUN_PAIRS) + min(n_bins, P); rows past the real pieces carry bin
    -1."""
    p = sortd.shape[0]
    dev = sortd.device
    coff = torch.searchsorted(sortd, torch.arange(n_bins + 1, dtype=sortd.dtype, device=dev))
    per_bin = (coff.diff() + RUN_PAIRS - 1) // RUN_PAIRS                # pieces per bin
    boff = torch.cat([per_bin.new_zeros(1), per_bin.cumsum(0)])        # (n_bins + 1,)
    blk = torch.arange(-(-p // RUN_PAIRS) + min(n_bins, p), device=dev)
    b = (torch.searchsorted(boff, blk, right=True) - 1).clamp(max=n_bins - 1)
    start = coff[b] + (blk - boff[b]) * RUN_PAIRS
    real = blk < boff[-1]
    count = torch.where(real, (coff[b + 1] - start).clamp(max=RUN_PAIRS), 0)
    return torch.stack([torch.where(real, b, -1), start, count], dim=1).to(torch.int32)


def _round(cs, ids, n_real, rays, t0, watertight, streamed):
    """Sort, leaf and reduce one (N, W) candidate table: (N,) int64 per-ray
    minimum keys."""
    kmin = torch.full((rays.shape[0],), MISS_KEY, dtype=torch.int64, device=rays.device)
    if n_real == 0:
        return kmin
    with span("bin_sort"):
        sortd, pair_ray = sort_pairs(ids, n_real)
        blocks = blocks_for(sortd, cs.n_clusters // BIN) if streamed else None
    with span("bin_leaf"):
        if streamed:
            keys = leaf_streamed(cs, blocks, pair_ray, rays, t0, watertight)
        else:
            keys = leaf(cs, sortd, pair_ray, rays, t0, watertight)
        return kmin.scatter_reduce_(0, pair_ray, keys, "amin")


def _trace(cs, ro, rd, t0, t1, watertight, streamed):
    """-> (keys (N,) int64, overflow (N,) bool or None, rays (N, 8)). With
    streamed=False the overflow rays' keys cover only their first W bins."""
    if ro.device.type not in ("cpu", "cuda"):
        raise ValueError(f"binned traversal: no kernel for device {ro.device}")
    if ro.device.type == "cuda":
        sweep._check_cuda_args(cs, ro, rd)
    rays, _ = sweep._prepare(cs, ro, rd, t1, sort=False)
    w = _w_slots(streamed)
    with span("bin_prepass"):
        if streamed:
            ids, ovf, words = prepass(cs, rays, t0, w, emit_words=True)
        else:
            ids, ovf = prepass(cs, rays, t0, w)
        # the live rays are summed only where they are recorded
        n_ovf, n_real, *n_live = _count(ids, ovf, rays[:, 6] >= t0 if counting() else None)
        if n_live:
            count("binned_rays", n_live[0])
        count("binned_pairs", n_real)
        if not streamed:
            count("overflow_rays", n_ovf)
    if not streamed:
        kmin = _round(cs, ids, n_real, rays, t0, watertight, False)
        return kmin, (ovf if n_ovf else None), rays
    kmin = None
    while True:
        k = _round(cs, ids, n_real, rays, t0, watertight, True)
        kmin = k if kmin is None else torch.minimum(kmin, k)
        if not n_ovf:
            return kmin, None, rays
        with span("bin_prepass"):
            ids, ovf, words = peel(words, w)
            n_ovf, n_real = _count(ids, ovf)
            count("binned_pairs", n_real)


def decode(kmin):
    """(hit (N,) bool, t (N,) f32, slot (N,) int32) of per-ray keys; a miss
    has t = MISS_T and slot = -1."""
    hit = kmin != MISS_KEY
    t = (kmin >> 32).to(torch.int32).view(torch.float32)
    slot = torch.where(hit, (kmin & 0xFFFFFFFF).to(torch.int32), -1)
    return hit, t, slot


def closest_hit(cs: ClusterScene, ro, rd, t0, t1, watertight=False, streamed=False,
                exact_t=True):
    """Binned closest hit, the contract of kernels/cluster.closest_hit:
    (hit (N,) bool, t (N,), face (N,) int32), t = 0 and face = 0 on a miss,
    t the exact float32 t of the leaf test; exact_t=True re-derives the
    Moeller-Trumbore t of the winning triangle, as the JAX package does at
    its public boundary. No coherence sort: the cost does not depend on the
    wavefront's order. streamed selects how overflow rays finish (module
    docstring). Inputs are detached: the hit selection is discrete."""
    ro, rd = ro.detach(), rd.detach()
    t1 = t1.detach() if torch.is_tensor(t1) else t1
    kmin, ovf, rays = _trace(cs, ro, rd, t0, t1, watertight, streamed)
    hit, t, slot = decode(kmin)
    if exact_t:
        t = exact_t_for_slot(cs, slot, ro, rd, t)
    t = torch.where(hit, t, 0.0)
    face = slot_to_face(cs, slot).to(torch.int32)
    if ovf is None:
        return hit, t, face
    with span("bin_overflow"):
        h2, t2, f2 = sweep.closest_hit(cs, ro, rd, t0, torch.where(ovf, rays[:, 6], 0.0),
                                       sort=False, watertight=watertight, exact_t=exact_t)
        return torch.where(ovf, h2, hit), torch.where(ovf, t2, t), torch.where(ovf, f2, face)


def occluded(cs: ClusterScene, ro, rd, t0, t1, watertight=False, streamed=False):
    """Binned any-hit shadow query (the operands of closest_hit): (N,) bool,
    True where some triangle lies in (t0, t1). A hit of the bounded closest
    hit is an occluder and a miss proves clearance."""
    ro, rd = ro.detach(), rd.detach()
    t1 = t1.detach() if torch.is_tensor(t1) else t1
    kmin, ovf, rays = _trace(cs, ro, rd, t0, t1, watertight, streamed)
    occ = kmin != MISS_KEY
    if ovf is None:
        return occ
    with span("bin_overflow"):
        occ2 = sweep.occluded(cs, ro, rd, t0, torch.where(ovf, rays[:, 6], 0.0), sort=False,
                              watertight=watertight)
        return torch.where(ovf, occ2, occ)
