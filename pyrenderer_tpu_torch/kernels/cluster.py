"""Cluster-sweep closest-hit and any-hit queries: CUDA kernels and their twins.

Counterpart of the host side of pyrenderer_tpu/kernels/pallas_cluster.py.
The kernels (csrc/cluster.cu) replace the TPU's ``_closest_kernel`` (both
its modes) and ``_anyhit_kernel``: one GPU warp per ray walks the
superclusters of an accel/clusters.ClusterScene front to back, its lanes
slab-testing 32 supercluster or 16 child boxes at once, and runs the
128-triangle leaf (Moeller-Trumbore, or the watertight test) of every
cluster it crosses, four triangles per lane.

``closest_hit`` and ``occluded`` take the device from their rays. For a
CUDA tensor they prepare the operands (``_operands``: the checks, the
wavefront sorted if asked by ``_prepare``, the superclusters ranked by
``_sc_order``), launch the kernel on them (``_launch``, or raise) and
scatter the results back; for a CPU tensor they run the plain twins
accel/clusters.closest_hit_ref / occluded_ref, as the JAX package does off
the TPU. There is no fallback from one to the other. ``_launch`` alone is
the kernel without its glue, which is how chip_smoke.py times it.

Suspend/resume rounds (``closest_hit(..., rounds > 1, budget > 0)``, the
JAX package's ``closest_hit`` at pallas_cluster.py:913-934): pass 1
(``suspend_pass``) runs the kernel's resume mode from a miss with at most
`budget` supercluster visits per ray (per 128-ray tile on the TPU) and
flags each ray done or suspended; each of the ``rounds - 1`` further passes
(``resume_pass``) stably sorts the suspended rays first, turns the done
ones dead (t1 = 0) and finishes the others without a budget from their
carried (t, slot), reusing pass 1's supercluster rank. The result is the
one-pass result bit for bit. On the CPU the same loop runs the resume
twin accel/clusters.closest_hit_resume_ref (not closest_hit_ref, as the
JAX package does off the TPU), so that the rounds logic runs there too.
``closest_hit_chunked`` / ``occluded_chunked`` query a ClusterChunks chunk
by chunk, carrying each ray's best t as the next chunk's bound.

Each wrapper counts its kernel launches (``closest_hit.launches``, counted
in ``_launch``) and, apart from them, the calls it served with the twin
(``twin_calls``). Every launch of the closest-hit kernel counts in
``closest_hit.launches``, whichever mode; a launch of the resume mode
counts in ``suspend_pass.launches`` or ``resume_pass.launches`` too (and a
twin pass in their ``twin_calls`` and in ``closest_hit.twin_calls``).

Not ported: the TPU's tile tuning (SUB_TILES, pair peeling, the lane-bound
refresh, the watertight fallback modes, the VMEM guard).
"""

from __future__ import annotations

import torch

from pyrenderer_tpu_torch.accel.clusters import (
    BOX_ROW,
    MISS_T,
    ClusterChunks,
    ClusterScene,
    closest_hit_ref,
    closest_hit_resume_ref,
    exact_t_for_slot,
    occluded_ref,
    slot_to_face,
    sort_keys,
)
from pyrenderer_tpu_torch.kernels import build

_DEAD_KEY = 0xFFFFFFFF  # sorts after every real key (24 bits)
# lanes of a warp (csrc/cluster.cu kWarp): the kernels slab-test 32
# supercluster rows per ballot, so S_pad must be a multiple of it
WARP = 32


def _sc_order(cs: ClusterScene, ro):
    """Front-to-back supercluster rank for this wavefront: boxes sorted by
    the distance of their centres from the mean ray origin; padded ranks map
    to the NaN-boxed padding rows. Returns (order (S_pad,) int32, the
    supercluster rows in that order (S_pad, BOX_ROW), the kernels' compact
    copy)."""
    s = cs.n_superclusters
    s_pad = cs.super_cols8.shape[0]
    centers = 0.5 * (cs.super_box[0:3] + cs.super_box[3:6])     # (3, S)
    diff = centers - ro.mean(dim=0)[:, None]
    d2 = diff[0] * diff[0] + diff[1] * diff[1] + diff[2] * diff[2]
    order = torch.cat([torch.argsort(d2, stable=True),
                       torch.arange(s, s_pad, device=ro.device)])
    return order.to(torch.int32), cs.super_cols8[order]


def _prepare(cs: ClusterScene, ro, rd, t1, sort: bool):
    """(N, 8) float32 ray rows [o | d | t1 | 0], coherence-sorted when
    `sort` (dead lanes, t1 = 0, keyed last), and the permutation applied
    (None when unsorted)."""
    n = ro.shape[0]
    t1v = torch.as_tensor(t1, dtype=torch.float32, device=ro.device).expand(n)
    rays = torch.cat([ro.float(), rd.float(), t1v[:, None],
                      ro.new_zeros((n, 1), dtype=torch.float32)], dim=1)
    if not sort:
        return rays, None
    keys = torch.where(t1v > 0, sort_keys(cs, ro, rd), _DEAD_KEY)
    perm = torch.argsort(keys, stable=True)
    return rays[perm], perm


def _unsort(x, perm):
    if perm is None:
        return x
    out = torch.empty_like(x)
    out[perm] = x
    return out


def _check_cuda_args(cs: ClusterScene, ro, rd):
    dev = ro.device
    if rd.device != dev or cs.tri.device != dev:
        raise ValueError(f"rays and cluster tables must share a device: ro {dev}, "
                         f"rd {rd.device}, tables {cs.tri.device}")
    if ro.dim() != 2 or ro.shape[1] != 3 or rd.shape != ro.shape:
        raise ValueError(f"ro and rd must both be (N, 3), got {tuple(ro.shape)}"
                         f" and {tuple(rd.shape)}")
    for name in ("tri", "child_box8", "super_cols8"):
        x = getattr(cs, name)
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"ClusterScene.{name} must be contiguous float32")
    if cs.child_box8.shape[1] != BOX_ROW or cs.super_cols8.shape[1] != BOX_ROW:
        raise ValueError(f"ClusterScene.child_box8 and super_cols8 must have {BOX_ROW} columns")
    if cs.super_cols8.shape[0] % WARP:
        raise ValueError(f"ClusterScene.super_cols8 must have a multiple of {WARP} rows, "
                         f"got {cs.super_cols8.shape[0]}")


def _operands(cs: ClusterScene, ro, rd, t1, sort: bool):
    """Check the arguments and prepare what the kernels take besides the
    scene: (rays (N, 8) in launch order, the sort's permutation or None,
    order (S_pad,) int32, the supercluster rows in that order)."""
    _check_cuda_args(cs, ro, rd)
    rays, perm = _prepare(cs, ro, rd, t1, sort)
    return (rays, perm, *_sc_order(cs, ro))


def _launch(wrapper, cs: ClusterScene, ops, t0, watertight, outs, resume=None):
    """Launch the kernel of `wrapper` (closest_hit, occluded, or for the
    closest-hit kernel's resume mode suspend_pass / resume_pass, with
    `resume` = (t_in, slot_in, budget)) on operands from _operands, filling
    `outs` (tensors in launch order), and count the launch."""
    rays, _, order, super_sorted = ops
    args = (cs.tri.data_ptr(), cs.child_box8.data_ptr(), super_sorted.data_ptr(),
            order.data_ptr(), order.shape[0], rays.data_ptr(), float(t0), rays.shape[0],
            int(bool(watertight)))
    if wrapper is occluded:
        build.launch("pr_cluster_occluded", rays.device, *args, *[o.data_ptr() for o in outs])
    elif resume is None:
        build.launch("pr_cluster_closest", rays.device, *args, *[o.data_ptr() for o in outs])
    else:
        t_in, slot_in, budget = resume
        build.launch("pr_cluster_closest_resume", rays.device, *args, t_in.data_ptr(),
                     slot_in.data_ptr(), int(budget), *[o.data_ptr() for o in outs])
        closest_hit.launches += 1
    wrapper.launches += 1


def _resume(wrapper, cs: ClusterScene, ops, t_in, slot_in, t0, budget, watertight):
    """One launch of the resume mode (or, for CPU tensors, its twin); returns
    (t, slot, done) in launch order."""
    rays, _, order, super_sorted = ops
    if not build.on_cuda(rays, wrapper.__name__):
        wrapper.twin_calls += 1
        closest_hit.twin_calls += 1
        return closest_hit_resume_ref(cs, rays, order, super_sorted, t_in, slot_in, t0,
                                      budget, watertight)
    n = rays.shape[0]
    outs = (torch.empty(n, dtype=torch.float32, device=rays.device),
            torch.empty(n, dtype=torch.int32, device=rays.device),
            torch.empty(n, dtype=torch.int32, device=rays.device))
    _launch(wrapper, cs, ops, t0, watertight, outs,
            resume=(t_in.contiguous(), slot_in.to(torch.int32).contiguous(), budget))
    return outs


def suspend_pass(cs: ClusterScene, ops, t0, budget, watertight=False):
    """Pass 1 of suspend/resume rounds: the resume mode from a miss (t_in =
    3e38, slot_in = -1) with at most `budget` supercluster visits per ray,
    on operands from _operands. Returns (t (N,) f32, 3e38 on a miss; slot
    (N,) int32; done (N,) int32: 0 where the budget suspended the ray), in
    launch order."""
    n = ops[0].shape[0]
    t_in = torch.full((n,), MISS_T, dtype=torch.float32, device=ops[0].device)
    slot_in = torch.full((n,), -1, dtype=torch.int32, device=ops[0].device)
    return _resume(suspend_pass, cs, ops, t_in, slot_in, t0, budget, watertight)


def resume_pass(cs: ClusterScene, ops, t_in, slot_in, t0, watertight=False):
    """A later pass of suspend/resume rounds: the resume mode without a
    budget from the carried (t_in, slot_in), on operands whose dead rays
    (t1 = 0) keep them; returns (t, slot, done) as suspend_pass does."""
    return _resume(resume_pass, cs, ops, t_in, slot_in, t0, 0, watertight)


def resume_operands(ops, t, slot, done):
    """The operands of a resume pass after a pass over `ops` that gave (t,
    slot, done): the suspended rays first (a stable sort, so the launch
    order holds within each group), the done ones dead (t1 = 0) so that they
    keep their carried result, and the first pass's supercluster rank
    (re-ranking the permuted rays would change the visit order). Returns
    (the permutation, the operands, t_in, slot_in)."""
    rays, _, order, super_sorted = ops
    uf = torch.argsort(done, stable=True)
    rays_b = rays[uf]
    rays_b[:, 6] = torch.where(done[uf] > 0, 0.0, rays_b[:, 6])
    return uf, (rays_b, None, order, super_sorted), t[uf].contiguous(), slot[uf].contiguous()


def _rounds(cs: ClusterScene, ops, t0, rounds, budget, watertight):
    """Suspend/resume rounds on prepared operands, as the JAX package runs
    them (pallas_cluster.py:913-934): (t, slot) in launch order."""
    t, slot, done = suspend_pass(cs, ops, t0, budget, watertight)
    for _ in range(rounds - 1):
        uf, ops_b, t_in, slot_in = resume_operands(ops, t, slot, done)
        t_b, slot_b, done_b = resume_pass(cs, ops_b, t_in, slot_in, t0, watertight)
        t, slot, done = torch.empty_like(t), torch.empty_like(slot), torch.empty_like(done)
        t[uf], slot[uf], done[uf] = t_b, slot_b, done_b
    return t, slot


def closest_hit(cs: ClusterScene, ro, rd, t0, t1, sort=False, watertight=False,
                exact_t=True, rounds=1, budget=0):
    """Wavefront closest hit. ro, rd (N, 3); t1 scalar or (N,).

    Returns (hit (N,) bool, t (N,), face (N,) int32 original face ids), the
    contract of the other backends: t = 0 and face = 0 on a miss. The
    kernel's t is the exact float32 t of its leaf test. exact_t=True
    re-derives the Moeller-Trumbore t of the winning triangle
    (accel/clusters.exact_t_for_slot), as the JAX kernel path does at its
    public boundary; the integrator passes exact_t=False, since it
    re-derives the hit geometry from the face id itself.

    sort=True applies the coherence sort (accel/clusters.sort_keys, dead
    t1 = 0 lanes last) before the launch and scatters the results back; it
    changes which rays run side by side (and share the caches), never the
    result. rounds > 1 with budget > 0 runs suspend/resume rounds (see the
    module docstring), with the same result. Inputs are detached: the hit
    selection is discrete."""
    ro, rd = ro.detach(), rd.detach()
    t1 = t1.detach() if torch.is_tensor(t1) else t1
    on_card = build.on_cuda(ro, "closest_hit")
    multi = rounds > 1 and budget > 0
    if not (on_card or multi):
        closest_hit.twin_calls += 1
        hit, t, slot = closest_hit_ref(cs, ro, rd, t0, t1, watertight=watertight)
    else:
        ops = _operands(cs, ro, rd, t1, sort)
        if multi:
            t_k, slot = _rounds(cs, ops, t0, rounds, budget, watertight)
        else:
            n = ro.shape[0]
            t_k = torch.empty(n, dtype=torch.float32, device=ro.device)
            slot = torch.empty(n, dtype=torch.int32, device=ro.device)
            _launch(closest_hit, cs, ops, t0, watertight, (t_k, slot))
        t, slot = _unsort(t_k, ops[1]), _unsort(slot, ops[1])
        hit = slot >= 0
        t = t.to(ro.dtype)
    if exact_t:
        t = exact_t_for_slot(cs, slot, ro, rd, t)
    return hit, torch.where(hit, t, 0.0), slot_to_face(cs, slot).to(torch.int32)


def occluded(cs: ClusterScene, ro, rd, t0, t1, sort=False, watertight=False):
    """Any-hit shadow query (the operands of closest_hit): (N,) bool, True
    where some triangle lies in (t0, t1). A ray stops at its first
    occluder."""
    ro, rd = ro.detach(), rd.detach()
    t1 = t1.detach() if torch.is_tensor(t1) else t1
    if not build.on_cuda(ro, "occluded"):
        occluded.twin_calls += 1
        return occluded_ref(cs, ro, rd, t0, t1, watertight=watertight)
    occ = torch.empty(ro.shape[0], dtype=torch.bool, device=ro.device)
    ops = _operands(cs, ro, rd, t1, sort)
    _launch(occluded, cs, ops, t0, watertight, (occ,))
    return _unsort(occ, ops[1])


def closest_hit_chunked(cc: ClusterChunks, ro, rd, t0, t1, sort=False, watertight=False,
                        exact_t=True, rounds=1, budget=0):
    """Closest hit over a ClusterChunks, the JAX package's
    closest_hit_chunked (pallas_cluster.py:951-979): the chunks in order,
    each queried with exact_t=True under the running best t as its bound (so
    far geometry culls against near hits), a strictly smaller t taking the
    hit (an earlier chunk wins a tie), its faces offset by the chunk's first
    global face. `exact_t` is accepted for the closest_hit signature; the
    returned t is exact either way."""
    n = ro.shape[0]
    t1v = torch.as_tensor(t1, dtype=ro.dtype, device=ro.device).expand(n)
    t_best = torch.full((n,), MISS_T, dtype=ro.dtype, device=ro.device)
    face_best = torch.zeros(n, dtype=torch.int32, device=ro.device)
    hit_any = torch.zeros(n, dtype=torch.bool, device=ro.device)
    for i, cs in enumerate(cc.chunks):
        bound = torch.where(hit_any, torch.minimum(t_best, t1v), t1v)
        h, t, f = closest_hit(cs, ro, rd, t0, bound, sort=sort, watertight=watertight,
                              exact_t=True, rounds=rounds, budget=budget)
        better = h & (t < torch.where(hit_any, t_best, float("inf")))
        t_best = torch.where(better, t, t_best)
        face_best = torch.where(better, f + i * cc.faces_per_chunk, face_best)
        hit_any = hit_any | h
    return hit_any, torch.where(hit_any, t_best, 0.0), face_best


def occluded_chunked(cc: ClusterChunks, ro, rd, t0, t1, sort=False, watertight=False):
    """Any hit over a ClusterChunks (pallas_cluster.py:982-994): the chunks
    in order, rays already occluded tracing the next chunk with t1 = 0."""
    n = ro.shape[0]
    t1v = torch.as_tensor(t1, dtype=torch.float32, device=ro.device).expand(n)
    occ = torch.zeros(n, dtype=torch.bool, device=ro.device)
    for cs in cc.chunks:
        occ = occ | occluded(cs, ro, rd, t0, torch.where(occ, 0.0, t1v), sort=sort,
                             watertight=watertight)
    return occ


def reset_counters() -> None:
    for fn in (closest_hit, occluded, suspend_pass, resume_pass):
        fn.launches = 0
        fn.twin_calls = 0


reset_counters()
