"""Cluster-sweep closest-hit and any-hit queries: CUDA kernels and their twins.

Counterpart of the host side of pyrenderer_tpu/kernels/pallas_cluster.py.
The kernels (csrc/cluster.cu) replace the TPU's ``_closest_kernel`` and
``_anyhit_kernel``: one GPU warp per ray walks the superclusters of an
accel/clusters.ClusterScene front to back, its lanes slab-testing 32
supercluster or 16 child boxes at once, and runs the 128-triangle leaf
(Moeller-Trumbore, or the watertight test) of every cluster it crosses,
four triangles per lane.

``closest_hit`` and ``occluded`` take the device from their rays. For a
CUDA tensor they prepare the operands (``_operands``: the checks, the
wavefront sorted if asked by ``_prepare``, the superclusters ranked by
``_sc_order``), launch the kernel on them (``_launch``, or raise) and
scatter the results back; for a CPU tensor they run the plain twins
accel/clusters.closest_hit_ref / occluded_ref, as the JAX package does off
the TPU. There is no fallback from one to the other. ``_launch`` alone is
the kernel without its glue, which is how chip_smoke.py times it.

Each wrapper counts its kernel launches (``closest_hit.launches``, counted
in ``_launch``) and, apart from them, the calls it served with the twin
(``twin_calls``).

Not ported: suspend/resume rounds (``rounds > 1``, ROADMAP A10) and the
TPU's tile tuning (SUB_TILES, pair peeling, the lane-bound refresh, the
watertight fallback modes, the VMEM guard; ROADMAP A14).
"""

from __future__ import annotations

import torch

from pyrenderer_tpu_torch.accel.clusters import (
    BOX_ROW,
    ClusterScene,
    closest_hit_ref,
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


def _launch(wrapper, cs: ClusterScene, ops, t0, watertight, outs):
    """Launch the kernel of `wrapper` (closest_hit or occluded) on operands
    from _operands, filling `outs` (tensors in launch order), and count the
    launch."""
    rays, _, order, super_sorted = ops
    name = "pr_cluster_closest" if wrapper is closest_hit else "pr_cluster_occluded"
    build.launch(name, rays.device, cs.tri.data_ptr(), cs.child_box8.data_ptr(),
                 super_sorted.data_ptr(), order.data_ptr(), order.shape[0],
                 rays.data_ptr(), float(t0), rays.shape[0], int(bool(watertight)),
                 *[o.data_ptr() for o in outs])
    wrapper.launches += 1


def closest_hit(cs: ClusterScene, ro, rd, t0, t1, sort=False, watertight=False,
                exact_t=True):
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
    result. Inputs are detached: the hit selection is discrete."""
    ro, rd = ro.detach(), rd.detach()
    t1 = t1.detach() if torch.is_tensor(t1) else t1
    if not build.on_cuda(ro, "closest_hit"):
        closest_hit.twin_calls += 1
        hit, t, slot = closest_hit_ref(cs, ro, rd, t0, t1, watertight=watertight)
    else:
        n = ro.shape[0]
        t_k = torch.empty(n, dtype=torch.float32, device=ro.device)
        slot = torch.empty(n, dtype=torch.int32, device=ro.device)
        ops = _operands(cs, ro, rd, t1, sort)
        _launch(closest_hit, cs, ops, t0, watertight, (t_k, slot))
        t, slot = _unsort(t_k, ops[1]), _unsort(slot, ops[1])
        hit = slot >= 0
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


def reset_counters() -> None:
    for fn in (closest_hit, occluded):
        fn.launches = 0
        fn.twin_calls = 0


reset_counters()
