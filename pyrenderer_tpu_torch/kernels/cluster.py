"""Cluster-sweep closest-hit and any-hit queries: CUDA kernels and their twins.

Counterpart of the host side of pyrenderer_tpu/kernels/pallas_cluster.py.
The kernels (csrc/cluster.cu) replace the TPU's ``_closest_kernel`` and
``_anyhit_kernel``: one GPU thread per ray walks the superclusters of an
accel/clusters.ClusterScene front to back and runs the 128-triangle leaf
(Moeller-Trumbore, or the watertight test) of every cluster it crosses.

``closest_hit`` and ``occluded`` take the device from their rays. For a
CUDA tensor they sort the wavefront if asked (``_prepare``), rank the
superclusters (``_sc_order``), launch the kernel (or raise) and scatter the
results back; for a CPU tensor they run the plain twins
accel/clusters.closest_hit_ref / occluded_ref, as the JAX package does off
the TPU. There is no fallback from one to the other.

Each wrapper counts its kernel launches (``closest_hit.launches``) and,
apart from them, the calls it served with the twin (``twin_calls``).

Not ported: suspend/resume rounds (``rounds > 1``, ROADMAP A10) and the
TPU's tile tuning (SUB_TILES, pair peeling, the lane-bound refresh, the
watertight fallback modes, the VMEM guard; ROADMAP A14).
"""

from __future__ import annotations

import torch

from pyrenderer_tpu_torch.accel.clusters import (
    ClusterScene,
    closest_hit_ref,
    exact_t_for_slot,
    occluded_ref,
    slot_to_face,
    sort_keys,
)
from pyrenderer_tpu_torch.kernels import build

_DEAD_KEY = 0xFFFFFFFF  # sorts after every real key (24 bits)


def _sc_order(cs: ClusterScene, ro):
    """Front-to-back supercluster rank for this wavefront: boxes sorted by
    the distance of their centres from the mean ray origin; padded ranks map
    to the NaN-boxed padding rows. Returns (order (S_pad,) int32, the
    supercluster rows in that order (S_pad, 128))."""
    s = cs.n_superclusters
    s_pad = cs.super_cols.shape[0]
    centers = 0.5 * (cs.super_box[0:3] + cs.super_box[3:6])     # (3, S)
    diff = centers - ro.mean(dim=0)[:, None]
    d2 = diff[0] * diff[0] + diff[1] * diff[1] + diff[2] * diff[2]
    order = torch.cat([torch.argsort(d2, stable=True),
                       torch.arange(s, s_pad, device=ro.device)])
    return order.to(torch.int32), cs.super_cols[order]


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
    for name in ("tri", "child_box", "super_cols"):
        x = getattr(cs, name)
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"ClusterScene.{name} must be contiguous float32")


def _launch(fn_name, cs, ro, rd, t0, t1, sort, watertight, outs):
    """Sort, rank, launch `fn_name` with the scene operands and `outs`
    (tensors the kernel fills, in sorted order); returns the permutation."""
    _check_cuda_args(cs, ro, rd)
    rays, perm = _prepare(cs, ro, rd, t1, sort)
    order, super_sorted = _sc_order(cs, ro)
    with torch.cuda.device(ro.device):
        lib, stream = build.launch_context(ro.device)
        err = getattr(lib, fn_name)(
            cs.tri.data_ptr(), cs.child_box.data_ptr(), super_sorted.data_ptr(),
            order.data_ptr(), order.shape[0], rays.data_ptr(), float(t0),
            ro.shape[0], int(bool(watertight)), *[o.data_ptr() for o in outs],
            stream)
    build.check_launch(err, fn_name)
    return perm


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
    changes which rays share a warp, never the result. Inputs are detached:
    the hit selection is discrete."""
    ro, rd = ro.detach(), rd.detach()
    t1 = t1.detach() if torch.is_tensor(t1) else t1
    if ro.device.type == "cpu":
        closest_hit.twin_calls += 1
        hit, t, slot = closest_hit_ref(cs, ro, rd, t0, t1, watertight=watertight)
    elif ro.device.type == "cuda":
        n = ro.shape[0]
        t_k = torch.empty(n, dtype=torch.float32, device=ro.device)
        slot = torch.empty(n, dtype=torch.int32, device=ro.device)
        perm = _launch("pr_cluster_closest", cs, ro, rd, t0, t1, sort, watertight,
                       (t_k, slot))
        closest_hit.launches += 1
        t, slot = _unsort(t_k, perm), _unsort(slot, perm)
        hit = slot >= 0
    else:
        raise ValueError(f"closest_hit: no kernel for device {ro.device}")
    if exact_t:
        t = exact_t_for_slot(cs, slot, ro, rd, t)
    return hit, torch.where(hit, t, 0.0), slot_to_face(cs, slot).to(torch.int32)


def occluded(cs: ClusterScene, ro, rd, t0, t1, sort=False, watertight=False):
    """Any-hit shadow query (the operands of closest_hit): (N,) bool, True
    where some triangle lies in (t0, t1). A ray stops at its first
    occluder."""
    ro, rd = ro.detach(), rd.detach()
    t1 = t1.detach() if torch.is_tensor(t1) else t1
    if ro.device.type == "cpu":
        occluded.twin_calls += 1
        return occluded_ref(cs, ro, rd, t0, t1, watertight=watertight)
    if ro.device.type != "cuda":
        raise ValueError(f"occluded: no kernel for device {ro.device}")
    occ = torch.empty(ro.shape[0], dtype=torch.bool, device=ro.device)
    perm = _launch("pr_cluster_occluded", cs, ro, rd, t0, t1, sort, watertight,
                   (occ,))
    occluded.launches += 1
    return _unsort(occ, perm)


def reset_counters() -> None:
    for fn in (closest_hit, occluded):
        fn.launches = 0
        fn.twin_calls = 0


reset_counters()
