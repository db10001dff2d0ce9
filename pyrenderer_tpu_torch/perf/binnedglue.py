"""Slope-timed breakdown of the binned traversal, stage by stage, on the
terrain100k wavefront.

Counterpart of perf/binnedglue.py, on its inputs (N = 262,144 rays from
numpy.random.default_rng(0) above the terrain of res 224, 100,352
triangles; t0 = 1e-4, t1 = 1e9, Moeller-Trumbore leaves). Each JAX stage is
mapped onto the stage of the port's pipeline (kernels/binned.py) that does
that work:

  pack_rays      the (N, 8) ray rows (kernels/cluster._prepare)
  prepass        B5, the first W = 6 crossing bins of each ray
  sort_pairs     the one stable sort of the (N * W) candidate slots, cut to
                 the real pairs (the JAX rows sort3 / sort2)
  leaf           B7 on the sorted pairs
  unsort         the per-ray minimum of the pairs' keys: one scatter_reduce
                 (the JAX rows unsort+reduce and scatter_unsort)
  decode         the per-ray keys to (hit, t, slot)
  peel           B6, the next W = 10 bins from the words the streamed
                 path's prepass leaves
  blocks_for     the streamed leaf's blockify step (bin, start, count)
  leaf_streamed  B8 on the streamed path's first round of pairs
  exact_t, slot_to_face
                 the public boundary's re-derived t and face ids
  resid_sweep    the overflow rays' sweep, 256 live rays
  core_resident, core_streamed
                 the whole traversal (kernels/binned._trace) without the
                 overflow sweep, as the JAX package's _binned_core and
                 _binned_core_streamed
  sweep_sorted   the sorted cluster sweep on the same rays, for reference

No number is printed for the JAX stages the port does not have:
take_cols (the JAX leaf reads a gathered copy of each pair's ray columns;
the port's leaf reads the ray's row by the pair's index), ids_unpack (the
TPU prepass writes a lane-major tile that is transposed afterwards; the
port's writes the (N, W) table directly) and the JAX sort3 / sort2 split
(the port has one sort, sort_pairs).

The resident and streamed cores read the device once per query or round
(kernels/binned._count), so they are not captured into a CUDA graph; every
other stage is (CAPTURABLE), its pair count read beforehand; every stage
takes t1 as an (N,) tensor (a Python float would be copied to the device
in every call, which a capture refuses). Timing is
utils/profiling.slope_time (eager ms, graph ms for CAPTURABLE, and of one
call the device's busy ms, its device events, host syncs and kernel
launches).

    python -m pyrenderer_tpu_torch.perf.binnedglue [--n N] [--res R] [--reps R] [--device cpu]
"""

from __future__ import annotations

import sys
import types

import numpy as np
import torch

from pyrenderer_tpu_torch.perf import harness

N = 262144
RES = 224
T0, T1 = 1e-4, 1e9
RESID_LIVE = 256
CAPTURABLE = ("pack_rays", "prepass", "sort_pairs", "leaf", "unsort", "decode", "peel",
              "blocks_for", "leaf_streamed", "exact_t", "slot_to_face", "resid_sweep",
              "sweep_sorted")


def host_inputs(n=N):
    """The JAX harness's rays from default_rng(0): origins above the terrain
    (float32), directions normalised in float32."""
    rng = np.random.default_rng(0)
    ro = (rng.uniform(-0.8, 0.8, (n, 3)) + np.array([0, 1.5, 0])).astype(np.float32)
    rd = rng.standard_normal((n, 3)).astype(np.float32)
    rd = rd / np.linalg.norm(rd, axis=1, keepdims=True)
    return dict(ro=ro, rd=rd)


def inputs(device, n=N, res=RES):
    """The stages' operands, each stage's input made by the stages before it
    (run once here, outside any timing)."""
    from pyrenderer_tpu_torch.accel.clusters import BIN, build_clusters
    from pyrenderer_tpu_torch.kernels import binned
    from pyrenderer_tpu_torch.scene import procgen

    h = host_inputs(n)
    cs = build_clusters(*procgen.terrain(res)).to(device)
    ro, rd = (torch.as_tensor(h[k], device=device) for k in ("ro", "rd"))
    t1v = torch.full((n,), T1, dtype=torch.float32, device=device)
    x = types.SimpleNamespace(host=h, cs=cs, ro=ro, rd=rd, t1v=t1v, n_bins=cs.n_clusters // BIN,
                              w=binned._w_slots(), w_streamed=binned._w_slots(True))
    x.rays = pack_rays(cs, ro, rd, t1v)
    x.ids, x.ovf = prepass(cs, x.rays, x.w)
    _, x.n_real = binned._count(x.ids, x.ovf)
    x.sortd, x.pair_ray = sort_pairs(x.ids, x.n_real)
    x.keys = leaf(cs, x.sortd, x.pair_ray, x.rays)
    x.kmin = unsort(x.keys, x.pair_ray, n)
    ids_s, ovf_s, x.words = binned.prepass(cs, x.rays, T0, x.w_streamed, emit_words=True)
    _, n_real_s = binned._count(ids_s, ovf_s)
    x.sortd_s, x.pair_ray_s = sort_pairs(ids_s, n_real_s)
    x.blocks = blocks_for(x.sortd_s, x.n_bins)
    lanes = torch.arange(n, device=device)
    x.slot = (lanes % (cs.n_clusters * 128)).to(torch.int32)
    x.t_leaf = torch.ones(n, dtype=torch.float32, device=device)
    x.t1_resid = torch.where(lanes < RESID_LIVE, T1, 0.0).to(torch.float32)
    return x


def pack_rays(cs, ro, rd, t1v):
    from pyrenderer_tpu_torch.kernels import cluster

    return cluster._prepare(cs, ro, rd, t1v, sort=False)[0]


def prepass(cs, rays, w):
    from pyrenderer_tpu_torch.kernels import binned

    return binned.prepass(cs, rays, T0, w)


def sort_pairs(ids, n_real):
    from pyrenderer_tpu_torch.kernels import binned

    return binned.sort_pairs(ids, n_real)


def leaf(cs, sortd, pair_ray, rays):
    from pyrenderer_tpu_torch.kernels import binned

    return binned.leaf(cs, sortd, pair_ray, rays, T0)


def unsort(keys, pair_ray, n):
    """Each ray's minimum key over its pairs (MISS_KEY for a ray with none)."""
    from pyrenderer_tpu_torch.kernels import binned

    kmin = torch.full((n,), binned.MISS_KEY, dtype=torch.int64, device=keys.device)
    return kmin.scatter_reduce_(0, pair_ray, keys, "amin")


def decode(kmin):
    from pyrenderer_tpu_torch.kernels import binned

    return binned.decode(kmin)


def peel(words, w):
    from pyrenderer_tpu_torch.kernels import binned

    return binned.peel(words, w)


def blocks_for(sortd, n_bins):
    from pyrenderer_tpu_torch.kernels import binned

    return binned.blocks_for(sortd, n_bins)


def leaf_streamed(cs, blocks, pair_ray, rays):
    from pyrenderer_tpu_torch.kernels import binned

    return binned.leaf_streamed(cs, blocks, pair_ray, rays, T0)


def exact_t(cs, slot, ro, rd, t_leaf):
    from pyrenderer_tpu_torch.accel.clusters import exact_t_for_slot

    return exact_t_for_slot(cs, slot, ro, rd, t_leaf)


def slot_to_face(cs, slot):
    from pyrenderer_tpu_torch.accel.clusters import slot_to_face as to_face

    return to_face(cs, slot)


def resid_sweep(cs, ro, rd, t1):
    """The unsorted sweep where only the first RESID_LIVE rays are live, as
    the resident path finishes its overflow rays: 1 where a ray hit."""
    from pyrenderer_tpu_torch.kernels import cluster

    hit, _, _ = cluster.closest_hit(cs, ro, rd, T0, t1, sort=False)
    return hit


def core(cs, ro, rd, t1v, streamed):
    """The binned traversal of the wavefront without the overflow sweep: 1
    where a ray's first W bins (resident) or all its bins (streamed) gave
    a hit."""
    from pyrenderer_tpu_torch.kernels import binned

    kmin, _, _ = binned._trace(cs, ro, rd, T0, t1v, False, streamed)
    return kmin != binned.MISS_KEY


def sweep_sorted(cs, ro, rd, t1v):
    from pyrenderer_tpu_torch.kernels import cluster

    hit, _, _ = cluster.closest_hit(cs, ro, rd, T0, t1v, sort=True)
    return hit


def stages(x):
    n = x.ro.shape[0]
    return [
        ("pack_rays", pack_rays, (x.cs, x.ro, x.rd, x.t1v), ""),
        ("prepass", prepass, (x.cs, x.rays, x.w), f"W={x.w}"),
        ("sort_pairs", sort_pairs, (x.ids, x.n_real), f"{x.n_real} real pairs"),
        ("leaf", leaf, (x.cs, x.sortd, x.pair_ray, x.rays), ""),
        ("unsort", unsort, (x.keys, x.pair_ray, n), "scatter_reduce amin"),
        ("decode", decode, (x.kmin,), ""),
        ("peel", peel, (x.words, x.w_streamed), f"W={x.w_streamed}"),
        ("blocks_for", blocks_for, (x.sortd_s, x.n_bins), ""),
        ("leaf_streamed", leaf_streamed, (x.cs, x.blocks, x.pair_ray_s, x.rays),
         f"round 1 at W={x.w_streamed}"),
        ("exact_t", exact_t, (x.cs, x.slot, x.ro, x.rd, x.t_leaf), "9-gather re-derive"),
        ("slot_to_face", slot_to_face, (x.cs, x.slot), ""),
        ("resid_sweep", resid_sweep, (x.cs, x.ro, x.rd, x.t1_resid),
         f"sweep with {RESID_LIVE} live rays"),
        ("core_resident", core, (x.cs, x.ro, x.rd, x.t1v, False), "reads the device"),
        ("core_streamed", core, (x.cs, x.ro, x.rd, x.t1v, True), "reads the device"),
        ("sweep_sorted", sweep_sorted, (x.cs, x.ro, x.rd, x.t1v), "for reference"),
    ]


def run(device, args):
    from pyrenderer_tpu_torch.utils.profiling import slope_time

    x = inputs(device, args.n, args.res)
    n = args.n
    cand = float((x.ids != 0x7FFFFFFF).sum()) / n
    ovf = float(x.ovf.float().mean()) * 100
    report = harness.Report("binnedglue", device, n, reps=args.reps, res=args.res,
                            tris=int(x.cs.order.shape[0]), bins=x.n_bins, w=x.w,
                            candidates_per_ray=cand, overflow_pct=ovf)
    for name, fn, fn_args, note in stages(x):
        st = slope_time(fn, *fn_args, reps=args.reps, graph=name in CAPTURABLE,
                        profile=not args.no_profile)
        report.row(name, st, note=note)
    return report.result()


def main(argv=None) -> int:
    p = harness.parser(__doc__.split("\n\n")[0], N)
    p.add_argument("--res", type=int, default=RES, help=f"terrain res (default {RES})")
    return harness.main(run, p.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
