"""Slope-timed glue around the cluster sweep: the sorts, the coherence keys,
the permutations, the row fetches, the sweep wrapper against its kernel,
and the bounce arithmetic with the intersection stubbed.

Counterpart of perf/glue2.py, on its inputs (N = 262,144 rays and the
tables drawn from numpy.random.default_rng(0) in its order; the clusters
of terrain res 64, 8,192 triangles):

  argsort, sortu32   a stable argsort and a sort of 32-bit keys
  keys               accel/clusters.sort_keys (the coherence keys)
  permute            a gather of ro and rd by a permutation and back by
                     its inverse (a scatter)
  packrays           the sweep's (N, 8) ray rows (kernels/cluster._prepare;
                     the JAX package packs a lane form and a column form)
  take8k, take100k   index_select of (T, 16) rows, T = 8,204 and 100,364
  onehot8k, onehot100k
                     the same fetch as a one-hot float32 matrix product, in
                     chunks of 32,768 rays (a 32,768 x T buffer: 13.2 GB at
                     T = 100,364), IEEE float32 (core/intersect._ieee_fp32:
                     under TF32 the rows come back inexact)
  window100k         the one-hot product over a 4,096-row window of the
                     table around each 8,192-ray chunk of sorted indices
                     (the window's rows gathered by index: slicing at a
                     device index would read the device)
  wrap_full          the sorted cluster closest_hit (B3 with its sort,
                     rank and scatter glue) on the shuffled rays
  wrap_bare          the B3 kernel alone (kernels/cluster._launch) on the
                     same rays, unsorted, operands from _operands
                     (_prepare and _sc_order) made beforehand
  bounce4x           trace_reference, 4 bounces, on terrain res 64 with
                     both queries stubbed (TraceTables.custom)

Each stage is a function of this module; the tests hold each against its
JAX counterpart on the CPU, where wrap_full and wrap_bare run the sweep's
twins. Timing is utils/profiling.slope_time (eager ms, graph ms for
CAPTURABLE, and of one call the device's busy ms, its device events, host
syncs and kernel launches). packrays and wrap_full take t1 = 1e9 as an
(N,) tensor, as the JAX harness's packrays does: a Python float would be
copied to the device in every call.

    python -m pyrenderer_tpu_torch.perf.glue2 [--n N] [--reps R] [--device cpu]
"""

from __future__ import annotations

import re
import sys
import types

import numpy as np
import torch

from pyrenderer_tpu_torch.perf import harness

N = 262144
T_ROWS = (8204, 100364)
ONEHOT_CHUNK = 32768
WINDOW, WINDOW_CHUNK = 4096, 8192
TERRAIN_RES = 64
T0, T1 = 1e-4, 1e9
# the stages a CUDA graph can capture, by kind (a fetch row's name carries
# its table's size: take8k is a "take"): all but bounce4x, which rotates
# into a shading frame (perf/estbench.py's docstring says why that cannot be
# captured)
CAPTURABLE = ("argsort", "sortu32", "keys", "permute", "packrays", "take", "onehot", "window",
              "wrap_full", "wrap_bare")


def kind(name: str) -> str:
    return re.sub(r"\d+k$", "", name)


def host_inputs(n=N, t_rows=T_ROWS):
    """The JAX harness's arrays from default_rng(0) in its order: keys
    (uint32 < 2^31), ro, rd (float32; rd normalised in float32), perm, then
    (table, idx) at each of t_rows, then the window's table and sorted
    indices at the last."""
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2**31, n).astype(np.uint32)
    ro = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    rd = rng.standard_normal((n, 3)).astype(np.float32)
    rd = rd / np.linalg.norm(rd, axis=1, keepdims=True)
    perm = rng.permutation(n).astype(np.int32)
    tables = []
    for rows in t_rows:
        table = rng.standard_normal((rows, 16)).astype(np.float32)
        tables.append((table, rng.integers(0, rows, n).astype(np.int32)))
    table_w = rng.standard_normal((t_rows[-1], 16)).astype(np.float32)
    idx_w = np.sort(rng.integers(0, t_rows[-1], n).astype(np.int32))
    return dict(keys=keys, ro=ro, rd=rd, perm=perm, tables=tables, table_w=table_w,
                idx_w=idx_w)


def inputs(device, n=N, t_rows=T_ROWS, res=TERRAIN_RES):
    from pyrenderer_tpu_torch.accel.clusters import build_clusters
    from pyrenderer_tpu_torch.config import RenderConfig
    from pyrenderer_tpu_torch.core.integrator import TraceTables
    from pyrenderer_tpu_torch.kernels import cluster
    from pyrenderer_tpu_torch.scene import procgen, to_device
    from pyrenderer_tpu_torch.scene.tungsten import build_scene

    h = host_inputs(n, t_rows)
    ro = torch.as_tensor(h["ro"], device=device)
    rd = torch.as_tensor(h["rd"], device=device)
    cs = build_clusters(*procgen.terrain(res)).to(device)
    host, camera, _ = build_scene(procgen.big_scene_data("terrain", res=res))
    scene, _ = to_device(host, camera, device)
    cfg = RenderConfig(max_bounces=4, spp=1, seed=0)
    return types.SimpleNamespace(
        host=h, n=n, t_rows=t_rows, ro=ro, rd=rd, cs=cs, scene=scene, cfg=cfg,
        keys=torch.as_tensor(h["keys"].astype(np.int32), device=device),
        perm=torch.as_tensor(h["perm"].astype(np.int64), device=device),
        tables=[(torch.as_tensor(t, device=device),
                 torch.as_tensor(i.astype(np.int64), device=device)) for t, i in h["tables"]],
        table_w=torch.as_tensor(h["table_w"], device=device),
        idx_w=torch.as_tensor(h["idx_w"].astype(np.int64), device=device),
        t1v=torch.full((n,), T1, dtype=torch.float32, device=device),
        ops=cluster._operands(cs, ro, rd, T1, False),
        stub=stub_tables(scene, cfg),
        pixel_id=torch.arange(n, dtype=torch.int64, device=device),
        sample_id=torch.zeros(n, dtype=torch.int64, device=device))


def argsort(keys):
    return torch.argsort(keys, stable=True)


def sortu32(keys):
    """Keys below 2^31 in int32: the order of their uint32 values."""
    return torch.sort(keys).values


def keys(cs, ro, rd):
    from pyrenderer_tpu_torch.accel.clusters import sort_keys

    return sort_keys(cs, ro, rd)


def permute(ro, rd, perm):
    """ro and rd gathered by perm, scattered back by its inverse: ro + rd."""
    n = perm.shape[0]
    ro2, rd2 = ro[perm], rd[perm]
    inv = torch.zeros_like(perm).index_put_((perm,), torch.arange(n, device=perm.device))
    return ro2[inv] + rd2[inv]


def packrays(cs, ro, rd, t1v):
    from pyrenderer_tpu_torch.kernels import cluster

    return cluster._prepare(cs, ro, rd, t1v, sort=False)[0]


def take(table, idx):
    return table.index_select(0, idx)


def _onehot(idx, rows, dtype):
    return torch.zeros((idx.shape[0], rows), dtype=dtype, device=idx.device).scatter_(
        1, idx[:, None], 1.0)


def onehot(table, idx, chunk=ONEHOT_CHUNK):
    """The row fetch as one-hot (chunk, T) @ (T, 16) products, IEEE float32."""
    from pyrenderer_tpu_torch.core.intersect import _ieee_fp32

    with _ieee_fp32():
        return torch.cat([_onehot(idx[s:s + chunk], table.shape[0], table.dtype) @ table
                          for s in range(0, idx.shape[0], chunk)])


def window(table, idx_sorted, win=WINDOW, chunk=WINDOW_CHUNK):
    """The one-hot fetch of sorted indices, each chunk over `win` rows from
    its first index (clipped to the table): a row outside its chunk's
    window comes back zero, as in the JAX harness's cost model."""
    from pyrenderer_tpu_torch.core.intersect import _ieee_fp32

    rows = table.shape[0]
    span = torch.arange(win, device=table.device)
    outs = []
    with _ieee_fp32():
        for s in range(0, idx_sorted.shape[0], chunk):
            sl = idx_sorted[s:s + chunk]
            base = sl[0].clamp(0, rows - win)
            wtab = table.index_select(0, base + span)
            hot = (sl - base)[:, None] == span
            outs.append(hot.to(table.dtype) @ wtab)
    return torch.cat(outs)


def wrap_full(cs, ro, rd, t1v):
    """t of the sorted cluster closest_hit (exact t)."""
    from pyrenderer_tpu_torch.kernels import cluster

    return cluster.closest_hit(cs, ro, rd, T0, t1v, sort=True)[1]


def wrap_bare(cs, ops):
    """The closest-hit sweep alone on prepared operands (kernels/cluster
    _operands): one launch of B3 on a CUDA device, its twin (the resume
    mode's walk from a miss without a budget, the same walk) on the CPU;
    1 where the ray hit, as the JAX harness reduces it."""
    from pyrenderer_tpu_torch.accel.clusters import MISS_T, closest_hit_resume_ref
    from pyrenderer_tpu_torch.kernels import build, cluster

    rays, _, order, super_sorted = ops
    n = rays.shape[0]
    if build.on_cuda(rays, "wrap_bare"):
        t = torch.empty(n, dtype=torch.float32, device=rays.device)
        slot = torch.empty(n, dtype=torch.int32, device=rays.device)
        cluster._launch(cluster.closest_hit, cs, ops, T0, False, (t, slot))
    else:
        t, _, _ = closest_hit_resume_ref(
            cs, rays, order, super_sorted, torch.full((n,), MISS_T, device=rays.device),
            torch.full((n,), -1, dtype=torch.int32, device=rays.device), T0, 0)
    return torch.where(t < 1e30, 1.0, 0.0)


def stub_tables(scene, cfg):
    """The JAX harness's stub: every ray hits face (lane mod T) at t = 0.5,
    no shadow ray is blocked."""
    from pyrenderer_tpu_torch.core.integrator import TraceTables

    tables = TraceTables(scene, cfg, "brute")
    nt = scene.faces.shape[0]

    def closest(ro, rd, t1):
        n = ro.shape[0]
        lanes = torch.arange(n, device=ro.device)
        return (torch.ones(n, dtype=torch.bool, device=ro.device),
                torch.full((n,), 0.5, dtype=ro.dtype, device=ro.device), lanes % nt)

    def any_hit(ro, rd, t1):
        return torch.zeros(ro.shape[0], dtype=torch.bool, device=ro.device)

    return TraceTables.custom(tables.face_data, tables.light_data, closest, any_hit)


def bounce4x(scene, cfg, stub, ro, rd, pixel_id, sample_id):
    from pyrenderer_tpu_torch.core.integrator import trace_reference

    return trace_reference(scene, cfg, ro, rd, pixel_id, sample_id, 0, tables=stub)


def stages(x):
    """(name, fn, args, note) of every row, in the JAX harness's order."""
    rows = [
        ("argsort", argsort, (x.keys,), ""),
        ("sortu32", sortu32, (x.keys,), ""),
        ("keys", keys, (x.cs, x.ro, x.rd), ""),
        ("permute", permute, (x.ro, x.rd, x.perm), "fwd gather + inv scatter, ro+rd"),
        ("packrays", packrays, (x.cs, x.ro, x.rd, x.t1v), ""),
    ]
    for rows_t, (table, idx) in zip(x.t_rows, x.tables):
        k = f"{rows_t // 1000}k"
        rows.append((f"take{k}", take, (table, idx), ""))
        rows.append((f"onehot{k}", onehot, (table, idx), "IEEE float32"))
    rows += [
        (f"window{x.t_rows[-1] // 1000}k", window, (x.table_w, x.idx_w), "IEEE float32"),
        ("wrap_full", wrap_full, (x.cs, x.ro, x.rd, x.t1v),
         "sorted closest_hit incl. kernel, shuffled rays"),
        ("wrap_bare", wrap_bare, (x.cs, x.ops), "bare kernel, same rays unsorted"),
        ("bounce4x", bounce4x, (x.scene, x.cfg, x.stub, x.ro, x.rd, x.pixel_id, x.sample_id),
         "4-bounce integrator, stubbed intersection"),
    ]
    return rows


def run(device, args):
    from pyrenderer_tpu_torch.utils.profiling import slope_time

    x = inputs(device, args.n)
    report = harness.Report("glue2", device, args.n, reps=args.reps, rows=list(x.t_rows),
                            terrain_res=TERRAIN_RES)
    for name, fn, fn_args, note in stages(x):
        st = slope_time(fn, *fn_args, reps=args.reps, graph=kind(name) in CAPTURABLE,
                        profile=not args.no_profile)
        extra = {}
        if name == "bounce4x":
            extra["ns_per_ray_bounce"] = st.eager_ms * 1e6 / (4 * args.n)
        report.row(name, st, note=note, **extra)
    return report.result()


def main(argv=None) -> int:
    args = harness.parser(__doc__.split("\n\n")[0], N).parse_args(argv)
    return harness.main(run, args)


if __name__ == "__main__":
    sys.exit(main())
