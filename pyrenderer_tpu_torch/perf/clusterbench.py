"""The cluster-sweep, binned and whole-table kernels on the GPU: each
kernel timed alone and with its wrapper's glue, checked ray by ray or pair
by pair, and the frame's device profile.

    python -m pyrenderer_tpu_torch.perf.clusterbench kernels [sweep|binned|whole|probes] [--parity] [--out DIR]
    python -m pyrenderer_tpu_torch.perf.clusterbench compare DIR_A DIR_B
    python -m pyrenderer_tpu_torch.perf.clusterbench profile [--backend B] [--scene S] [--estimator E] [--trace-dir DIR]
    python -m pyrenderer_tpu_torch.perf.clusterbench frames [--out DIR]

``kernels`` builds terrain100k (scene/procgen.py terrain res=224, 100,364
triangles) and records the integrator's bounce-1 wavefront and its NEE
shadow rays (65,536 rays: the first Morton chunk of 512x512, seed 0,
watertight leaves), then times, for sort off and on, the closest-hit
kernel on the wavefront and the any-hit kernel on the shadow rays:
"alone" is one launch of the C entry point on operands prepared
beforehand, "wrapper" the public closest_hit / occluded with their sort,
rank and scatter glue, "dead" the kernel alone on the same rays with t1
= 0 (the cost of launching a warp per ray); all replayed from CUDA graphs
of REPS calls (perf/kernelbench.graph_ms), in turns. It prints the ptxas
report of the cluster kernels (when this process built them), how the
walk's leaves spread over the live rays (walk), and one JSON line. With
--parity it also runs both kernels, MT and watertight, sort off and on, on
PARITY_SETS, holds (t, slot) and occlusion against the plain twins, and
saves the ray sets and every result to DIR for ``compare``.

``kernels binned`` does the same for the four binned kernels
(kernels/binned.py) on the same wavefront and shadow rays: the prepass at
W = 6 with and without the words and at W = 10 with them (the streamed
path's call), and at each span of PREPASS_SPANS where the checkout has
PREPASS_SPAN; the peel at W = 6 on the prepass's words and at W = 10 on
the streamed path's round-2 and round-3 words (each with its bound); each
leaf at W = 6 with MT and watertight leaves (the streamed leaf also with
the other runs per block of RUN_CAPS), each alone from CUDA graphs, then
the binned wrappers, resident and streamed, with their glue (eager calls:
each query reads the device); it prints the ptxas report of
csrc/binned.cu. With --parity it runs the prepass and every peel round
after it on every PARITY_SETS set (prepass_sets: W = 6 and 1, the bounce-1
sets also at 10), on the launch edges (prepass_edges) and on terrain330k,
against the twins, and saves their outputs to DIR/prepass.pt; then both
leaves on the pairs of every PARITY_SETS set at W = 6 and 1, on the launch
edges (edge_streams) and on the duplicate triangles (duplicate_set),
holds every key against the resident twin and saves the pairs and keys
to DIR/binned.pt.

``kernels whole`` times the two whole-table kernels (csrc/intersect.cu,
kernels/intersect.py) at both shapes the frames give them: Cornell (36
triangles) on chip_smoke.py phase 2's sets, and Cornell and spheres (3,852)
on the bounce-1 wavefront and shadow rays of their pbrt frames
(whole_wavefronts): each kernel alone (one launch of its C entry point on
outputs allocated beforehand), through its wrapper, and, where the
checkout has pr_whole_table_g, at each of WHOLE_LANES lanes per ray, with
each set's bound; it prints the ptxas report of both kernels. With
--parity it runs both kernels on every set of whole_sets (those, 65,536
random rays against the spheres table, duplicate triangles and the launch
edges), through the wrappers and at every lane count, holds hit, t's bits,
face and occlusion against the twins ray by ray and saves the rays and the
wrappers' results to DIR/whole.pt.

``kernels probes`` times the four probe kernels B9-B12 (csrc/kernelbench.cu,
perf/kernelbench.py) through their wrappers at every parameter of the
harness's lists at 256 tiles of 128 rays, each with its bound, its floor
(probe_floor) and the SM clock that nvidia-smi reads meanwhile; it prints
the ptxas report of the probe kernels, saves the library's SASS to
DIR/probes.sass, prints each probe loop's instructions a test
(sass_loops), and measures the latency of each instruction class on a
reduction's chain with perf/latency.cu (built on its own; latency_report),
from which the extract's latency floor is read off its round's SASS
(round_cycles). With --parity it runs every probe on probe_sets (the
harness's operands at 256, 1, 3 and 300 tiles, the same at 2 tiles in
rows that start 4 bytes past a 16-byte boundary, and the edge sets of
probe_edges at PROBE_COUNTS; on every set the extract also at
PROBE_COUNTS and the ctz at PROBE_WORDS), holds each output's bits
against its twin's and saves the operands and the outputs to
DIR/probes.pt.

The kernels are driven only through names an older checkout of the port
has too (kernels/cluster.py _check_cuda_args, _prepare, _sc_order,
_unsort; perf/kernelbench.py inputs, the four probes, their twins and
its lists; kernels/binned.py prepass, peel, their twins, sort_pairs,
blocks_for, leaf, leaf_streamed, leaf_ref, RUN_PAIRS or _THREADS, and
PREPASS_SPAN where it exists; kernels/intersect.py
pack_triangles, closest_hit, occluded, their twins and _check_cuda_args;
kernels/build.launch; perf/kernelbench.graph_ms, cuda_ms), and never
through the wrappers' launch counts, so this file times and checks an
older checkout's kernels when that checkout comes first on the path:

    PYTHONPATH=OLD python pyrenderer_tpu_torch/perf/clusterbench.py kernels binned --parity --out A
    PYTHONPATH=. python pyrenderer_tpu_torch/perf/clusterbench.py kernels binned --parity --out B
    PYTHONPATH=. python pyrenderer_tpu_torch/perf/clusterbench.py compare A B

``compare`` counts, per ray set and configuration, the rays (or pairs) on
which the two runs' kernels differ and, for the leaves and the sweep, on
how many of them each run agrees with the twin.

``profile`` runs chunk-samples of the terrain100k frame (512x512, 4
bounces, the first 2^16-pixel chunk) through backend "cluster",
"cluster_binned" or "cluster_streamed", or with ``--backend cuda`` of the
Cornell or spheres frame (``--scene``, 1024x1024, 4 bounces) through the
whole-table kernels, with the reference or pbrt estimator: the wall time per
chunk-sample (host clock, median of 3 windows), then one window under
torch.profiler (utils/profiling.trace_profile, which writes its Chrome
trace to ``--trace-dir``): device busy time (utils/profiling.device_busy,
the union of the kernels' intervals),
the idle share against the unprofiled wall, device ms by kernel name for
the kernels defined in an anonymous namespace (the port's, and a few of
PyTorch's) and for all the others together, per chunk-sample and per frame
(the bench row's chunks x spp), and the host's kernel launches and stream
syncs.

``frames`` renders the Cornell box (render_image, 1024x1024, 2 spp, seed
0) with each estimator and depth of FRAMES and saves the images to
DIR/frames.pt, so that ``compare`` shows whether a change moved a forward
frame by a single bit (run it for a parent checkout as ``kernels`` is).

Runs on a GPU only; every time names the card (nvidia-smi's name and
power limit).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
import types

import numpy as np
import torch

T0 = 1e-5
T_MAX = 99999.9
N_RAYS = 1 << 16
REPS = 20
SAMPLES = 4       # chunk-samples per profiled window
# the ray sets of phase 6 of chip_smoke.py at terrain100k, the edges of a
# launch there (one ray, a count that fills no whole block, a dead
# wavefront), and the card-only test's sets at terrain8k
# (tests/test_torch_cluster.py test_cluster_kernels_match_twins_on_gpu)
PARITY_SETS = ("random", "camera", "bounce1", "shadow1", "dead", "per_ray_t1", "ragged",
               "one", "five", "all_dead", "test_random", "test_one", "test_five",
               "test_dead")
# runs per block of the streamed leaf that `kernels binned` times beside
# blocks_for's own (every one at most the 128 pairs an older kernel takes)
RUN_CAPS = (16, 32, 64, 128)
# rays per block of the prepass and of the peel that `kernels binned` times
# (PREPASS_SPAN, PEEL_SPAN)
PREPASS_SPANS = (16, 32, 64, 128)
PEEL_SPANS = (32, 64, 128)
# the kernels' bounds, as chip_smoke.py counts them: fp32 operations over
# the card's fp32 peak, bytes over its memory rate (NVIDIA's H100 SXM data
# sheet, 700 W); SLAB_OPS per slab test (the prepass)
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
SLAB_OPS = 26


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def random_rays(n, seed, dev):
    """Rays inside the box, as tests/test_pallas.py makes them."""
    rs = np.random.RandomState(seed)
    ro = rs.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    ro[:, 1] += 1.0
    rd = rs.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return torch.as_tensor(ro, device=dev), torch.as_tensor(rd, device=dev)


def wavefronts(scene, camera, tables, cfg, px, py, module="cluster_kernels"):
    """The integrator's real bounce-1 wavefront: the (ro, rd, t1) of the
    second closest-hit query and of the second shadow query that
    render_sample makes, recorded on their way to the kernel wrappers of
    `module` (the integrator's name for kernels/cluster.py, or "kernels"
    for the whole-table kernels)."""
    from pyrenderer_tpu_torch.core import integrator

    wrappers = getattr(integrator, module)
    calls = {"closest_hit": [], "occluded": []}

    def recorder(name):
        def record(table, ro, rd, t0, t1, **kw):
            calls[name].append((ro.contiguous(), rd.contiguous(), t1.contiguous()))
            return getattr(wrappers, name)(table, ro, rd, t0, t1, **kw)
        return record

    setattr(integrator, module,
            types.SimpleNamespace(**{name: recorder(name) for name in calls}))
    try:
        integrator.render_sample(scene, camera, cfg.replace(max_bounces=2),
                                 cfg.seed, 0, px, py, tables=tables)
    finally:
        setattr(integrator, module, wrappers)
    return calls["closest_hit"][1], calls["occluded"][1]


def walk(cs, ro, rd, t1, t_final=None, watertight=True, budget=0):
    """The tests that the cluster kernels' front-to-back walk
    (csrc/cluster.cu sweep, superclusters in kernels/cluster._sc_order's
    rank) needs at the least, per ray: for each live ray (t1 > T0) a slab
    test of each supercluster, of the 16 children of each one it crosses,
    and a 128-triangle leaf for each child it crosses. Closest hit (t_final
    given): the walk culls with each ray's final t from the start (t_final:
    the twin's t on a hit, t1 on a miss), which culls no less than the
    kernel's running bound. Any hit (t_final None): the walk culls with t1
    and a ray stops at its first occluder, counting the leaf's lanes up to
    it. With budget > 0 (the closest hit's suspend pass) a ray stops after
    the budget-th supercluster it crosses. Returns (slab tests (N,),
    triangle tests (N,), the rays the walk found occluded)."""
    from pyrenderer_tpu_torch.accel import clusters as cl
    from pyrenderer_tpu_torch.kernels.cluster import _sc_order

    n = ro.shape[0]
    t1v = torch.as_tensor(t1, dtype=torch.float32, device=ro.device).expand(n)
    bound_t = t1v if t_final is None else t_final
    inv_d = 1.0 / torch.where(rd == 0, 1e-20, rd)
    going = t1v > T0
    order, super_sorted = _sc_order(cs, ro)
    tri = cs.tri.reshape(cs.n_clusters, cl.TRI_ROWS, cl.LANE_TRIS)
    slabs = torch.zeros(n, dtype=torch.int64, device=ro.device)
    tests = torch.zeros(n, dtype=torch.int64, device=ro.device)
    visits = torch.zeros(n, dtype=torch.int64, device=ro.device)
    for rank, s in enumerate(order[:cs.n_superclusters].tolist()):
        slabs += going
        inside = going & cl._slab(super_sorted[rank, 0:3], super_sorted[rank, 3:6], ro,
                                  inv_d, T0, bound_t)
        for j in range(s * cl.GROUP, (s + 1) * cl.GROUP):
            slabs += inside
            cross = inside & cl._slab(cs.child_box[j, 0:3], cs.child_box[j, 3:6], ro, inv_d,
                                      T0, bound_t)
            if t_final is not None:
                tests += cross * cl.LANE_TRIS
                continue
            idx = cross.nonzero()[:, 0]
            if idx.numel() == 0:
                continue
            occ = cl._leaf(tri[j], ro[idx], rd[idx], T0, t1v[idx], watertight) < cl.MISS_T
            stop = occ.any(dim=1)
            tests[idx] += torch.where(stop, occ.int().argmax(dim=1) + 1, cl.LANE_TRIS)
            going[idx[stop]] = False
            inside[idx[stop]] = False
        if budget > 0:
            visits += inside
            going &= visits < budget
    return slabs, tests, (t1v > T0) & ~going


def morton_chunk(res, dev):
    """(px, py) of the first 2^16 pixels of a res x res frame in Morton order."""
    from pyrenderer_tpu_torch.core.camera import morton_pixel_order

    perm, _ = morton_pixel_order(res, res)
    ys, xs = np.mgrid[0:res, 0:res]
    return (torch.as_tensor(xs.reshape(-1)[perm][:N_RAYS], device=dev),
            torch.as_tensor(ys.reshape(-1)[perm][:N_RAYS], device=dev))


def terrain(res, dev, image=512):
    """(scene, camera, ClusterScene) of big_scene_data("terrain", res) on `dev`."""
    from pyrenderer_tpu_torch.accel import clusters as cl
    from pyrenderer_tpu_torch.scene import procgen, to_device
    from pyrenderer_tpu_torch.scene.tungsten import build_scene

    host, cam, _ = build_scene(procgen.big_scene_data("terrain", res=res))
    scene, camera = to_device(host, cam._replace(resolution=(image, image)), dev)
    return scene, camera, cl.build_clusters(host.vertices, host.faces).to(dev)


def bounce1(scene, camera, cs, dev):
    """The bounce-1 wavefront and its shadow rays at 512x512, watertight."""
    from pyrenderer_tpu_torch.config import RenderConfig
    from pyrenderer_tpu_torch.core.integrator import TraceTables

    cfg = RenderConfig(max_bounces=4, spp=4, seed=0, estimator="reference",
                       cluster_watertight=True)
    return wavefronts(scene, camera, TraceTables(scene, cfg, accel=cs), cfg,
                      *morton_chunk(512, dev))


def launch(cs, ro, rd, t1, sort, watertight, closest):
    """One kernel launch on operands prepared here; returns (fn() that
    launches it again on the same operands, its outputs in launch order, the
    permutation or None)."""
    from pyrenderer_tpu_torch.kernels import build
    from pyrenderer_tpu_torch.kernels import cluster as kc

    kc._check_cuda_args(cs, ro, rd)
    rays, perm = kc._prepare(cs, ro, rd, t1, sort)
    order, super_sorted = kc._sc_order(cs, ro)
    # the child boxes as the checkout's kernels read them: the compact
    # (K, 8) copy, or the (K, 128) rows of a checkout without one
    child_box = getattr(cs, "child_box8", cs.child_box)
    n = ro.shape[0]
    if closest:
        name = "pr_cluster_closest"
        outs = (torch.empty(n, dtype=torch.float32, device=ro.device),
                torch.empty(n, dtype=torch.int32, device=ro.device))
    else:
        name = "pr_cluster_occluded"
        outs = (torch.empty(n, dtype=torch.bool, device=ro.device),)

    def fn():
        build.launch(name, ro.device, cs.tri.data_ptr(), child_box.data_ptr(),
                     super_sorted.data_ptr(), order.data_ptr(), order.shape[0],
                     rays.data_ptr(), float(T0), n, int(watertight),
                     *[o.data_ptr() for o in outs])

    fn()
    return fn, outs, perm


def run_kernels(cs, ro, rd, t1, sort, watertight):
    """(t (N,) f32, 3e38 on a miss; slot (N,) i32, -1 on a miss; occluded
    (N,) bool) of both kernels, in the caller's order."""
    from pyrenderer_tpu_torch.kernels.cluster import _unsort

    _, (t, slot), perm = launch(cs, ro, rd, t1, sort, watertight, True)
    _, (occ,), perm_o = launch(cs, ro, rd, t1, sort, watertight, False)
    torch.cuda.synchronize()
    return _unsort(t, perm), _unsort(slot, perm), _unsort(occ, perm_o)


def ptxas_lines(log: str, pattern, tag_fn):
    """The ptxas lines (registers, shared memory, spills) in `log` of every
    kernel whose entry line matches `pattern`, each as "ptxas <tag>:
    <report>" with tag_fn(match) naming the kernel."""
    out, entry = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line
            continue
        m = re.search(pattern, entry or "")
        if m and ("Used" in line or "spill" in line):
            out.append(f"ptxas {tag_fn(m)}: {re.sub(r'^ptxas info *: *', '', line.strip())}")
    return out


def _template_flags(m):
    """A cluster or binned kernel's name with its template flags (a binned
    leaf's clusters a bin; leaves MT or watertight; the resume mode)."""
    flags = re.findall(r"Lb([01])E", m.string)
    tag = m.group(0)
    bins = re.findall(r"_kernelILi(\d+)E", m.string)
    if bins:
        tag += f" bin {bins[0]}"
    if flags:
        tag += " watertight" if flags[0] == "1" else " MT"
    if flags[1:] == ["1"]:
        tag += " resume"
    return tag


def ptxas_report(log: str, source="cluster"):
    """The ptxas lines of the kernels of csrc/<source>.cu ("cluster" or
    "binned") in `log`, each named by its kernel and its template flags."""
    return ptxas_lines(log, rf"{source}_[a-z_]+?_kernel", _template_flags)


def parity_sets(dev, cs100, scene, camera, b1, s1):
    """label -> (ClusterScene, ro, rd, t1) for PARITY_SETS."""
    from pyrenderer_tpu_torch.core.camera import generate_rays

    ro, rd = random_rays(N_RAYS, 0, dev)
    lanes = torch.arange(N_RAYS, device=dev)
    cro, crd = generate_rays(camera, *morton_chunk(512, dev), 0, 0)
    t1_var = torch.as_tensor(np.random.RandomState(1).uniform(0.1, 3.0, N_RAYS),
                             dtype=torch.float32, device=dev)
    rro, rrd = random_rays(100, 4, dev)
    sets = {
        "random": (cs100, ro, rd, T_MAX),
        "camera": (cs100, cro.contiguous(), crd.contiguous(), T_MAX),
        "bounce1": (cs100, *b1),
        "shadow1": (cs100, *s1),
        "dead": (cs100, ro, rd, torch.where(lanes % 3 == 0, 0.0, T_MAX).float()),
        "per_ray_t1": (cs100, ro, rd, t1_var),
        "ragged": (cs100, rro, rrd, T_MAX),
        "one": (cs100, ro[:1], rd[:1], T_MAX),
        "five": (cs100, ro[:5], rd[:5], T_MAX),
        "all_dead": (cs100, ro[:4096], rd[:4096], torch.zeros(4096, device=dev)),
    }
    _, _, cs8 = terrain(64, dev)
    tro, trd = random_rays(1 << 14, 0, dev)
    sets.update({
        "test_random": (cs8, tro, trd,
                        torch.where(torch.arange(1 << 14, device=dev) % 3 == 0, 0.0, 0.5)),
        "test_one": (cs8, tro[:1], trd[:1], 1e5),
        "test_five": (cs8, tro[:5], trd[:5], 1e5),
        "test_dead": (cs8, tro[:256], trd[:256], torch.zeros(256, device=dev)),
    })
    assert tuple(sets) == PARITY_SETS
    return sets


def check_parity(sets, out_dir):
    """Both kernels against the twins on every set, MT and watertight, sort
    off and on; prints one line per case and saves rays and results."""
    from pyrenderer_tpu_torch.accel import clusters as cl

    saved = {}
    for label, (cs, ro, rd, t1) in sets.items():
        t1v = torch.as_tensor(t1, dtype=torch.float32, device=ro.device).expand(ro.shape[0])
        saved[label] = {"rays": (ro.cpu(), rd.cpu(), t1v.cpu())}
        for wt in (False, True):
            hit_r, t_r, slot_r = cl.closest_hit_ref(cs, ro, rd, T0, t1, watertight=wt)
            saved[label][(wt, "twin")] = (t_r.cpu(), slot_r.cpu())
            for sort in (False, True):
                t, slot, occ = run_kernels(cs, ro, rd, t1, sort, wt)
                t = torch.where(slot >= 0, t, 0.0)
                same = (t == t_r) & (slot == slot_r)
                print(f"parity {label}, {'watertight' if wt else 'MT'}, sort "
                      f"{'on' if sort else 'off'}: n={ro.shape[0]} hits={int(hit_r.sum())} "
                      f"(t, slot) equal to the twin on {int(same.sum())}, occlusion "
                      f"{'equal' if torch.equal(occ, hit_r) else 'DIFFERS'} "
                      f"({int((occ != hit_r).sum())} rays)", flush=True)
                saved[label][(wt, sort)] = (t.cpu(), slot.cpu(), occ.cpu())
    os.makedirs(out_dir, exist_ok=True)
    torch.save(saved, os.path.join(out_dir, "parity.pt"))


# (source, copy) slots within one bin of duplicate_triangles: the copy at the
# higher slot, across the lanes of a warp's split (31/32, 63/64), within one
# lane (95/127) and across the bin's clusters 0 and 3
DUPLICATES = ((31, 32), (63, 64), (95, 127), (10, 3 * 128 + 10), (100, 3 * 128 + 3))


def aimed_rays(v0, e1, e2, ro, rd):
    """Appends to the lists ro, rd nine rays into the triangle (v0, e1, e2):
    three points inside it, each from along its normal and tilted toward x
    and toward z (so that the watertight shear takes every axis), starting
    0.5 before the point."""
    v0, e1, e2 = (np.asarray(x, np.float64) for x in (v0, e1, e2))
    normal = np.cross(e1, e2)
    normal /= np.linalg.norm(normal)
    for u, v in ((1 / 3, 1 / 3), (0.2, 0.5), (0.6, 0.2)):
        point = v0 + u * e1 + v * e2
        for tilt in ((0.0, 0.0, 0.0), (1.5, 0.0, 0.0), (0.0, 0.0, 1.5)):
            d = -(normal + np.asarray(tilt))
            d /= np.linalg.norm(d)
            ro.append(point - 0.5 * d)
            rd.append(d)


def duplicate_triangles(tri, order):
    """A lane split's edge for the binned leaves: exact duplicate triangles
    in one bin, whose hits must resolve to the lower slot. tri (K*16, 128)
    and order (K*128,) are a ClusterScene's tables as NumPy arrays. Returns
    (the bin b: the first whose 512 slots hold 512 distinct faces; a copy of
    tri in which slot b*512 + copy of each DUPLICATES pair holds the
    triangle of slot b*512 + source; rays ro, rd (N, 3) f32, aimed_rays
    into each source triangle)."""
    from pyrenderer_tpu_torch.accel.clusters import BIN_TRIS, LANE_TRIS, TRI_ROWS

    faces = order.reshape(-1, BIN_TRIS)
    b = next(i for i, f in enumerate(faces) if len(np.unique(f)) == BIN_TRIS)
    tri = tri.copy()
    rows = tri.reshape(-1, TRI_ROWS, LANE_TRIS)          # a view of the copy
    ro, rd = [], []
    for src, dst in DUPLICATES:
        cs_, ls = divmod(b * BIN_TRIS + src, LANE_TRIS)
        cd, ld = divmod(b * BIN_TRIS + dst, LANE_TRIS)
        rows[cd, :, ld] = rows[cs_, :, ls]
        aimed_rays(*(rows[cs_, k:k + 3, ls] for k in (0, 3, 6)), ro, rd)
    return b, tri, np.asarray(ro, np.float32), np.asarray(rd, np.float32)


# (source, copy) faces of whole_table_duplicates: neighbours (0/1), across a
# warp's 32 lanes (31/32), across a tile of 256 or of 512 triangles
# (255/256, 511/512) and the first and last faces; -1 is the last face
WHOLE_DUPLICATES = ((0, 1), (31, 32), (255, 256), (511, 512), (0, -1))


def whole_table_duplicates(table):
    """The lane split's edge for the whole-table kernels: a copy of the
    (9, T) table (T > 512, a NumPy array) in which each WHOLE_DUPLICATES
    copy holds its source triangle, and aimed_rays into each source (ro, rd
    (N, 3) f32). A ray whose closest hit is a source must report the
    source, the lower face, never its copy."""
    table = table.copy()
    n_tris = table.shape[1]
    ro, rd = [], []
    for src, dst in WHOLE_DUPLICATES:
        table[:, dst % n_tris] = table[:, src]
        aimed_rays(table[0:3, src], table[3:6, src], table[6:9, src], ro, rd)
    return table, np.asarray(ro, np.float32), np.asarray(rd, np.float32)


def duplicate_set(cs, dev):
    """duplicate_triangles on a ClusterScene: (its copy with the duplicates,
    rays (N, 8) of kernels/cluster._prepare, sortd (N,) the bin for every
    ray, pair_ray (N,) = arange, the copies' slots, the sources' slots)."""
    import dataclasses

    from pyrenderer_tpu_torch.accel.clusters import BIN_TRIS
    from pyrenderer_tpu_torch.kernels import cluster as kc

    b, tri, ro, rd = duplicate_triangles(cs.tri.cpu().numpy(), cs.order.cpu().numpy())
    cs_dup = dataclasses.replace(cs, tri=torch.as_tensor(tri, device=dev))
    ro, rd = torch.as_tensor(ro, device=dev), torch.as_tensor(rd, device=dev)
    rays = kc._prepare(cs_dup, ro, rd, T_MAX, sort=False)[0]
    n = ro.shape[0]
    return (cs_dup, rays, torch.full((n,), b, dtype=torch.int32, device=dev),
            torch.arange(n, device=dev), [b * BIN_TRIS + d for _, d in DUPLICATES],
            [b * BIN_TRIS + s for s, _ in DUPLICATES])


def edge_streams(kb, cs, rays):
    """label -> (sortd, pair_ray, rays) of the launch edges of the binned
    leaves, cut from the sorted pair stream of `rays` (N, 8) at W = 6: one
    pair; 33 pairs; the whole run of the bin with the most pairs (more than
    129); that bin's first 129 pairs (blocks_for's last piece holds one pair
    at runs of 16, 32, 64 or 128); 64 SENTINEL pairs; every pair with its
    ray dead (t1 = 0)."""
    ids, _ = kb.prepass(cs, rays, T0, 6)
    sortd, pair_ray = kb.sort_pairs(ids, int((ids != kb.SENTINEL).sum()))
    _, counts = torch.unique_consecutive(sortd, return_counts=True)
    big = int(counts.argmax())
    start, n_big = int(counts[:big].sum()), int(counts[big])
    if n_big <= 129:
        raise ValueError(f"no bin has more than 129 pairs: {n_big}")
    dead = rays.clone()
    dead[:, 6] = 0.0
    dev = rays.device
    run = slice(start, start + n_big)
    one_more = slice(start, start + 129)
    return {
        "one pair": (sortd[:1], pair_ray[:1], rays),
        "33 pairs": (sortd[:33], pair_ray[:33], rays),
        "the largest bin": (sortd[run], pair_ray[run], rays),
        "last piece of one pair": (sortd[one_more], pair_ray[one_more], rays),
        "all SENTINEL": (torch.full((64,), kb.SENTINEL, dtype=torch.int32, device=dev),
                         torch.arange(64, device=dev), rays),
        "dead rays": (sortd, pair_ray, dead),
    }


EDGE_STREAMS = ("one pair", "33 pairs", "the largest bin", "last piece of one pair",
                "all SENTINEL", "dead rays")

PREPASS_EDGES = ("all dead", "every third dead", "t1 = t0", "t1 = t0, origins in bins",
                 "t1 below t0", "t1 NaN", "t1 inf", "t1 negative", "origins on bin corners",
                 "N = 1", "N = 31", "N = 33", "N = 129")


def edge_words(n, n_words):
    """(n, n_words) int32 crossing words for the peel's edges, 16 rows each:
    bit 31 (INT32_MIN) alone in the first or in the last word, every word
    full (0xFFFFFFFF), the first or the last word full, bits 31 and 0 of the
    first word with bit 31 of the last, fewer set bits than any W (0b101 in
    the first word, bit 0 of the last), no bit; then random words (seed 5)."""
    rs = np.random.RandomState(5)
    words = rs.randint(-2 ** 31, 2 ** 31, size=(n, n_words), dtype=np.int64)
    low = -2 ** 31
    for k, (head, tail, rest) in enumerate(((low, 0, 0), (0, low, 0), (-1, -1, -1),
                                            (-1, 0, 0), (0, -1, 0), (low + 1, low, 0),
                                            (0b101, 0, 0), (0, 1, 0), (0, 0, 0))):
        words[16 * k:16 * (k + 1)] = rest
        words[16 * k:16 * (k + 1), 0] = head
        words[16 * k:16 * (k + 1), -1] = tail
    return words.astype(np.int32)


def prepass_edges(cs, rays):
    """label -> rays (N, 8) (kernels/cluster._prepare rows) of the launch
    edges of the prepass and the peel, cut from the first 4,096 of `rays`:
    every ray dead (t1 = 0); every third ray dead; t1 exactly T0 (live: a
    box whose inside holds the origin crosses), and so again with the
    origins at the centres of the real bins' boxes; t1 one float below T0
    and NaN (both dead); t1 +inf and negative; origins on the real bins'
    lower corners, every second ray with a subnormal x direction (its
    reciprocal is infinite, so (b - o) * inv is NaN on those faces); N = 1,
    31, 33 and 129 (no whole warp or block)."""
    base = rays[:4096]
    n = base.shape[0]
    t0 = torch.tensor(T0, dtype=torch.float32)

    def with_t1(t1):
        out = base.clone()
        out[:, 6] = t1
        return out

    third = base.clone()
    third[::3, 6] = 0.0
    # (a checkout before the compact copy has only bin_box)
    box = getattr(cs, "bin_box8", cs.bin_box)[:, :6]
    real = box[torch.isfinite(box).all(dim=1)]
    inside = with_t1(t0)
    centres = 0.5 * (real[:, 0:3] + real[:, 3:6])
    inside[:, 0:3] = centres.repeat(-(-n // centres.shape[0]), 1)[:n]
    corners = base.clone()
    corners[:, 0:3] = real[:, 0:3].repeat(-(-n // real.shape[0]), 1)[:n]
    corners[::2, 3] = 1e-40
    sets = {
        "all dead": with_t1(0.0),
        "every third dead": third,
        "t1 = t0": with_t1(t0),
        "t1 = t0, origins in bins": inside,
        "t1 below t0": with_t1(torch.nextafter(t0, torch.zeros(()))),
        "t1 NaN": with_t1(float("nan")),
        "t1 inf": with_t1(float("inf")),
        "t1 negative": with_t1(-1.0),
        "origins on bin corners": corners,
    }
    for k in (1, 31, 33, 129):
        sets[f"N = {k}"] = base[:k].clone()
    assert tuple(sets) == PREPASS_EDGES
    return sets


def walk_spread(cs, b1, s1):
    """Prints how the walk's leaf work spreads over the live rays of the
    bounce-1 wavefront (closest hit, culled by the twin's final t) and its
    shadow rays (any hit, up to the first occluder)."""
    from pyrenderer_tpu_torch.accel import clusters as cl

    hit, t, _ = cl.closest_hit_ref(cs, b1[0], b1[1], T0, b1[2], watertight=True)
    for label, (ro, rd, t1), t_final in (("wavefront", b1, torch.where(hit, t, b1[2])),
                                         ("shadow rays", s1, None)):
        slabs, tests, _ = walk(cs, ro, rd, t1, t_final)
        live = t1 > T0
        leaves = tests[live].double() / cl.LANE_TRIS
        q = torch.quantile(leaves, torch.tensor([0.5, 0.9, 0.99], dtype=torch.float64,
                                                device=leaves.device)).tolist()
        print(f"walk of the bounce-1 {label}, per live ray ({int(live.sum())}): leaves mean "
              f"{float(leaves.mean()):.3f}, p50 {q[0]:.3f}, p90 {q[1]:.3f}, p99 {q[2]:.3f}, max "
              f"{float(leaves.max()):.3f}; slab tests mean {float(slabs[live].double().mean()):.1f},"
              f" max {int(slabs.max())}", flush=True)


def cmd_kernels(args) -> int:
    import pyrenderer_tpu_torch
    from pyrenderer_tpu_torch.kernels import build
    from pyrenderer_tpu_torch.kernels import cluster as kc
    from pyrenderer_tpu_torch.perf.kernelbench import graph_ms

    dev = torch.device("cuda:0")
    card = card_line()
    package = os.path.dirname(os.path.abspath(pyrenderer_tpu_torch.__file__))
    print(f"package {package}; {card}", flush=True)
    t = time.perf_counter()
    build.library()
    print(f"kernels built or loaded in {time.perf_counter() - t:.2f} s", flush=True)
    for line in ptxas_report(build.build_log()):
        print(line)
    scene, camera, cs = terrain(224, dev)
    b1, s1 = bounce1(scene, camera, cs, dev)
    print(f"bounce-1 wavefront: {int((b1[2] > 0).sum())} live rays of {N_RAYS}; shadow rays: "
          f"{int((s1[2] > 0).sum())} live", flush=True)

    cases = {}
    for query, (ro, rd, t1) in (("closest_hit", b1), ("occluded", s1)):
        closest = query == "closest_hit"
        for sort in (False, True):
            alone, _, _ = launch(cs, ro, rd, t1, sort, True, closest)
            if closest:
                def wrapper(ro=ro, rd=rd, t1=t1, sort=sort):
                    kc.closest_hit(cs, ro, rd, T0, t1, sort=sort, watertight=True,
                                   exact_t=False)
            else:
                def wrapper(ro=ro, rd=rd, t1=t1, sort=sort):
                    kc.occluded(cs, ro, rd, T0, t1, sort=sort, watertight=True)
            tag = "sorted" if sort else "unsorted"
            cases[(query, tag, "alone")] = alone
            cases[(query, tag, "wrapper")] = wrapper
        # the same rays all dead: what the launch of N warps costs by itself
        cases[(query, "dead", "alone")] = launch(cs, ro, rd, torch.zeros_like(t1), False,
                                                 True, closest)[0]
    times = {key: [] for key in cases}
    for key in list(cases) + list(reversed(cases)):
        times[key].append(graph_ms(cases[key], REPS))
    result = {}
    for (query, tag, kind), ms in times.items():
        value = float(np.median(ms))
        result.setdefault(query, {}).setdefault(tag, {})[f"{kind}_ms"] = value
        print(f"{query} {tag} {kind}: {value:.4f} ms (median of {len(ms)} graph replays of "
              f"{REPS} calls; bounce-1 {'wavefront' if query == 'closest_hit' else 'shadow rays'}"
              f", terrain100k, watertight; {card})", flush=True)
    walk_spread(cs, b1, s1)
    if args.parity:
        check_parity(parity_sets(dev, cs, scene, camera, b1, s1), args.out)
    print(json.dumps({"package": package, "card": card, "device": torch.cuda.get_device_name(0),
                      "kernels": result}))
    return 0


def binned_operands(kb, cs, ro, rd, t1, w):
    """One binned query's leaf operands at W = w, through the prepass, the
    sort and the blockify step: (rays (N, 8), sortd, pair_ray, blocks,
    words)."""
    from pyrenderer_tpu_torch.accel.clusters import BIN
    from pyrenderer_tpu_torch.kernels import cluster as kc

    rays = kc._prepare(cs, ro, rd, t1, sort=False)[0]
    ids, _, words = kb.prepass(cs, rays, T0, w, emit_words=True)
    sortd, pair_ray = kb.sort_pairs(ids, int((ids != kb.SENTINEL).sum()))
    return rays, sortd, pair_ray, kb.blocks_for(sortd, cs.n_clusters // BIN), words


def run_cap_name(kb):
    """The name of blocks_for's run cap in kernels/binned.py (_THREADS in
    checkouts before the warp-per-pair leaves)."""
    return "RUN_PAIRS" if hasattr(kb, "RUN_PAIRS") else "_THREADS"


def blocks_with_cap(kb, sortd, n_bins, cap):
    """blocks_for with runs of at most `cap` pairs."""
    name = run_cap_name(kb)
    saved = getattr(kb, name)
    setattr(kb, name, cap)
    try:
        return kb.blocks_for(sortd, n_bins)
    finally:
        setattr(kb, name, saved)


def binned_sets(kb, sets, dev):
    """label -> (ClusterScene, [(W, rays, sortd, pair_ray)]) of the binned
    leaves' parity: each ray set of `sets` (parity_sets) at W = 6 and 1, the
    launch edges (edge_streams of the "random" set) and the duplicate
    triangles (duplicate_set)."""
    out = {}
    for label, (cs, ro, rd, t1) in sets.items():
        out[label] = (cs, [(w, *binned_operands(kb, cs, ro, rd, t1, w)[:3]) for w in (6, 1)])
    cs, ro, rd, t1 = sets["random"]
    rays = binned_operands(kb, cs, ro, rd, t1, 6)[0]
    for label, (sortd, pair_ray, r) in edge_streams(kb, cs, rays).items():
        out[f"edge: {label}"] = (cs, [(None, r, sortd, pair_ray)])
    cs_dup, rays, sortd, pair_ray, _, _ = duplicate_set(cs, dev)
    out["duplicate triangles"] = (cs_dup, [(None, rays, sortd, pair_ray)])
    return out


def check_binned_parity(kb, sets, out_dir):
    """Both binned leaves against the resident twin on every set of
    binned_sets, MT and watertight; prints one line per case and saves the
    pairs and every pair's keys to DIR/binned.pt for ``compare``."""
    from pyrenderer_tpu_torch.accel.clusters import BIN

    saved = {}
    for label, (cs, cases) in sets.items():
        for w, rays, sortd, pair_ray in cases:
            blocks = kb.blocks_for(sortd, cs.n_clusters // BIN)
            entry = saved[(label, w)] = {"pairs": (sortd.cpu(), pair_ray.cpu())}
            for wt in (False, True):
                twin = kb.leaf_ref(cs, sortd, pair_ray, rays, T0, wt)
                keys = kb.leaf(cs, sortd, pair_ray, rays, T0, wt)
                keys_s = kb.leaf_streamed(cs, blocks, pair_ray, rays, T0, wt)
                torch.cuda.synchronize()
                print(f"binned parity {label}{'' if w is None else f', W={w}'}, "
                      f"{'watertight' if wt else 'MT'}: {sortd.shape[0]} pairs, "
                      f"{int((twin != kb.MISS_KEY).sum())} hits; keys equal to the twin: "
                      f"leaf {int((keys == twin).sum())}, streamed leaf "
                      f"{int((keys_s == twin).sum())}", flush=True)
                entry[wt] = (twin.cpu(), keys.cpu(), keys_s.cpu())
    os.makedirs(out_dir, exist_ok=True)
    torch.save(saved, os.path.join(out_dir, "binned.pt"))


def prepass_sets(kb, sets, dev):
    """label -> (ClusterScene, rays (N, 8), Ws) of the prepass's and the
    peel's parity: each ray set of `sets` (parity_sets) at W = 6 and 1, the
    bounce-1 wavefront and shadow rays also at 10 (the streamed path's W),
    the launch edges (prepass_edges of the "random" set) and 65,536 random
    rays against terrain330k (more bins than one staging pass holds)."""
    from pyrenderer_tpu_torch.kernels import cluster as kc

    out = {}
    for label, (cs, ro, rd, t1) in sets.items():
        ws = (6, 1, 10) if label in ("bounce1", "shadow1") else (6, 1)
        out[label] = (cs, kc._prepare(cs, ro, rd, t1, sort=False)[0], ws)
    cs, ro, rd, t1 = sets["random"]
    for label, rays in prepass_edges(cs, kc._prepare(cs, ro, rd, t1, sort=False)[0]).items():
        out[f"edge: {label}"] = (cs, rays, (6, 1))
    _, _, cs330 = terrain(406, dev)
    out["terrain330k random"] = (cs330, kc._prepare(cs330, ro, rd, t1, sort=False)[0], (6, 1))
    return out


def check_prepass_parity(kb, sets, out_dir):
    """The prepass (with and without the words) and every peel round after
    it, until no ray has bits left, against their twins on every set of
    prepass_sets; prints one line per case and saves the outputs to
    DIR/prepass.pt for ``compare`` (every round's ids and overflow flags,
    the prepass's words and the last round's)."""
    saved = {}
    for label, (cs, rays, ws) in sets.items():
        for w in ws:
            ids, ovf, words = kb.prepass(cs, rays, T0, w, emit_words=True)
            ids2, ovf2 = kb.prepass(cs, rays, T0, w)
            ref = kb.prepass_ref(cs, rays, T0, w, emit_words=True)
            same = (ids == ref[0]).all(dim=1) & (ovf == ref[1]) & (words == ref[2]).all(dim=1)
            plain = torch.equal(ids2, ids) and torch.equal(ovf2, ovf)
            for span in PREPASS_SPANS if hasattr(kb, "PREPASS_SPAN") else ():
                out = with_span(kb, "PREPASS_SPAN", span,
                                lambda: kb.prepass(cs, rays, T0, w, emit_words=True))()
                plain &= all(torch.equal(x, y) for x, y in zip(out, (ids, ovf, words)))
            entry = saved[(label, w)] = {"prepass": (ids.cpu(), ovf.cpu(), words.cpu()),
                                         "rounds": []}
            rounds_same, rounds = True, 0
            while bool(ovf.any()) and rounds < 64:
                out = kb.peel(words, w)
                rounds_same &= all(torch.equal(x, y) for x, y in zip(out, kb.peel_ref(words, w)))
                for span in PEEL_SPANS if hasattr(kb, "PEEL_SPAN") else ():
                    other = with_span(kb, "PEEL_SPAN", span, lambda: kb.peel(words, w))()
                    rounds_same &= all(torch.equal(x, y) for x, y in zip(out, other))
                ids_p, ovf, words = out
                entry["rounds"].append((ids_p.cpu(), ovf.cpu()))
                rounds += 1
            entry["last words"] = words.cpu()
            print(f"prepass parity {label}, W={w}: n={rays.shape[0]}, live "
                  f"{int((rays[:, 6] >= T0).sum())}, pairs {int((ids != kb.SENTINEL).sum())}, "
                  f"overflow {int(ovf2.sum())}; rays equal to the twin {int(same.sum())}; "
                  f"without words and at every span {'the same' if plain else 'DIFFERENT'}; "
                  f"{rounds} peel "
                  f"rounds {'equal' if rounds_same else 'DIFFERENT'} to the twin", flush=True)
    os.makedirs(out_dir, exist_ok=True)
    torch.save(saved, os.path.join(out_dir, "prepass.pt"))


def compare_prepass(a, b):
    """Per prepass case, the rays on which two runs' prepass or peel rounds
    differ; returns True when none does."""
    same = True
    for key in a:
        tag = f"{key[0]}, W={key[1]}"
        if key not in b or len(a[key]["rounds"]) != len(b[key]["rounds"]):
            print(f"compare prepass {tag}: the two runs made different numbers of peel rounds")
            same = False
            continue
        rows = [("prepass", a[key]["prepass"], b[key]["prepass"]),
                ("last words", (a[key]["last words"],), (b[key]["last words"],))]
        rows += [(f"peel round {k + 1}", x, y)
                 for k, (x, y) in enumerate(zip(a[key]["rounds"], b[key]["rounds"]))]
        differ = {}
        for name, xs, ys in rows:
            n = sum(int((x != y).reshape(x.shape[0], -1).any(dim=1).sum()) for x, y in zip(xs, ys))
            if n:
                differ[name] = n
        print(f"compare prepass {tag}: rays that differ {differ or 0} "
              f"({len(a[key]['rounds'])} peel rounds)")
        same &= not differ
    return same


def compare_binned(a, b):
    """Per binned case, the pairs on which two runs' leaves differ; returns
    True when no key differs."""
    same = True
    for key in a:
        label, w = key
        tag = f"{label}{'' if w is None else f', W={w}'}"
        if key not in b or not all(torch.equal(x, y) for x, y in
                                   zip(a[key]["pairs"], b[key]["pairs"])):
            print(f"compare binned {tag}: the two runs made different pairs")
            same = False
            continue
        for wt in (False, True):
            twin, *runs_a = a[key][wt]
            _, *runs_b = b[key][wt]
            for name, ka, kb_ in zip(("leaf", "streamed leaf"), runs_a, runs_b):
                diff = ka != kb_
                print(f"compare binned {tag}, {'watertight' if wt else 'MT'}, {name}: keys "
                      f"differ on {int(diff.sum())} of {ka.shape[0]} pairs (the twin agrees "
                      f"with A on {int((ka == twin)[diff].sum())}, with B on "
                      f"{int((kb_ == twin)[diff].sum())})")
                same &= not bool(diff.any())
    return same


def prepass_bound(cs, rays, w, emit_words):
    """(bound ms, "operations" or "bytes") of one prepass call, as
    chip_smoke.py counts it: SLAB_OPS per (live ray, real bin) over the fp32
    peak, and the rays, the compact box table and the outputs over the
    memory rate."""
    from pyrenderer_tpu_torch.accel.clusters import BIN

    n, n_live = rays.shape[0], int((rays[:, 6] >= T0).sum())
    n_bins = cs.n_clusters // BIN
    n_words = -(-n_bins // 32)
    nbytes = 4 * (rays.numel() + 8 * 32 * n_words + n * w + (n * n_words if emit_words else 0))
    nbytes += n
    return max((n_live * n_bins * SLAB_OPS / PEAK_FP32 * 1e3, "operations"),
               (nbytes / PEAK_BYTES * 1e3, "bytes"))


def peel_bound(words, w):
    """(bound ms, "bytes"): the words read and written, the ids and the
    overflow flags written, over the memory rate."""
    n = words.shape[0]
    return (4 * (2 * words.numel() + n * w) + n) / PEAK_BYTES * 1e3, "bytes"


def prepass_note(kb, cs, rays, w):
    """The live rays, pairs, overflow rays and peel rounds of one streamed
    query's candidate stages at W = w and at W = 10."""
    notes = []
    for ww in (w, 10):
        ids, ovf, words = kb.prepass(cs, rays, T0, ww, emit_words=True)
        rounds, busy = 0, []
        while bool(ovf.any()):
            busy.append(int((words != 0).any(dim=1).sum()))
            ids, ovf, words = kb.peel(words, ww)
            rounds += 1
        notes.append(f"W={ww}: peel rounds {rounds}, rays with bits left before each "
                     f"{busy}")
    return f"{int((rays[:, 6] >= T0).sum())} live rays; " + "; ".join(notes)


def with_span(kb, name, span, fn):
    """fn() with kernels/binned.py's `name` (PREPASS_SPAN or PEEL_SPAN) set
    to `span` for the call."""
    def call():
        saved = getattr(kb, name)
        setattr(kb, name, span)
        try:
            return fn()
        finally:
            setattr(kb, name, saved)
    return call


def prepass_cases(kb, cs, rays, query):
    """(query, name) -> fn of the prepass and the peel as the binned paths
    call them: the prepass at W = 6 with and without the words, at W = 10
    with them (the streamed path's call) and, where the checkout has
    PREPASS_SPAN, at every span of PREPASS_SPANS; the peel at W = 6 on the
    W = 6 prepass's words and at W = 10 on the streamed path's round-2 and
    round-3 words. Prints each case's bound."""
    cases = {}
    dead = rays.clone()
    dead[:, 6] = 0.0
    for w, emit, r in ((6, False, rays), (6, True, rays), (10, True, rays), (6, False, dead)):
        name = f"prepass W={w}{' words' if emit else ''}{', every ray dead' if r is dead else ''}"
        cases[(query, name)] = lambda w=w, emit=emit, r=r: kb.prepass(cs, r, T0, w, emit)
        same = all(torch.equal(x, y) for x, y in zip(kb.prepass(cs, r, T0, w, emit),
                                                     kb.prepass_ref(cs, r, T0, w, emit)))
        print(f"  bound {name}: {prepass_bound(cs, r, w, emit)}; equal to the twin: {same}",
              flush=True)
    if hasattr(kb, "PREPASS_SPAN"):
        for span in PREPASS_SPANS:
            cases[(query, f"prepass W=6, span {span}")] = with_span(
                kb, "PREPASS_SPAN", span, lambda: kb.prepass(cs, rays, T0, 6))
    words6 = kb.prepass(cs, rays, T0, 6, emit_words=True)[2]
    words10 = kb.prepass(cs, rays, T0, 10, emit_words=True)[2]
    words10_3 = kb.peel(words10, 10)[2]
    for name, words, w in (("peel W=6", words6, 6), ("peel W=10 round 2", words10, 10),
                           ("peel W=10 round 3", words10_3, 10),
                           ("peel W=6, no bit left", torch.zeros_like(words6), 6)):
        cases[(query, name)] = lambda words=words, w=w: kb.peel(words, w)
        same = all(torch.equal(x, y) for x, y in zip(kb.peel(words, w), kb.peel_ref(words, w)))
        if hasattr(kb, "PEEL_SPAN") and name in ("peel W=6", "peel W=10 round 2"):
            for span in PEEL_SPANS:
                cases[(query, f"{name}, span {span}")] = with_span(
                    kb, "PEEL_SPAN", span, lambda words=words, w=w: kb.peel(words, w))
        print(f"  bound {name}: {peel_bound(words, w)} "
              f"({int((words != 0).any(dim=1).sum())} rays with bits); equal to the twin: "
              f"{same}", flush=True)
    return cases


def cmd_binned(args) -> int:
    """``kernels binned``: the four binned kernels alone and the binned
    wrappers with their glue, on the bounce-1 wavefront and its shadow
    rays; with --parity, prepass_sets and binned_sets against the twins."""
    import pyrenderer_tpu_torch
    from pyrenderer_tpu_torch.accel.clusters import BIN
    from pyrenderer_tpu_torch.kernels import binned as kb
    from pyrenderer_tpu_torch.kernels import build
    from pyrenderer_tpu_torch.perf.kernelbench import cuda_ms, graph_ms

    dev = torch.device("cuda:0")
    card = card_line()
    package = os.path.dirname(os.path.abspath(pyrenderer_tpu_torch.__file__))
    print(f"package {package}; {card}; streamed leaf runs of "
          f"{getattr(kb, run_cap_name(kb))} pairs", flush=True)
    t = time.perf_counter()
    build.library()
    print(f"kernels built or loaded in {time.perf_counter() - t:.2f} s", flush=True)
    for line in ptxas_report(build.build_log(), "binned"):
        print(line)
    scene, camera, cs = terrain(224, dev)
    b1, s1 = bounce1(scene, camera, cs, dev)
    n_bins = cs.n_clusters // BIN
    w = 6
    cases = {}
    for query, (ro, rd, t1) in (("wavefront", b1), ("shadow rays", s1)):
        rays, sortd, pair_ray, blocks, _ = binned_operands(kb, cs, ro, rd, t1, w)
        print(f"bounce-1 {query}: {int((t1 > T0).sum())} live rays, {sortd.shape[0]} pairs at "
              f"W={w}, {int((blocks[:, 0] >= 0).sum())} streamed blocks", flush=True)
        print(f"bounce-1 {query}, prepass and peel: {prepass_note(kb, cs, rays, w)}",
              flush=True)
        cases.update(prepass_cases(kb, cs, rays, query))
        for wt in (False, True):
            tag = "watertight" if wt else "MT"
            cases[(query, f"leaf {tag}")] = (
                lambda rays=rays, s=sortd, p=pair_ray, wt=wt: kb.leaf(cs, s, p, rays, T0, wt))
            cases[(query, f"leaf_streamed {tag}")] = (
                lambda rays=rays, b=blocks, p=pair_ray, wt=wt:
                kb.leaf_streamed(cs, b, p, rays, T0, wt))
        # the streamed leaf with other runs per block than blocks_for's cap
        for cap in RUN_CAPS:
            if cap != getattr(kb, run_cap_name(kb)):
                b = blocks_with_cap(kb, sortd, n_bins, cap)
                cases[(query, f"leaf_streamed watertight, runs of {cap}")] = (
                    lambda rays=rays, b=b, p=pair_ray: kb.leaf_streamed(cs, b, p, rays, T0, True))
    times = {key: [] for key in cases}
    for key in list(cases) + list(reversed(cases)):
        times[key].append(graph_ms(cases[key], REPS))
    result = {}
    for (query, name), ms in times.items():
        value = float(np.median(ms))
        result.setdefault(query, {})[f"{name} ms"] = value
        print(f"{name} alone: {value:.4f} ms (median of {len(ms)} graph replays of {REPS} "
              f"calls; bounce-1 {query}, terrain100k; {card})", flush=True)
    wrappers = {}
    for streamed in (False, True):
        variant = "streamed" if streamed else "binned"
        wrappers[f"closest_hit {variant}"] = lambda s=streamed: kb.closest_hit(
            cs, *b1[:2], T0, b1[2], watertight=True, streamed=s, exact_t=False)
        wrappers[f"occluded {variant}"] = lambda s=streamed: kb.occluded(
            cs, *s1[:2], T0, s1[2], watertight=True, streamed=s)
    glue = {key: [] for key in wrappers}
    for key in list(wrappers) + list(reversed(wrappers)):
        glue[key].append(cuda_ms(wrappers[key]))
    for key, ms in glue.items():
        value = float(np.median(ms))
        result.setdefault("wrappers", {})[f"{key} ms"] = value
        print(f"wrapper {key} (glue included, W at its default): {value:.4f} ms (median of "
              f"{len(ms)} means of eager calls; watertight, terrain100k; {card})", flush=True)
    if args.parity:
        sets = parity_sets(dev, cs, scene, camera, b1, s1)
        check_prepass_parity(kb, prepass_sets(kb, sets, dev), args.out)
        check_binned_parity(kb, binned_sets(kb, sets, dev), args.out)
    print(json.dumps({"package": package, "card": card, "device": torch.cuda.get_device_name(0),
                      "binned": result}))
    return 0


# fp32 operations of a Moeller-Trumbore test (the whole-table kernels' and
# the leaf probe's bound) and of a cond or ctz probe's product
MT_OPS = 60
COND_OPS = 6
# lanes per ray the whole-table kernels can take (pr_whole_table_g)
WHOLE_LANES = (1, 2, 4, 8, 16)
# the sets timed by `kernels whole`: chip_smoke.py phase 2's Cornell sets
# and both scenes' bounce-1 wavefront and shadow rays
WHOLE_TIMED = ("cornell random", "cornell dead lanes", "cornell camera",
               "cornell per-ray t1", "cornell ragged", "cornell ragged per-ray t1",
               "cornell bounce1", "cornell shadow1", "spheres bounce1", "spheres shadow1")


def whole_scenes(dev):
    """name -> (scene, camera, (9, T) table) of bench.py's "cornell" (36
    triangles) and "spheres" (3,852) rows at their resolution, 1024x1024."""
    from pyrenderer_tpu_torch.bench import load_bench_scene
    from pyrenderer_tpu_torch.kernels import intersect as ki
    from pyrenderer_tpu_torch.scene import to_device

    out = {}
    for name in ("cornell", "spheres"):
        host, cam, res, _, _ = load_bench_scene(name)
        scene, camera = to_device(host, cam._replace(resolution=(res, res)), dev)
        out[name] = (scene, camera, ki.pack_triangles(scene.vertices, scene.faces))
    return out


def whole_wavefronts(scene, camera, dev):
    """The bounce-1 wavefront and its shadow rays ((ro, rd, t1) each) of the
    pbrt frame through the whole-table wrappers: the first 2^16 Morton
    pixels of 1024x1024, 1 spp, seed 0, as chip_smoke.py phase 14 takes
    them."""
    from pyrenderer_tpu_torch.config import RenderConfig
    from pyrenderer_tpu_torch.core.integrator import TraceTables

    cfg = RenderConfig(max_bounces=4, spp=1, seed=0, estimator="pbrt")
    return wavefronts(scene, camera, TraceTables(scene, cfg, "cuda"), cfg,
                      *morton_chunk(1024, dev), module="kernels")


def whole_sets(dev, scenes, waves=None):
    """label -> ((9, T) table, ro, rd, t1): chip_smoke.py phase 2's Cornell
    sets, both scenes' bounce-1 wavefront (bounce1) and shadow rays
    (shadow1; without `waves`, none), 65,536 random rays against the
    spheres table, the
    duplicates of whole_table_duplicates, and each table's launch edges:
    N = 1, 31, 33 and 129, all rays dead, every third ray dead, and t1 on
    the accept test's edges (t1 = 0, below t0, NaN, negative, inf)."""
    from pyrenderer_tpu_torch.core.camera import generate_rays

    cornell, spheres = scenes["cornell"][2], scenes["spheres"][2]
    ro, rd = random_rays(N_RAYS, 0, dev)
    lanes = torch.arange(N_RAYS, device=dev)
    dead = torch.where(lanes % 3 == 0, 0.0, T_MAX).float()
    half = torch.full((N_RAYS,), 0.5, device=dev)
    cro, crd = generate_rays(scenes["cornell"][1], *morton_chunk(1024, dev), 0, 0)
    rro, rrd = random_rays(100, 4, dev)
    edge_t1 = torch.tensor([T_MAX, 0.0, T0 / 10, float("nan"), -1.0, float("inf")],
                           device=dev).repeat(683)[:4096].contiguous()
    dup, dro, drd = whole_table_duplicates(spheres.cpu().numpy())
    sets = {
        "cornell random": (cornell, ro, rd, T_MAX),
        "cornell dead lanes": (cornell, ro, rd, dead),
        "cornell camera": (cornell, cro.contiguous(), crd.contiguous(), T_MAX),
        "cornell per-ray t1": (cornell, ro, rd, half),
        "cornell ragged": (cornell, rro, rrd, T_MAX),
        "cornell ragged per-ray t1": (cornell, rro, rrd, half[:100].contiguous()),
        "spheres random": (spheres, ro, rd, T_MAX),
        "duplicates": (torch.as_tensor(dup, device=dev), torch.as_tensor(dro, device=dev),
                       torch.as_tensor(drd, device=dev), T_MAX),
    }
    for name, table in (("cornell", cornell), ("spheres", spheres)):
        if waves is not None:
            sets[f"{name} bounce1"] = (table, *waves[name][0])
            sets[f"{name} shadow1"] = (table, *waves[name][1])
        for n in (1, 31, 33, 129):
            sets[f"{name} N={n}"] = (table, ro[:n], rd[:n], T_MAX)
        sets[f"{name} all dead"] = (table, ro[:4096], rd[:4096], torch.zeros(4096, device=dev))
        sets[f"{name} every third dead"] = (table, ro[:4096], rd[:4096],
                                            dead[:4096].contiguous())
        sets[f"{name} t1 edges"] = (table, ro[:4096], rd[:4096], edge_t1)
    return sets


def whole_bounds(table, ro, rd, t1):
    """{"closest_hit": (ms, by), "occluded": (ms, by)}: the closest hit
    tests every triangle for every live ray (t1 > T0), the any hit up to a
    ray's first accepted triangle in table order; bytes: rays, table and t1
    read once, the outputs written once."""
    from pyrenderer_tpu_torch.core.intersect import _accept, _mt_terms
    from pyrenderer_tpu_torch.kernels import intersect as ki

    n, n_tris = ro.shape[0], table.shape[1]
    t1v = torch.as_tensor(t1, dtype=torch.float32, device=ro.device).expand(n)
    live = t1v > T0
    ok = _accept(*_mt_terms(*ki._table_arrays(table, ro.dtype), ro, rd), T0, t1v)
    first = torch.where(ok.any(dim=1), ok.int().argmax(dim=1) + 1, n_tris)
    ins = 4 * (ro.numel() + rd.numel() + table.numel()) + (4 * n if torch.is_tensor(t1) else 0)
    out = {}
    for name, tests, out_bytes in (("closest_hit", int(live.sum()) * n_tris, 9 * n),
                                   ("occluded", int(first[live].sum()), n)):
        t_ops = tests * MT_OPS / PEAK_FP32 * 1e3
        t_bytes = (ins + out_bytes) / PEAK_BYTES * 1e3
        out[name] = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    return out


def whole_ptxas(log: str):
    """The ptxas lines of csrc/intersect.cu's closest_kernel and
    anyhit_kernel in `log`, each with its lanes per ray (the template
    argument G, where the checkout has one)."""
    return ptxas_lines(log, r"(?<=\d)(closest|anyhit)_kernel(ILi(\d+)E)?",
                       lambda m: m.group(1) + "_kernel" + (f" G={m.group(3)}" if m.group(3)
                                                            else ""))


def whole_run(table, ro, rd, t1, g=None):
    """Both whole-table kernels on one set, through the wrappers (g None)
    or at g lanes per ray (pr_whole_table_g, uncounted): (hit, t, tri,
    occluded)."""
    from pyrenderer_tpu_torch.kernels import build
    from pyrenderer_tpu_torch.kernels import intersect as ki

    if g is None:
        hit, t, tri = ki.closest_hit(table, ro, rd, T0, t1)
        return hit, t, tri, ki.occluded(table, ro, rd, T0, t1)
    n = ro.shape[0]
    t1v, t1s = ki._check_cuda_args(table, ro, rd, t1)
    outs = (torch.empty(n, device=ro.device), torch.empty(n, dtype=torch.int32, device=ro.device),
            torch.empty(n, dtype=torch.bool, device=ro.device),
            torch.empty(n, dtype=torch.bool, device=ro.device))
    for closest, (t, tri, hit) in ((1, outs[:3]), (0, (None, None, outs[3]))):
        build.launch("pr_whole_table_g", ro.device, closest, g, table.data_ptr(),
                     table.shape[1], ro.data_ptr(), rd.data_ptr(),
                     None if t1v is None else t1v.data_ptr(), t1s, float(T0), n,
                     None if t is None else t.data_ptr(), None if tri is None else tri.data_ptr(),
                     hit.data_ptr())
    return outs[2], outs[0], outs[1], outs[3]


def whole_parity(sets, lanes, out_dir):
    """Both kernels against the twins on every set, bit for bit (hit, t's
    bits, face, occlusion), through the wrappers and at each of `lanes`;
    prints one line per case and saves rays and results to
    DIR/whole.pt. Returns the number of cases that differ."""
    from pyrenderer_tpu_torch.kernels import intersect as ki

    saved, bad = {}, 0
    for label, (table, ro, rd, t1) in sets.items():
        n = ro.shape[0]
        t1v = torch.as_tensor(t1, dtype=torch.float32, device=ro.device).expand(n)
        hit_r, t_r, tri_r = ki.closest_hit_ref(table, ro, rd, T0, t1)
        occ_r = ki.occluded_ref(table, ro, rd, T0, t1)
        saved[label] = {"rays": (table.cpu(), ro.cpu(), rd.cpu(), t1v.contiguous().cpu())}
        for g in (None, *lanes):
            hit, t, tri, occ = whole_run(table, ro, rd, t1, g)
            torch.cuda.synchronize()
            differ = ((hit != hit_r) | (t.view(torch.int32) != t_r.view(torch.int32))
                      | (tri != tri_r) | (occ != occ_r))
            bad += int(bool(differ.any()))
            print(f"whole parity {label}, {'wrappers' if g is None else f'G={g}'}: n={n} "
                  f"hits={int(hit_r.sum())} occluded={int(occ_r.sum())}; (hit, t bits, face, "
                  f"occluded) differ from the twins on {int(differ.sum())} rays", flush=True)
            if g is None:
                saved[label]["kernels"] = (hit.cpu(), t.cpu(), tri.cpu(), occ.cpu())
    os.makedirs(out_dir, exist_ok=True)
    torch.save(saved, os.path.join(out_dir, "whole.pt"))
    return bad


def compare_whole(a, b):
    """Per whole-table set, the rays on which two runs' kernels differ (hit,
    t's bits, face or occlusion); returns True when none differs."""
    same = True
    for label in a:
        if label not in b or not all(torch.equal(x, y) or (x.is_floating_point() and torch.equal(
                x.view(torch.int32), y.view(torch.int32)))
                for x, y in zip(a[label]["rays"], b[label]["rays"])):
            print(f"compare whole {label}: the two runs traced different rays")
            same = False
            continue
        (ha, ta, fa, oa), (hb, tb, fb, ob) = a[label]["kernels"], b[label]["kernels"]
        diff = (ha != hb) | (ta.view(torch.int32) != tb.view(torch.int32)) | (fa != fb) | (oa != ob)
        print(f"compare whole {label}: (hit, t bits, face, occluded) differ on "
              f"{int(diff.sum())} of {ha.shape[0]} rays")
        same &= not bool(diff.any())
    return same


def cmd_whole(args) -> int:
    """``kernels whole``: both whole-table kernels alone (one launch of the
    C entry point on outputs allocated beforehand), with their wrappers, and
    at each of WHOLE_LANES where the checkout has pr_whole_table_g, on
    WHOLE_TIMED; with --parity, whole_sets against the twins."""
    import pyrenderer_tpu_torch
    from pyrenderer_tpu_torch.kernels import build
    from pyrenderer_tpu_torch.kernels import intersect as ki
    from pyrenderer_tpu_torch.perf.kernelbench import graph_ms

    dev = torch.device("cuda:0")
    card = card_line()
    package = os.path.dirname(os.path.abspath(pyrenderer_tpu_torch.__file__))
    print(f"package {package}; {card}", flush=True)
    t = time.perf_counter()
    lib = build.library()
    print(f"kernels built or loaded in {time.perf_counter() - t:.2f} s", flush=True)
    for line in whole_ptxas(build.build_log()):
        print(line)
    lanes = WHOLE_LANES if hasattr(lib, "pr_whole_table_g") else ()
    scenes = whole_scenes(dev)
    waves = {name: whole_wavefronts(scene, camera, dev)
             for name, (scene, camera, _) in scenes.items()}
    sets = whole_sets(dev, scenes, waves)
    if lanes:
        print("lanes per ray of the entry points: " + ", ".join(
            f"{name} T={t} G={lib.pr_whole_table_lanes(closest, t)}"
            for t in (scenes[s][2].shape[1] for s in scenes)
            for closest, name in ((1, "closest_hit"), (0, "occluded"))), flush=True)

    cases, bounds = {}, {}
    for label in WHOLE_TIMED:
        table, ro, rd, t1 = sets[label]
        n = ro.shape[0]
        t1v, t1s = ki._check_cuda_args(table, ro, rd, t1)
        t1p = None if t1v is None else t1v.data_ptr()
        t_out = torch.empty(n, device=dev)
        tri_out = torch.empty(n, dtype=torch.int32, device=dev)
        hit_out = torch.empty(n, dtype=torch.bool, device=dev)
        head = (table.data_ptr(), table.shape[1], ro.data_ptr(), rd.data_ptr(), t1p, t1s,
                float(T0), n)
        bounds[label] = whole_bounds(table, ro, rd, t1)
        print(f"{label}: {n} rays, {int((torch.as_tensor(t1, device=dev).expand(n) > T0).sum())}"
              f" live, T={table.shape[1]}; bounds " + ", ".join(
                  f"{k} {v[0]:.6f} ms ({v[1]})" for k, v in bounds[label].items()), flush=True)
        cases[(label, "closest_hit", "alone")] = lambda h=head, o=(t_out, tri_out, hit_out): \
            build.launch("pr_closest_hit", dev, *h, *(x.data_ptr() for x in o))
        cases[(label, "occluded", "alone")] = lambda h=head, o=hit_out: \
            build.launch("pr_occluded", dev, *h, o.data_ptr())
        cases[(label, "closest_hit", "wrapper")] = lambda s=sets[label]: \
            ki.closest_hit(s[0], s[1], s[2], T0, s[3])
        cases[(label, "occluded", "wrapper")] = lambda s=sets[label]: \
            ki.occluded(s[0], s[1], s[2], T0, s[3])
        for g in lanes:
            for closest, name in ((1, "closest_hit"), (0, "occluded")):
                cases[(label, name, f"G={g}")] = (
                    lambda h=head, c=closest, g=g, o=(t_out, tri_out, hit_out): build.launch(
                        "pr_whole_table_g", dev, c, g, *h, *(x.data_ptr() for x in o)))
    times = {key: [] for key in cases}
    for key in list(cases) + list(reversed(cases)):
        times[key].append(graph_ms(cases[key], REPS))
    result = {}
    for (label, name, kind), ms in times.items():
        value = float(np.median(ms))
        entry = result.setdefault(label, {}).setdefault(name, {})
        entry[f"{kind} ms"] = value
        entry["bound_ms"], entry["bound_by"] = bounds[label][name]
        print(f"{label} {name} {kind}: {value:.4f} ms (median of {len(ms)} graph replays of "
              f"{REPS} calls; bound {bounds[label][name][0]:.6f} ms; {card})", flush=True)
    bad = None
    if args.parity:
        bad = whole_parity(sets, lanes, args.out)
        print(f"whole parity: {bad} cases differ from the twins", flush=True)
    print(json.dumps({"package": package, "card": card, "device": torch.cuda.get_device_name(0),
                      "whole": result, "parity_cases_differing": bad}))
    return 0


# ---------------------------------------------------------------------------
# the probe kernels (csrc/kernelbench.cu, perf/kernelbench.py): B9-B12
# ---------------------------------------------------------------------------

# the probes' edges, each made from inputs(n_tiles) (probe_edges):
#   ties                 columns that repeat another exactly, in every row
#                        block (PROBE_TIES, dst <- src), half the rays aimed
#                        at a repeated triangle: ties in t
#   degenerate           e1 = 0 in PROBE_DEGENERATE (det == 0), half the
#                        rays aimed at them
#   zero direction       d = 0 on every other ray: every test misses
#   origin on a vertex   each ray's origin on v0 of a triangle: the leaf's
#                        t is 0, the cond's product exactly 0 (on the even
#                        rays, at PROBE_VERTEX, the least product)
PROBE_EDGES = ("ties", "degenerate", "zero direction", "origin on a vertex")
# pairs a lane split separates (lanes 0/1, lanes 31/32 of a warp, the last
# column) or keeps on one lane (5/13 and 2/18 at 8 lanes a ray), either order
PROBE_TIES = ((0, 1), (5, 13), (2, 18), (0, 32), (31, 63), (100, 127), (70, 6))
PROBE_DEGENERATE = (0, 7, 8, 63, 127)
PROBE_VERTEX = 45
# the ray counts the kernels are checked at besides the harness's 256 tiles
# (N = 128, 384 and 38,400)
PROBE_TILES = (1, 3, 300)
# the loop counts of the edge checks: none, one, and one either side of 8
PROBE_COUNTS = (0, 1, 7, 9)
# the ctz words of the parity checks besides the harness's: none, bit 31
# alone and with bit 0 (the kernel's __ffs takes an int)
PROBE_WORDS = (0, 0x1, 0xF0F0, 0x80000000, 0x80000001, -1)


def _aim_probe(r, t, rays, cols):
    """Point rays[i]'s direction at the centroid of triangle cols[i % len]
    of row block i % 8 (float32 throughout)."""
    for i in rays:
        b = (i % 8) * 16
        c = cols[i % len(cols)]
        v0, e1, e2 = t[b:b + 3, c], t[b + 3:b + 6, c], t[b + 6:b + 9, c]
        r[i, 3:6] = v0 + (e1 + e2) / np.float32(3) - r[i, 0:3]


def probe_edges(n_tiles: int = 2, device="cpu"):
    """label -> (rcol, tri) for each of PROBE_EDGES: the harness's operands
    (perf/kernelbench.py inputs(n_tiles)) changed at the probes' edges."""
    from pyrenderer_tpu_torch.perf.kernelbench import inputs

    rcol, tri = inputs(n_tiles)
    base_r, base_t = rcol.numpy(), tri.numpy()
    n = base_r.shape[0]
    out = {}
    for label in PROBE_EDGES:
        r, t = base_r.copy(), base_t.copy()
        if label == "ties":
            for src, dst in PROBE_TIES:
                t[:, dst] = t[:, src]
            _aim_probe(r, t, range(0, n, 2), [dst for _, dst in PROBE_TIES])
        elif label == "degenerate":
            for b in range(8):
                t[b * 16 + 3:b * 16 + 6, list(PROBE_DEGENERATE)] = 0.0
            _aim_probe(r, t, range(0, n, 2), PROBE_DEGENERATE)
        elif label == "zero direction":
            r[::2, 3:6] = 0.0
        else:
            # column PROBE_VERTEX's v0 in every row block: the least
            # coordinates of any v0, so that from there no product is
            # negative and the even rays' minimum is the 0 of that vertex
            corner = np.stack([t[c::16].min() for c in range(3)])
            t[0:3 + 7 * 16:16, PROBE_VERTEX] = corner[0]
            t[1:3 + 7 * 16:16, PROBE_VERTEX] = corner[1]
            t[2:3 + 7 * 16:16, PROBE_VERTEX] = corner[2]
            for i in range(n):
                b, c = (i % 8) * 16, (37 * i) % 128
                r[i, 0:3] = corner if i % 2 == 0 else t[b:b + 3, c]
        out[label] = (torch.as_tensor(r, device=device), torch.as_tensor(t, device=device))
    return out


# fp32 multiplies of one test in the SASS of each probe's loop: the leaf's
# Moeller-Trumbore (c 6, det 3, q 6, three dots 9, t u v 3), the cond's
# and the ctz's product (2), the extract's round (max * 1e-20: its "test"
# is a round); tests in a loop = its FMULs over these
PROBE_FMULS = {"kb_leaf_kernel": 27, "kb_extract_kernel": 1, "kb_cond_kernel": 2,
               "kb_ctz_kernel": 2}


def offset_rows(rcol):
    """rcol's values in a contiguous view that starts 4 bytes past a
    16-byte boundary (the wrappers take any contiguous rcol)."""
    buf = torch.empty(rcol.numel() + 4, dtype=rcol.dtype, device=rcol.device)
    start = (16 - buf.data_ptr() % 16) % 16 // 4 + 1
    view = buf[start:start + rcol.numel()].view(rcol.shape)
    view.copy_(rcol)
    return view


def probe_sets(dev):
    """label -> (rcol, tri): the harness's operands at 256 tiles and at
    PROBE_TILES, the same at 2 tiles in offset_rows, and the edge sets of
    probe_edges (2 tiles)."""
    from pyrenderer_tpu_torch.perf import kernelbench as kb

    sets = {f"{n * kb.RAY_TILE} rays": kb.inputs(n, dev) for n in (kb.N_TILES,) + PROBE_TILES}
    rcol, tri = kb.inputs(2, dev)
    sets["256 rays, offset rows"] = (offset_rows(rcol), tri)
    sets.update(probe_edges(2, dev))
    return sets


def probe_params(label):
    """(probe, parameter) pairs run on a set: the harness's lists, and on
    the edge sets PROBE_COUNTS for the leaf and the cond (taken or not).
    On every parity set (any label but "harness", the timing list) the
    extract also runs at PROBE_COUNTS and the ctz at PROBE_WORDS."""
    from pyrenderer_tpu_torch.perf import kernelbench as kb

    edge = label in PROBE_EDGES
    leaves = PROBE_COUNTS if edge else kb.LEAF_L
    conds = PROBE_COUNTS if edge else kb.COND_N
    exts, words = list(kb.EXTRACT_K), [w for w, _ in kb.CTZ_WORDS]
    if label != "harness":
        exts += [x for x in PROBE_COUNTS if x not in exts]
        words += [w for w in PROBE_WORDS if w not in words]
    return ([("leaf", x) for x in leaves] + [("extract", x) for x in exts]
            + [("cond", (x, t)) for x in conds for t in (False, True)]
            + [("ctz", w) for w in words])


def probe_call(kb, rcol, tri, probe, param):
    """A callable running one probe through its wrapper; it returns the
    wrapper's (N, 1) output."""
    return {"leaf": lambda: kb.leaf(rcol, tri, param),
            "extract": lambda: kb.extract(rcol, param),
            "cond": lambda: kb.cond(rcol, tri, *param),
            "ctz": lambda: kb.ctz(rcol, tri, param)}[probe]


def probe_tests(probe, param, n):
    """The tests one probe call on n rays runs: ray-triangle tests (leaf),
    products (cond taken, ctz per set bit), values a round (extract)."""
    from pyrenderer_tpu_torch.perf import kernelbench as kb

    per_ray = {"leaf": lambda: param * 128, "extract": lambda: 8 * param,
               "cond": lambda: param[0] * 128 if param[1] else 0,
               "ctz": lambda: len(kb.set_bits(param)) * 128}[probe]()
    return n * per_ray


def probe_bound(probe, param, n):
    """(ms, by) of one probe call on n rays: its tests' fp32 operations
    over 67 TFLOP/s (MT_OPS a leaf test, COND_OPS a cond or ctz product, 2
    an extract value and round) or the rays, table and output over 3.35
    TB/s, whichever is longer."""
    ops = probe_tests(probe, param, n) * {"leaf": MT_OPS, "extract": 2}.get(probe, COND_OPS)
    io = 4 * (8 * n + n + (0 if probe == "extract" else 128 * 128))
    t_ops, t_bytes = ops / PEAK_FP32 * 1e3, io / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def probe_ptxas(log: str):
    """The ptxas lines of csrc/kernelbench.cu's kernels in `log`."""
    return ptxas_lines(log, r"kb_[a-z_]+?_kernel", lambda m: m.group(0))


def _op(text):
    """The opcode of a SASS instruction, its predicate dropped."""
    return re.sub(r"^@!?U?P\w+\s+", "", text).split()[0]


def _branch_target(text, labels, fname):
    """The address a BRA instruction jumps to (a label or an address), or
    None for another instruction."""
    if not _op(text).startswith("BRA"):
        return None
    m = re.search(r"(\.L_x_\d+)", text)
    if m:
        return labels.get((fname, m.group(1)))
    m = re.findall(r"\b0x[0-9a-f]+\b", text)
    return int(m[-1], 16) if m else None


def _sass_functions(text):
    """{mangled name: [(address, instruction, branch target or None)]} of a
    cuobjdump -sass dump; a label (.L_x_N) stands for the address of the
    instruction after it."""
    funcs, name, labels, pending = {}, None, {}, []
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        if name is None:
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:
            addr = int(m.group(1), 16)
            for label in pending:
                labels[(name, label)] = addr
            pending = []
            funcs[name].append((addr, m.group(2)))
    return {fname: [(addr, text, _branch_target(text, labels, fname)) for addr, text in ins]
            for fname, ins in funcs.items()}


def sass_loops(text):
    """For each probe kernel of a cuobjdump -sass dump (by name), its
    innermost loop that holds a test (the shortest range of a backward
    branch with at least PROBE_FMULS FMULs), or None where none is found:
    {"instructions", "tests" (its FMULs over PROBE_FMULS), "slow" (instructions in ranges
    that a forward branch skips and that hold a CALL: the IEEE
    reciprocal's slow path), "per_test", "per_test_fast" (without them),
    "ops" (opcode counts), "body" (the loop's instructions, in order)}."""
    out = {}
    for fname, ins in _sass_functions(text).items():
        m = re.search(r"kb_[a-z_]+?_kernel", fname)
        if not m or m.group(0) not in PROBE_FMULS:
            continue
        tag = m.group(0)
        per = PROBE_FMULS[tag]
        index = {addr: k for k, (addr, _, _) in enumerate(ins)}
        best = None
        for k, (addr, _, target) in enumerate(ins):
            if target is None or target > addr or target not in index:
                continue
            body = ins[index[target]:k + 1]
            if (sum(_op(x) == "FMUL" for _, x, _ in body) >= per
                    and (best is None or len(body) < len(best))):
                best = body
        if best is None:
            out[tag] = None
            continue
        # the slow path: every range a forward branch skips that holds a
        # CALL (nvcc's IEEE reciprocal falls back to a subroutine there)
        skipped = set()
        for k, (addr, _, tgt) in enumerate(best):
            if tgt is not None and tgt > addr:
                rng = [a for a, _, _ in best[k + 1:] if a < tgt]
                if any(_op(x).startswith("CALL") for a, x, _ in best if a in rng):
                    skipped.update(rng)
        slow = len(skipped)
        ops = {}
        for _, x, _ in best:
            op = _op(x).split(".")[0]
            ops[op] = ops.get(op, 0) + 1
        tests = max(ops.get("FMUL", 0) // per, 1)
        out[tag] = {"instructions": len(best), "tests": tests, "slow": slow,
                    "per_test": len(best) / tests, "per_test_fast": (len(best) - slow) / tests,
                    "ops": dict(sorted(ops.items(), key=lambda kv: -kv[1])),
                    "body": [x for _, x, _ in best]}
    return out


def sass_loop_report(text):
    """sass_loops of a dump, one line per kernel."""
    lines = []
    for tag, loop in sass_loops(text).items():
        if loop is None:
            lines.append(f"sass {tag}: no loop with a test found")
            continue
        top = ", ".join(f"{k} {v}" for k, v in list(loop["ops"].items())[:12])
        lines.append(f"sass {tag}: innermost loop {loop['instructions']} instructions, "
                     f"{loop['tests']} tests, {loop['slow']} on the slow path; per test "
                     f"{loop['per_test']:.2f} ({loop['per_test_fast']:.2f} without them); {top}")
    return lines


def sass_dump(lib_path):
    """cuobjdump -sass of the built library (the toolkit's, beside nvcc);
    raises RuntimeError if it fails."""
    from pyrenderer_tpu_torch.kernels import build

    tool = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    proc = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"cuobjdump failed ({proc.returncode}): {proc.stderr.strip()[:300]}")
    return proc.stdout


# ---------------------------------------------------------------------------
# the extract probe's latency floor (PERF.md section 2): each instruction's
# latency on the card (perf/latency.cu, one warp, clock64 around a chain of
# LATENCY_CHAIN dependent instructions) and a round's dependent chain read
# off the probe loop's SASS (round_cycles)
# ---------------------------------------------------------------------------

LATENCY_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "latency.cu")
LATENCY_CHAIN = 256
# perf/latency.cu's kinds, in the order of its kind argument
LATENCY_KINDS = ("fadd", "fmul", "fadd+fmax", "shfl", "redux", "key", "lds", "sts+lds", "bar")
# the opcode class each chain's cycles solve for, in order: every other
# class on a chain is solved by an earlier one ("INT": every integer or
# move instruction, the key map's shr/or/xor and REDUX's move back)
LATENCY_SOLVE = (("key", "INT"), ("fadd", "FADD"), ("fmul", "FMUL"), ("shfl", "SHFL"),
                 ("lds", "LDS"), ("fadd+fmax", "FMNMX"), ("redux", "REDUX"),
                 ("sts+lds", "STS"), ("bar", "BAR"))
LATENCY_CLASSES = tuple(cls for _, cls in LATENCY_SOLVE if cls != "INT")


def latency_class(text):
    """The latency class of a SASS instruction: its opcode for the classes
    the chains measure, "INT" for any other."""
    op = _op(text).split(".")[0]
    return op if op in LATENCY_CLASSES else "INT"


def latency_library():
    """perf/latency.cu built on its own (nvcc, the kernels' flags) into the
    kernels' build directory; returns its path."""
    import hashlib

    from pyrenderer_tpu_torch.kernels import build

    with open(LATENCY_SOURCE, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(build.NVCC_FLAGS).encode()).hexdigest()
    out = os.path.join(str(build.BUILD_DIR), f"liblatency_{digest[:16]}.so")
    if not os.path.exists(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
        tmp = f"{out}.{os.getpid()}"
        cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-shared", "-o", tmp, LATENCY_SOURCE]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on perf/latency.cu:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out


def chain_cycles(dev, reps=5):
    """{kind: cycles} of each LATENCY_KINDS chain on the card, the least of
    `reps` launches (one warp; each launch's second pass)."""
    import ctypes

    lib = ctypes.CDLL(latency_library())
    p = ctypes.c_void_p
    lib.pr_latency.argtypes = [ctypes.c_int, p, p, p, p]
    lib.pr_latency.restype = ctypes.c_int
    # x = 1, y = 1 (adds grow x by 1, products keep it), z = 0.5
    inp = torch.tensor([1.0] * 64 + [0.5] * 32, dtype=torch.float32, device=dev)
    out = torch.zeros(1, dtype=torch.int64, device=dev)
    sink = torch.empty(32, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    result = {}
    for kind, name in enumerate(LATENCY_KINDS):
        best = None
        for _ in range(reps):
            err = lib.pr_latency(kind, inp.data_ptr(), out.data_ptr(), sink.data_ptr(), stream)
            if err != 0:
                raise RuntimeError(f"pr_latency({name}) failed with cudaError_t {err}")
            torch.cuda.synchronize(dev)
            c = int(out.item())
            best = c if best is None else min(best, c)
        result[name] = best
    return result


def chain_ops(text):
    """{kind: {class: count}} of each latency chain in a cuobjdump -sass dump
    of the latency library: the instructions of the chain's timed loop that
    occur LATENCY_CHAIN times or more, by latency class."""
    out = {}
    for fname, ins in _sass_functions(text).items():
        m = re.search(r"lat_kernelILi(\d+)E", fname)
        if not m:
            continue
        index = {addr: k for k, (addr, _, _) in enumerate(ins)}
        loops = [ins[index[tgt]:k + 1] for k, (addr, _, tgt) in enumerate(ins)
                 if tgt is not None and tgt <= addr and tgt in index]
        counts = {}
        for _, x, _ in max(loops, key=len) if loops else ():
            op = _op(x)
            counts[op] = counts.get(op, 0) + 1
        classes = {}
        for op, n in counts.items():
            if n >= LATENCY_CHAIN:
                cls = latency_class(op)
                classes[cls] = classes.get(cls, 0) + n
        out[LATENCY_KINDS[int(m.group(1))]] = classes
    return out


def chain_latencies(cycles, ops):
    """{class: cycles} of each latency class: LATENCY_SOLVE in order, each
    chain's cycles less its instructions of classes already known, over
    its instructions of the class it solves."""
    lat = {}
    for kind, cls in LATENCY_SOLVE:
        chain = ops.get(kind, {})
        if chain.get(cls, 0) == 0 or any(c not in lat for c in chain if c != cls):
            raise RuntimeError(f"latency chain {kind}: cannot solve for {cls} from the "
                               f"instructions {chain}")
        known = sum(lat[c] * n for c, n in chain.items() if c != cls)
        lat[cls] = (cycles[kind] - known) / chain[cls]
    return lat


_NO_DEST = ("ST", "STS", "STG", "STL", "RED", "BAR", "BRA", "EXIT", "NOP", "WARPSYNC", "BSSY",
            "BSYNC", "DEPBAR", "MEMBAR", "CALL", "RET", "YIELD")


def _operand_regs(operand, width=1):
    """The registers an operand names (R, UR, P, UP; RZ and PT are none);
    a destination of a .64 or .128 instruction spans 2 or 4 registers."""
    regs = []
    for kind, num in re.findall(r"\b(U?R|U?P)(\d+)\b", operand):
        regs += [f"{kind}{int(num) + k}" for k in range(width if kind.endswith("R") else 1)]
    return regs


def sass_deps(text):
    """(destinations, sources) of a SASS instruction, as register names."""
    m = re.match(r"^@!?(U?P\w+)\s+", text)
    srcs = [m.group(1)] if m else []
    body = text[m.end():] if m else text
    op, _, rest = body.partition(" ")
    operands = [x.strip() for x in rest.split(",")] if rest.strip() else []
    base = op.split(".")[0]
    width = 4 if ".128" in op else 2 if ".64" in op else 1
    if base in _NO_DEST or not operands:
        n_dest = 0
    elif base == "SHFL":
        n_dest = 2
    else:
        # the first operand, and the predicates that follow it (ISETP's
        # second, IADD3's carry)
        n_dest = 1
        while n_dest < len(operands) and re.fullmatch(r"U?P(\d|T)", operands[n_dest]):
            n_dest += 1
    dests = [r for x in operands[:n_dest] for r in _operand_regs(x, width)]
    srcs += [r for x in operands[n_dest:] for r in _operand_regs(x)]
    return dests, srcs


def round_cycles(body, lat, rounds=8):
    """Cycles a trip of a loop takes on one warp: the SASS `body` issued in
    order, one instruction a cycle at most, each when its sources are
    ready; a result is ready its class's latency (lat, chain_latencies)
    after issue; a BAR issues after the shared stores before it complete,
    and nothing issues before the BAR's latency has passed. The steady
    state of `rounds` trips (the mean of the later half): the floor of a
    loop whose trips form one dependent chain."""
    ready, t, stores, released, finish = {}, -1, 0, 0, []
    for _ in range(rounds):
        end = 0
        for text in body:
            cls = latency_class(text)
            dests, srcs = sass_deps(text)
            issue = max([t + 1, released] + [ready.get(r, 0) for r in srcs])
            if cls == "BAR":
                issue = max(issue, stores)
                released = issue + lat["BAR"]
            elif cls == "STS":
                stores = max(stores, issue + lat["STS"])
            t = issue
            for r in dests:
                ready[r] = issue + lat[cls]
                end = max(end, ready[r])
        finish.append(max(end, t + 1, released))
    half = rounds // 2
    return (finish[-1] - finish[half - 1]) / (rounds - half)


def extract_floor(loops, lat, n_ext, clock_mhz):
    """(ms, cycles a round) of the extract probe's latency floor at n_ext
    rounds: n_ext x round_cycles of its loop in the SASS (sass_loops; a
    trip of an unrolled loop runs its "tests" rounds) at the SM clock
    clock_mhz."""
    loop = loops["kb_extract_kernel"]
    cyc = round_cycles(loop["body"], lat) / loop["tests"]
    return n_ext * cyc / (clock_mhz * 1e6) * 1e3, cyc


def latency_report(dev):
    """(lat, lines): chain_latencies on this card and one line per class;
    builds and disassembles perf/latency.cu."""
    cycles = chain_cycles(dev)
    ops = chain_ops(sass_dump(latency_library()))
    lat = chain_latencies(cycles, ops)
    lines = [f"latency {kind}: {cycles[kind]} cycles for {LATENCY_CHAIN} steps of "
             + " + ".join(f"{n // LATENCY_CHAIN} {c}" for c, n in ops[kind].items())
             for kind in LATENCY_KINDS]
    lines.append("latency per instruction (cycles, one warp): "
                 + ", ".join(f"{cls} {v:.2f}" for cls, v in lat.items()))
    return lat, lines


def _bits(x):
    """A float32 tensor's bits (+0 and -0, and NaNs, told apart)."""
    return x.contiguous().view(torch.int32)


def probe_parity(kb, sets, out_dir):
    """Every probe at probe_params on every set, through its wrapper,
    against its twin bit for bit; saves the operands and the outputs to
    DIR/probes.pt. Returns the cases that differ and, per probe, the
    largest |kernel - twin|."""
    twins = {"leaf": kb.leaf_ref, "extract": kb.extract_ref, "cond": kb.cond_ref,
             "ctz": kb.ctz_ref}
    saved, bad, err = {}, 0, dict.fromkeys(twins, 0.0)
    for label, (rcol, tri) in sets.items():
        saved[label] = {"operands": (rcol.cpu(), tri.cpu())}
        for probe, param in probe_params(label):
            args = (rcol,) + (() if probe == "extract" else (tri,))
            params = param if isinstance(param, tuple) else (param,)
            ref = twins[probe](*args, *params)
            out = probe_call(kb, rcol, tri, probe, param)()
            torch.cuda.synchronize()
            differ = int((_bits(out) != _bits(ref)).sum())
            bad += int(differ > 0)
            err[probe] = max(err[probe], float((out - ref).abs().max()))
            if differ:
                print(f"probe parity {label} {probe} {param}: differs from the twin on "
                      f"{differ} rays ({int((out != ref).sum())} by value)", flush=True)
            saved[label][(probe, param)] = out.cpu()
        print(f"probe parity {label}: {rcol.shape[0]} rays, {len(probe_params(label))} "
              f"parameters against the twins", flush=True)
    os.makedirs(out_dir, exist_ok=True)
    torch.save(saved, os.path.join(out_dir, "probes.pt"))
    return bad, err


def compare_probes(a, b):
    """Per probe set and parameter, the rays on which two runs' outputs
    differ in their bits; returns True when none differs."""
    same = True
    for label in a:
        if label not in b or not all(torch.equal(x, y) for x, y in
                                     zip(a[label]["operands"], b[label]["operands"])):
            print(f"compare probes {label}: the two runs used different operands")
            same = False
            continue
        keys = [k for k in a[label] if k != "operands" and k in b[label]]
        differ = {k: int((_bits(a[label][k]) != _bits(b[label][k])).sum()) for k in keys}
        bad = {k: v for k, v in differ.items() if v}
        print(f"compare probes {label}: {len(keys)} parameters, outputs differ on "
              + (", ".join(f"{k} {v} rays" for k, v in bad.items()) if bad else "none"))
        same &= not bad
    return same


def probe_floor(loops, lat, probe, param, n, clock_mhz):
    """(ms or None, text) of one probe call's floor at the SM clock
    clock_mhz: the extract's latency floor (extract_floor), the others'
    issue floor (tests x the SASS instructions a test of their loop on the
    fast path over 132 SMs x 128 lanes x the clock)."""
    loop = loops.get(f"kb_{probe}_kernel")
    if clock_mhz is None or loop is None:
        return None, "no floor (no SM clock or no loop in the SASS)"
    if probe == "extract":
        ms, cyc = extract_floor(loops, lat, param, clock_mhz)
        return ms, (f"latency floor {ms:.6f} ms ({cyc:.1f} cycles a round, {loop['per_test']:.1f} "
                    f"SASS instructions a round, at {clock_mhz:.0f} MHz)")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ms = probe_tests(probe, param, n) * loop["per_test_fast"] / (sms * 128 * clock_mhz * 1e6) * 1e3
    return ms, (f"issue floor {ms:.6f} ms ({loop['per_test_fast']:.2f} SASS instructions a test "
                f"at {clock_mhz:.0f} MHz)")


def cmd_probes(args) -> int:
    """``kernels probes``: B9-B12 at every parameter of the harness's lists
    at 256 tiles, through their wrappers, from CUDA graphs in turns; ptxas
    and SASS of the probe kernels; with --parity, probe_sets against the
    twins."""
    import pyrenderer_tpu_torch
    from pyrenderer_tpu_torch.kernels import build
    from pyrenderer_tpu_torch.perf import kernelbench as kb

    dev = torch.device("cuda:0")
    card = card_line()
    package = os.path.dirname(os.path.abspath(pyrenderer_tpu_torch.__file__))
    print(f"package {package}; {card}", flush=True)
    t = time.perf_counter()
    build.library()
    print(f"kernels built or loaded in {time.perf_counter() - t:.2f} s", flush=True)
    for line in probe_ptxas(build.build_log()):
        print(line, flush=True)
    sass = sass_dump(build.build())
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "probes.sass"), "w") as fh:
        fh.write(sass)
    for line in sass_loop_report(sass):
        print(line, flush=True)
    loops = sass_loops(sass)
    lat, lines = latency_report(dev)
    for line in lines:
        print(line, flush=True)
    rcol, tri = kb.inputs(kb.N_TILES, dev)
    n = rcol.shape[0]
    cases = {(probe, param): probe_call(kb, rcol, tri, probe, param)
             for probe, param in probe_params("harness")}
    times = {key: [] for key in cases}
    sampler = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                                "--format=csv,noheader,nounits", "-lms", "100"],
                               stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        for key in list(cases) + list(reversed(cases)):
            times[key].append(kb.graph_ms(cases[key], REPS))
    finally:
        sampler.terminate()
    clocks = np.array([[float(x) for x in line.split(",")]
                       for line in sampler.communicate()[0].splitlines() if "," in line])
    clock = None
    if clocks.size:
        clock = clocks[0, 1]
        print(f"SM clock while timing (nvidia-smi every 100 ms, {len(clocks)} readings): median "
              f"{np.median(clocks[:, 0]):.0f} MHz, min {clocks[:, 0].min():.0f}, max "
              f"{clocks[:, 0].max():.0f}; the card's maximum {clock:.0f} MHz", flush=True)
    result = {}
    for (probe, param), ms in times.items():
        value = float(np.median(ms))
        b = probe_bound(probe, param, n)
        floor, note = probe_floor(loops, lat, probe, param, n, clock)
        result.setdefault(probe, {})[str(param)] = {"wrapper": value, "bound_ms": b[0],
                                                    "floor_ms": floor}
        print(f"probe {probe} {param} wrapper: {value:.4f} ms (median of {len(ms)} graph "
              f"replays of {REPS} calls; bound {b[0]:.6f} ms ({b[1]}); {note}; {n} rays; "
              f"{card})", flush=True)
    bad = None
    if args.parity:
        bad, _ = probe_parity(kb, probe_sets(dev), args.out)
        print(f"probe parity: {bad} cases differ from the twins", flush=True)
    print(json.dumps({"package": package, "card": card, "device": torch.cuda.get_device_name(0),
                      "probes": result, "latency_cycles": lat, "sm_clock_max_mhz": clock,
                      "parity_cases_differing": bad}))
    return 0


def compare_sweep(a, b):
    """Per sweep case, the rays on which two runs' kernels differ; returns
    True when none differs."""
    worst = 0
    for label in a:
        ra, rb = a[label]["rays"], b[label]["rays"]
        if not all(torch.equal(x, y) for x, y in zip(ra, rb)):
            print(f"compare {label}: the two runs traced different rays")
            worst = max(worst, 1)
            continue
        for wt in (False, True):
            t_r, slot_r = a[label][(wt, "twin")]
            for sort in (False, True):
                (ta, sa, oa), (tb, sb, ob) = a[label][(wt, sort)], b[label][(wt, sort)]
                diff = (ta != tb) | (sa != sb)
                twin_a = int(((ta == t_r) & (sa == slot_r))[diff].sum())
                twin_b = int(((tb == t_r) & (sb == slot_r))[diff].sum())
                print(f"compare {label}, {'watertight' if wt else 'MT'}, sort "
                      f"{'on' if sort else 'off'}: (t, slot) differ on {int(diff.sum())} of "
                      f"{ta.shape[0]} rays (the twin agrees with A on {twin_a}, with B on "
                      f"{twin_b}); occlusion differs on {int((oa != ob).sum())}")
                worst = max(worst, int(bool(diff.any() or (oa != ob).any())))
    return worst == 0


# (estimator, bounces) of the Cornell frames of ``frames``: the main path,
# the pbrt path, and pbrt with Russian roulette (from bounce 4)
FRAMES = (("reference", 4), ("pbrt", 4), ("pbrt", 8))


def cmd_frames(args) -> int:
    from pyrenderer_tpu_torch.config import RenderConfig
    from pyrenderer_tpu_torch.core.integrator import render_image

    scene, camera, _ = whole_scenes(torch.device("cuda:0"))["cornell"]
    out = {}
    for estimator, bounces in FRAMES:
        cfg = RenderConfig(max_bounces=bounces, spp=2, seed=0, estimator=estimator)
        out[f"{estimator} {bounces}"] = render_image(scene, camera, cfg).cpu()
    os.makedirs(args.out, exist_ok=True)
    torch.save(out, os.path.join(args.out, "frames.pt"))
    print(json.dumps({"frames": {k: float(v.mean()) for k, v in out.items()},
                      "card": card_line()}))
    return 0


def compare_frames(a, b):
    """Per frame, the pixels on which two runs differ in any bit; True when
    none does."""
    same = True
    for label in a:
        diff = (a[label].view(torch.int32) != b[label].view(torch.int32)).any(dim=-1)
        print(f"compare frames {label}: {int(diff.sum())} of {diff.numel()} pixels differ")
        same = same and not bool(diff.any())
    return same


def cmd_compare(args) -> int:
    """The files of `kernels --parity` (parity.pt), `kernels binned
    --parity` (binned.pt, prepass.pt), `kernels whole --parity` (whole.pt),
    `kernels probes --parity` (probes.pt) and `frames` (frames.pt) that both
    directories hold, compared."""
    same = {}
    for name, fn in (("parity.pt", compare_sweep), ("binned.pt", compare_binned),
                     ("prepass.pt", compare_prepass), ("whole.pt", compare_whole),
                     ("probes.pt", compare_probes), ("frames.pt", compare_frames)):
        paths = [os.path.join(d, name) for d in args.dirs]
        if all(os.path.exists(p) for p in paths):
            same[name] = fn(*(torch.load(p) for p in paths))
    print(json.dumps({"compare": args.dirs, "files": sorted(same),
                      "identical": bool(same) and all(same.values())}))
    return 0


def cmd_profile(args) -> int:
    from torch.autograd import DeviceType

    from pyrenderer_tpu_torch.utils.profiling import device_busy, trace_profile

    from pyrenderer_tpu_torch.config import RenderConfig
    from pyrenderer_tpu_torch.core.integrator import TraceTables, render_sample

    dev = torch.device("cuda:0")
    card = card_line()
    if args.backend == "cuda":
        scene, camera, _ = whole_scenes(dev)[args.scene]
        accel, res, spp = None, 1024, 16
    else:
        scene, camera, accel = terrain(224, dev)
        res, spp = 512, 4
    cfg = RenderConfig(max_bounces=4, spp=spp, seed=0, estimator=args.estimator)
    tables = TraceTables(scene, cfg, args.backend, accel=accel)
    px, py = morton_chunk(res, dev)
    # chunk-samples per frame: chunks of 2^16 pixels x spp
    per_frame = res * res // N_RAYS * spp
    label = args.scene if args.backend == "cuda" else "terrain100k"

    def window(first):
        for s in range(first, first + SAMPLES):
            render_sample(scene, camera, cfg, cfg.seed, s, px, py, tables=tables,
                          with_stats=True)
        torch.cuda.synchronize()

    window(0)
    walls = []
    for k in range(3):
        t = time.perf_counter()
        window(k * SAMPLES)
        walls.append((time.perf_counter() - t) * 1e3 / SAMPLES)
    wall = float(np.median(walls))
    with trace_profile(args.trace_dir) as prof:
        window(0)
    events = prof.events()
    busy, per_name, device = device_busy(events)
    host = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name.startswith(("cudaLaunchKernel",
                                                                  "cudaStreamSynchronize",
                                                                  "cudaMemcpyAsync")):
            host[e.name] = host.get(e.name, 0) + 1
    busy_ms = busy / 1e3 / SAMPLES
    # kernels in an anonymous namespace (the port's all are) by name, the
    # rest summed
    ours = {}
    for name, us in per_name.items():
        m = re.search(r"\(anonymous namespace\)::(\w+(<\w+>)?)", name)
        key = m.group(1) if m else "other kernels"
        ours[key] = ours.get(key, 0.0) + us
    report = {
        "scene": label, "estimator": args.estimator, "chunk_samples_per_frame": per_frame,
        "backend": tables.backend, "card": card,
        "wall_ms_per_chunk_sample": wall, "wall_ms_windows": walls,
        "device_busy_ms_per_chunk_sample": busy_ms if device else None,
        "idle_share": 1.0 - busy_ms / wall if device else None,
        "device_ms_per_chunk_sample": {k: us / 1e3 / SAMPLES for k, us in
                                       sorted(ours.items(), key=lambda kv: -kv[1])},
        "device_ms_per_frame": {k: us / 1e3 / SAMPLES * per_frame for k, us in
                                sorted(ours.items(), key=lambda kv: -kv[1])},
        "host_calls_per_chunk_sample": {k: v / SAMPLES for k, v in host.items()},
        "device_events": device,
    }
    print(f"profile {label} {args.estimator} {tables.backend} ({card}): wall {wall:.3f} ms per "
          f"chunk-sample (windows {', '.join(f'{w:.3f}' for w in walls)}), device busy "
          + (f"{busy_ms:.3f} ms, idle share {1.0 - busy_ms / wall:.4f}" if device
             else "not measured (the profiler saw no device event)"), flush=True)
    print(json.dumps(report))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = parser.add_subparsers(dest="cmd", required=True)
    k = sub.add_parser("kernels")
    k.add_argument("which", nargs="?", default="sweep",
                   choices=("sweep", "binned", "whole", "probes"))
    k.add_argument("--parity", action="store_true")
    k.add_argument("--out", default=os.path.join("build", "clusterbench"))
    c = sub.add_parser("compare")
    c.add_argument("dirs", nargs=2)
    p = sub.add_parser("profile")
    p.add_argument("--backend", default="cluster",
                   choices=("cluster", "cluster_binned", "cluster_streamed", "cuda"))
    p.add_argument("--scene", default="spheres", choices=("cornell", "spheres"),
                   help="the whole-table frame of --backend cuda")
    p.add_argument("--estimator", default="reference", choices=("reference", "pbrt"))
    p.add_argument("--trace-dir", default=os.path.join("build", "clusterbench", "trace"),
                   help="where the profiled window's Chrome trace is written")
    f = sub.add_parser("frames")
    f.add_argument("--out", default=os.path.join("build", "clusterbench"))
    args = parser.parse_args(argv)
    if args.cmd != "compare" and not torch.cuda.is_available():
        print("no CUDA device: clusterbench runs on a GPU", file=sys.stderr)
        return 2
    if args.cmd == "kernels" and args.which != "sweep":
        return {"binned": cmd_binned, "whole": cmd_whole, "probes": cmd_probes}[args.which](args)
    return {"kernels": cmd_kernels, "compare": cmd_compare, "profile": cmd_profile,
            "frames": cmd_frames}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
