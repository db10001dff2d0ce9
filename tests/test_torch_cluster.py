"""pyrenderer_tpu_torch large-scene path: the procgen scenes, the ClusterScene
build, the cluster-sweep kernels' plain twins against the JAX package (its
twin and its Pallas kernels in interpret mode), routing, and the "cluster"
backend end to end against the JAX integrator and the NumPy oracle."""

import ctypes
import dataclasses
import os
import re
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyrenderer_tpu.accel import clusters as clj
from pyrenderer_tpu.config import RenderConfig as JaxConfig
from pyrenderer_tpu.core import integrator as integ_jax
from pyrenderer_tpu.core.camera import generate_rays as generate_rays_jax
from pyrenderer_tpu.kernels import pallas_cluster as pc
from pyrenderer_tpu.ref import scalar as ref
from pyrenderer_tpu.scene import procgen as procgen_jax
from pyrenderer_tpu.scene.tungsten import build_scene as build_scene_jax
from pyrenderer_tpu.scene.tungsten import load_tungsten
from pyrenderer_tpu_torch.accel import clusters as cl
from pyrenderer_tpu_torch.config import RenderConfig
from pyrenderer_tpu_torch.core import integrator as integ
from pyrenderer_tpu_torch.kernels import binned as kb
from pyrenderer_tpu_torch.kernels import build
from pyrenderer_tpu_torch.kernels import cluster as kc
from pyrenderer_tpu_torch.render.driver import ProgressiveRenderer
from pyrenderer_tpu_torch.scene import procgen, to_device
from pyrenderer_tpu_torch.scene.tungsten import build_scene
from tests.torch_fixtures import private_jax_native_cache  # noqa: F401 (autouse)

torch.set_num_threads(2)

T0, T1 = 1e-5, 1e5
CFG = RenderConfig(max_bounces=4, spp=2, seed=3, estimator="reference")
CFG_JAX = JaxConfig(max_bounces=4, spp=2, seed=3, estimator="reference")
QUAD = (np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32),
        np.array([[0, 1, 2], [0, 2, 3]], np.int32))


@pytest.fixture(scope="module")
def terrain():
    """Cornell walls and light around the 8,192-triangle terrain(64): the
    host arrays and camera of the port's loader."""
    host, camera, _ = build_scene(procgen.big_scene_data("terrain", res=64))
    return host, camera


@pytest.fixture(scope="module")
def clusters(terrain):
    host, _ = terrain
    return cl.build_clusters(host.vertices, host.faces), \
        clj.build_clusters(host.vertices, host.faces)


def _random_rays(n, seed):
    """Rays inside the box, as tests/test_cluster.py makes them."""
    rs = np.random.RandomState(seed)
    ro = rs.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    ro[:, 1] += 1.0
    rd = rs.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro, rd


@pytest.mark.parametrize("kind, kw", [
    ("terrain", {"res": 16}),
    ("terrain", {"res": 48, "roughness": 0.7, "seed": 3}),
    ("blob", {"subdivisions": 2}),
])
def test_procgen_matches_jax(kind, kw):
    mesh = procgen.terrain if kind == "terrain" else procgen.blob
    mesh_jax = procgen_jax.terrain if kind == "terrain" else procgen_jax.blob
    for a, b in zip(mesh(**kw), mesh_jax(**kw)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    host, cam, _ = build_scene(procgen.big_scene_data(kind, **kw))
    host_j, cam_j, _ = build_scene_jax(procgen_jax.big_scene_data(kind, **kw))
    for a, b in zip(host, host_j):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert np.array_equal(cam.iview, cam_j.iview) and cam.resolution == cam_j.resolution


@pytest.mark.parametrize("which", ["terrain64", "terrain96", "quad", "cornell"])
def test_cluster_scene_matches_jax(which, terrain, cornell_path):
    """Every array of the port's ClusterScene equals the JAX build's (NaN
    padding included), the binned traversal's bin_box too; child_box lacks
    only JAX's trailing rows for the TPU's pair-peeled sweep."""
    if which == "terrain64":
        verts, faces = terrain[0].vertices, terrain[0].faces
    elif which == "terrain96":
        host, _, _ = build_scene(procgen.big_scene_data("terrain", res=96))
        verts, faces = host.vertices, host.faces
    elif which == "quad":
        verts, faces = QUAD
    else:
        host, _, _ = load_tungsten(cornell_path, dtype=np.float32)
        verts, faces = host.vertices, host.faces
    cs = cl.build_clusters(verts, faces)
    cs_j = clj.build_clusters(np.asarray(verts), np.asarray(faces))
    k = cs.n_clusters
    assert k == cs_j.n_clusters and cs.n_superclusters == cs_j.n_superclusters
    for name in ("tri", "bin_box", "super_box", "super_cols", "order", "world_lo",
                 "world_inv_span"):
        ours, theirs = getattr(cs, name).numpy(), np.asarray(getattr(cs_j, name))
        assert ours.dtype == theirs.dtype, name
        np.testing.assert_array_equal(ours, theirs, err_msg=name)
    np.testing.assert_array_equal(cs.child_box.numpy(), np.asarray(cs_j.child_box)[:k])
    # both kinds of padding carry NaN boxes: clusters past the real ones
    # and supercluster rows past S
    k_real = -(-faces.shape[0] // cl.LANE_TRIS)
    assert np.isnan(cs.child_box[k_real:, :6].numpy()).all()
    assert np.isfinite(cs.child_box[:k_real, :6].numpy()).all()
    assert np.isnan(cs.super_cols[cs.n_superclusters:, :6].numpy()).all()
    assert cs.super_cols.shape[0] % 32 == 0 and k % cl.GROUP == 0
    # bins past the last real cluster, and the rows padding the bins to a
    # multiple of 32, are NaN; the others are finite
    kb_real = -(-k_real // cl.BIN)
    assert cs.bin_box.shape[0] % 32 == 0 and cs.bin_box.shape[0] >= k // cl.BIN
    assert np.isnan(cs.bin_box[kb_real:, :6].numpy()).all()
    assert np.isfinite(cs.bin_box[:kb_real, :6].numpy()).all()


@pytest.mark.parametrize("which", ["terrain64", "quad"])
def test_compact_box_copies(which, terrain):
    """The kernels' compact box tables equal the first BOX_ROW lanes of
    child_box and super_cols, NaN padding rows included, are contiguous,
    and ClusterScene.to carries them."""
    verts, faces = (terrain[0].vertices, terrain[0].faces) if which == "terrain64" else QUAD
    cs = cl.build_clusters(verts, faces)
    for small, full in ((cs.child_box8, cs.child_box), (cs.super_cols8, cs.super_cols)):
        assert small.shape == (full.shape[0], cl.BOX_ROW) and small.is_contiguous()
        assert small.dtype == torch.float32
        torch.testing.assert_close(small, full[:, :cl.BOX_ROW], rtol=0, atol=0, equal_nan=True)
        assert not small[:, 6:].any()
    k_real = -(-faces.shape[0] // cl.LANE_TRIS)
    assert torch.isnan(cs.child_box8[k_real:, :6]).all()
    assert torch.isnan(cs.super_cols8[cs.n_superclusters:, :6]).all()
    assert torch.isfinite(cs.super_cols8[:cs.n_superclusters, :6]).all()
    moved = cs.to(torch.device("cpu"))
    assert isinstance(moved, cl.ClusterScene) and moved is not cs
    torch.testing.assert_close(moved.child_box8, cs.child_box8, rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(moved.super_cols8, cs.super_cols8, rtol=0, atol=0, equal_nan=True)


def test_slab_rejects_nan_boxes(clusters):
    """A NaN box never crosses, even for rays that cross everything else."""
    cs, _ = clusters
    ro, rd = (torch.from_numpy(a) for a in _random_rays(256, 1))
    inv_d = 1.0 / torch.where(rd == 0, 1e-20, rd)
    t1 = torch.full((256,), T1)
    big = torch.tensor([-10.0, -10.0, -10.0]), torch.tensor([10.0, 10.0, 10.0])
    assert cl._slab(*big, ro, inv_d, T0, t1).all()
    for bmin, bmax in ((torch.full((3,), torch.nan), big[1]),
                       (big[0], torch.tensor([10.0, torch.nan, 10.0]))):
        assert not cl._slab(bmin, bmax, ro, inv_d, T0, t1).any()
    # t1 = 0 (a dead lane) culls every box
    assert not cl._slab(*big, ro, inv_d, T0, torch.zeros(256)).any()


def test_sort_keys_bit_equal(clusters):
    cs, cs_j = clusters
    ro, rd = _random_rays(512, 2)
    ro[:8] = [[-5, -5, -5], [5, 5, 5], [0, 0, 0], [-1, 0, -1],
              [1, 2, 1], [0.3, -0.1, 9], [-9, 1, 0.2], [0.1, 0.2, 0.3]]
    rd[:6] = [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]]
    keys = cl.sort_keys(cs, torch.from_numpy(ro), torch.from_numpy(rd)).numpy()
    keys_j = np.asarray(clj.sort_keys(cs_j, jnp.asarray(ro), jnp.asarray(rd)))
    assert keys.dtype == np.int64 and keys_j.dtype == np.uint32
    assert np.array_equal(keys, keys_j.astype(np.int64))


@pytest.mark.parametrize("watertight", [False, True])
def test_twins_match_jax_twin(clusters, watertight):
    """closest_hit_ref / occluded_ref against the JAX twin, scalar and
    per-ray t1: hit masks and occlusion equal, faces > 0.995, t rtol 1e-4."""
    cs, cs_j = clusters
    ro, rd = _random_rays(512, 5)
    t1_ray = np.random.RandomState(1).uniform(0.1, 3.0, 512).astype(np.float32)
    for t1, t1_j in ((T1, T1), (torch.from_numpy(t1_ray), jnp.asarray(t1_ray))):
        h, t, slot = (x.numpy() for x in cl.closest_hit_ref(
            cs, torch.from_numpy(ro), torch.from_numpy(rd), T0, t1, watertight=watertight))
        h_j, t_j, slot_j = (np.asarray(x) for x in clj.closest_hit_ref(
            cs_j, jnp.asarray(ro), jnp.asarray(rd), T0, t1_j, watertight=watertight))
        assert h.any() and np.array_equal(h, h_j)
        assert slot.dtype == np.int32 and (slot[h] == slot_j[h]).mean() > 0.995
        assert np.all(slot[~h] == -1) and np.all(t[~h] == 0)
        np.testing.assert_allclose(t[h], t_j[h], rtol=1e-4)
        occ = cl.occluded_ref(cs, torch.from_numpy(ro), torch.from_numpy(rd), T0, t1,
                              watertight=watertight).numpy()
        occ_j = np.asarray(clj.occluded_ref(cs_j, jnp.asarray(ro), jnp.asarray(rd), T0,
                                            t1_j, watertight=watertight))
        assert np.array_equal(occ, occ_j)


def _case(name):
    """(ray count, sort, t1 as numpy or scalar) of a twin-vs-kernel case."""
    if name == "sorted":
        return 256, True, T1
    if name == "ragged":
        return 300, False, T1
    if name == "per_ray_t1":
        return 256, True, np.random.RandomState(1).uniform(0.1, 3.0, 256).astype(np.float32)
    return 256, True, np.where(np.arange(256) % 3 == 0, 0.0, T1).astype(np.float32)


@pytest.mark.parametrize("watertight", [False, True])
@pytest.mark.parametrize("case", ["sorted", "ragged", "per_ray_t1", "dead_lanes"])
def test_wrappers_match_pallas_interpret(clusters, case, watertight):
    """The port's public closest_hit / occluded (their twins on CPU tensors)
    against the TPU kernels run in interpret mode, with the bounds of
    tests/test_cluster.py: equal hit masks, faces > 0.995, t rtol 1e-4,
    occlusion agreement > 0.995."""
    cs, cs_j = clusters
    n, sort, t1 = _case(case)
    ro, rd = _random_rays(n, 11)
    t1_t = t1 if np.isscalar(t1) else torch.from_numpy(t1)
    t1_j = t1 if np.isscalar(t1) else jnp.asarray(t1)
    h, t, face = (x.numpy() for x in kc.closest_hit(
        cs, torch.from_numpy(ro), torch.from_numpy(rd), T0, t1_t, sort=sort,
        watertight=watertight))
    h_j, t_j, face_j = (np.asarray(x) for x in pc.closest_hit(
        cs_j, jnp.asarray(ro), jnp.asarray(rd), T0, t1_j, sort=sort,
        watertight=watertight, interpret=True))
    assert h.shape == (n,) and face.dtype == np.int32
    assert h.any() and np.array_equal(h, h_j)
    assert (face[h] == face_j[h]).mean() > 0.995
    np.testing.assert_allclose(t[h], t_j[h], rtol=1e-4)
    assert np.all(face[~h] == 0) and np.all(t[~h] == 0)
    occ = kc.occluded(cs, torch.from_numpy(ro), torch.from_numpy(rd), T0, t1_t,
                      sort=sort, watertight=watertight).numpy()
    occ_j = np.asarray(pc.occluded(cs_j, jnp.asarray(ro), jnp.asarray(rd), T0, t1_j,
                                   sort=sort, watertight=watertight, interpret=True))
    assert (occ == occ_j).mean() > 0.995
    if case == "dead_lanes":
        dead = np.arange(n) % 3 == 0
        assert not h[dead].any() and not occ[dead].any()


def test_cpu_wrappers_use_twins_and_count(clusters):
    """On CPU tensors the wrappers run the twins, count twin calls and no
    launch; exact_t=False returns the twin's own leaf t."""
    cs, _ = clusters
    ro, rd = (torch.from_numpy(a) for a in _random_rays(128, 3))
    kc.reset_counters()
    h, t, face = kc.closest_hit(cs, ro, rd, T0, T1, sort=True, exact_t=False)
    occ = kc.occluded(cs, ro, rd, T0, T1)
    assert kc.closest_hit.twin_calls == 1 and kc.occluded.twin_calls == 1
    assert kc.closest_hit.launches == 0 and kc.occluded.launches == 0
    kc.reset_counters()
    h_r, t_r, slot = cl.closest_hit_ref(cs, ro, rd, T0, T1)
    assert torch.equal(h, h_r) and torch.equal(t, t_r) and torch.equal(occ, h_r)
    assert torch.equal(face, cl.slot_to_face(cs, slot).to(torch.int32))
    t_exact = kc.closest_hit(cs, ro, rd, T0, T1)[1]
    torch.testing.assert_close(t_exact, t, rtol=1e-5, atol=0.0)
    with pytest.raises(ValueError, match="no kernel"):
        kc.closest_hit(cs, ro.to("meta"), rd.to("meta"), T0, T1)
    with pytest.raises(ValueError, match="no kernel"):
        kc.occluded(cs, ro.to("meta"), rd.to("meta"), T0, T1)
    kc.reset_counters()


def _kernel_stand_in(cs, prepared, names):
    """A stand-in for build.launch on the cluster kernels' route: checks the
    pointers and sizes against the operands _operands prepared (the last of
    `prepared`) and writes what the kernel computes -- the twin on those
    rays, in launch order, t = 3e38 on a miss -- through the output
    pointers."""
    def launch(name, device, tri, child_box, super_sorted, order, s_pad, rays, t0, n,
               watertight, *outs):
        r, _, order_t, sup_t = prepared[-1]
        assert (tri, child_box) == (cs.tri.data_ptr(), cs.child_box8.data_ptr())
        assert (super_sorted, order, rays) == (sup_t.data_ptr(), order_t.data_ptr(),
                                               r.data_ptr())
        assert s_pad == cs.super_cols8.shape[0] == order_t.shape[0] and n == r.shape[0]
        hit, t, slot = cl.closest_hit_ref(cs, r[:, 0:3], r[:, 3:6], t0, r[:, 6],
                                          watertight=bool(watertight))
        results = (torch.where(hit, t, cl.MISS_T), slot) if name == "pr_cluster_closest" \
            else (hit,)
        assert len(outs) == len(results)
        for ptr, x in zip(outs, results):
            ctypes.memmove(ptr, x.contiguous().data_ptr(), x.numel() * x.element_size())
        names.append(name)
    return launch


@pytest.mark.parametrize("sort", [False, True])
def test_kernel_route_prepares_operands_then_launches_once(clusters, monkeypatch, sort):
    """The wrappers' CUDA route in two steps, run here with a stand-in for
    the kernel launch: _operands (checks, the sort, the rank) and _launch
    (one launch on those operands, counted). The results come back in the
    caller's order, equal to the twins'; the sort puts dead lanes last."""
    cs, _ = clusters
    ro, rd = (torch.from_numpy(a) for a in _random_rays(300, 7))
    t1 = torch.from_numpy(np.where(np.arange(300) % 3 == 0, 0.0, T1).astype(np.float32))
    prepared, names = [], []
    operands = kc._operands
    monkeypatch.setattr(kc, "_operands", lambda *a: prepared.append(operands(*a)) or prepared[-1])
    monkeypatch.setattr(build, "on_cuda", lambda x, name: True)
    monkeypatch.setattr(build, "launch", _kernel_stand_in(cs, prepared, names))
    kc.reset_counters()
    h, t, face = kc.closest_hit(cs, ro, rd, T0, t1, sort=sort, exact_t=False)
    occ = kc.occluded(cs, ro, rd, T0, t1, sort=sort)
    assert names == ["pr_cluster_closest", "pr_cluster_occluded"]
    assert (kc.closest_hit.launches, kc.occluded.launches) == (1, 1)
    assert kc.closest_hit.twin_calls == kc.occluded.twin_calls == 0
    kc.reset_counters()
    h_r, t_r, slot_r = cl.closest_hit_ref(cs, ro, rd, T0, t1)
    assert h_r.any() and torch.equal(h, h_r) and torch.equal(t, t_r)
    assert torch.equal(face, cl.slot_to_face(cs, slot_r).to(torch.int32))
    assert torch.equal(occ, h_r)
    rays, perm, order, super_sorted = prepared[0]
    order_r, super_r = kc._sc_order(cs, ro)
    assert torch.equal(order, order_r)
    torch.testing.assert_close(super_sorted, super_r, rtol=0, atol=0, equal_nan=True)
    assert rays.shape == (300, 8) and rays.dtype == torch.float32
    if sort:
        assert torch.equal(rays, kc._prepare(cs, ro, rd, t1, False)[0][perm])
        live = rays[:, 6] > 0
        assert live[:200].all() and not live[200:].any()
    else:
        assert perm is None and torch.equal(rays[:, 6], t1)


def test_operands_check_the_warp_padding(clusters):
    """S_pad must be a multiple of the warp (the kernels ballot 32
    supercluster rows at once); the build pads it so."""
    cs, _ = clusters
    ro, rd = (torch.from_numpy(a) for a in _random_rays(8, 3))
    assert cs.super_cols8.shape[0] % kc.WARP == 0
    rays, perm, order, super_sorted = kc._operands(cs, ro, rd, T1, False)
    assert perm is None and order.shape == (cs.super_cols8.shape[0],)
    assert super_sorted.shape == (cs.super_cols8.shape[0], cl.BOX_ROW)
    short = dataclasses.replace(cs, super_cols8=cs.super_cols8[:-1])
    with pytest.raises(ValueError, match="multiple of 32"):
        kc._operands(short, ro, rd, T1, False)
    wide = dataclasses.replace(cs, child_box8=cs.child_box)
    with pytest.raises(ValueError, match="8 columns"):
        kc._operands(wide, ro, rd, T1, False)


def test_walk_counts_the_front_to_back_walk(clusters):
    """perf/clusterbench.walk, the per-ray work the kernels' walk needs at
    the least (the bound of chip_smoke.py phase 9): the any-hit walk finds
    the twin's occlusion, dead rays cost nothing, every live ray slab-tests
    each supercluster once, and a closest-hit ray culled by its final t
    runs whole leaves, at least one where it hits; an any-hit ray stops at
    its first occluder."""
    from pyrenderer_tpu_torch.perf import clusterbench

    cs, _ = clusters
    ro, rd = (torch.from_numpy(a) for a in _random_rays(256, 13))
    t1 = torch.from_numpy(np.where(np.arange(256) % 4 == 0, 0.0, T1).astype(np.float32))
    live = t1 > T0
    slabs, tests, occ = clusterbench.walk(cs, ro, rd, t1, watertight=False)
    assert torch.equal(occ, cl.occluded_ref(cs, ro, rd, T0, t1))
    assert not (slabs[~live].any() or tests[~live].any())
    assert occ.any() and bool((slabs[live & ~occ] >= cs.n_superclusters).all())
    assert bool((tests[occ] >= 1).all()) and bool((tests <= 128 * cs.n_clusters).all())
    hit, t, _ = cl.closest_hit_ref(cs, ro, rd, T0, t1)
    slabs_c, tests_c, _ = clusterbench.walk(cs, ro, rd, t1, torch.where(hit, t, t1))
    assert bool((slabs_c[live] >= cs.n_superclusters).all()) and not slabs_c[~live].any()
    assert bool((tests_c % cl.LANE_TRIS == 0).all()) and bool((tests_c[hit] >= 128).all())
    assert not tests_c[~live].any()


def test_kernel_source_matches_twin_constants():
    """The constants written into csrc/leaf.cuh (shared by the sweep and the
    binned kernels) and csrc/binned.cu are the twins', and the binned leaves
    are instantiated for the bin sizes kernels/binned.py lets them run."""
    csrc = os.path.join(os.path.dirname(kc.__file__), "..", "csrc")
    src = ""
    for name in ("leaf.cuh", "binned.cu"):
        with open(os.path.join(csrc, name)) as fh:
            src += fh.read()

    def const(name):
        return re.search(rf"constexpr \w+ {name} = ([^;]+);", src).group(1).split()[0]

    assert float.fromhex(const("kSlabWiden").rstrip("f")) == cl.SLAB_WIDEN
    assert float.fromhex(const("kEdgeRelTol").rstrip("f")) == 2.0 ** -22
    assert float(const("kMissT").rstrip("f")) == cl.MISS_T
    assert int(const("kLane")) == cl.LANE_TRIS and int(const("kGroup")) == cl.GROUP
    assert int(const("kTriRows")) == cl.TRI_ROWS
    assert int(const("kSentinel"), 16) == kb.SENTINEL
    # the leaves are instantiated for each BIN of kernels/binned.BIN_KERNELS
    picker = src[src.index("LeafKernel leaf_kernel_for("):]
    picker = picker[:picker.index("default:")]
    assert tuple(int(c) for c in re.findall(r"case (\d+):", picker)) == kb.BIN_KERNELS
    assert cl.BIN in kb.BIN_KERNELS and cl.BIN_TRIS == cl.BIN * cl.LANE_TRIS
    with open(os.path.join(csrc, "cluster.cu")) as fh:
        cluster_src = fh.read()
    assert '#include "leaf.cuh"' in cluster_src
    # the warp's ballot over supercluster rows: S_pad is a multiple of it
    warp = int(const("kWarp"))
    assert warp == kc.WARP and cl.LANE_TRIS % warp == 0
    # the streamed leaf's warps share a block's run of pairs evenly
    assert kb.RUN_PAIRS % (int(const("kThreads")) // warp) == 0
    # the compact box rows the kernels read
    assert int(re.search(r"constexpr int kBoxRow = (\d+);", cluster_src).group(1)) == cl.BOX_ROW


def test_routing_and_auto_policies(terrain):
    """"auto" picks the cluster sweep above AUTO_BRUTE_MAX_TRIS on CUDA and
    the BVH on the CPU (as the JAX package does off the TPU), or the
    backend of a given accelerator; "bvh" and "cluster_chunked" resolve;
    sort and watertight switch on at AUTO_SORT_MIN_CLUSTERS; suspend/resume
    rounds build."""
    from pyrenderer_tpu_torch.accel.bvh import FlatBVH

    limit = integ.AUTO_BRUTE_MAX_TRIS
    assert integ.resolve_backend("auto", limit + 1, "cuda:0") == "cluster"
    assert integ.resolve_backend("auto", limit + 1, "cpu") == "bvh"
    assert integ.resolve_backend("auto", limit, "cpu") == "brute"
    assert integ.resolve_backend("auto", limit, "cuda:0") == "cuda"
    assert integ.resolve_backend("cluster", 36, "cpu") == "cluster"
    assert integ.resolve_backend("watertight", 10 ** 6, "cpu") == "watertight"
    for backend in ("bvh", "cluster_chunked"):
        for dev in ("cpu", "cuda:0"):
            assert integ.resolve_backend(backend, 10 ** 5, dev) == backend

    small = types.SimpleNamespace(n_clusters=integ.AUTO_SORT_MIN_CLUSTERS - 1)
    large = types.SimpleNamespace(n_clusters=integ.AUTO_SORT_MIN_CLUSTERS)
    for resolve in (integ.resolve_cluster_sort, integ.resolve_cluster_watertight):
        assert not resolve(CFG, small) and resolve(CFG, large)
    for forced in (True, False):
        cfg = CFG.replace(cluster_sort=forced, cluster_watertight=forced)
        assert integ.resolve_cluster_sort(cfg, small) is forced
        assert integ.resolve_cluster_watertight(cfg, large) is forced

    host, camera = terrain
    scene, _ = to_device(host, camera, "cpu")
    assert scene.faces.shape[0] > limit
    assert isinstance(integ.maybe_build_accel(scene, "auto"), FlatBVH)
    accel = integ.maybe_build_accel(scene, "cluster")
    assert isinstance(accel, cl.ClusterScene) and accel.n_clusters == 80
    assert integ.maybe_build_accel(scene, "brute") is None
    assert integ.maybe_build_accel(scene, "auto", accel) is accel
    tables = integ.TraceTables(scene, CFG, accel=accel)
    assert tables.backend == "cluster" and tables.accel is accel
    # 80 clusters: below the auto thresholds, MT leaves and no sort
    assert not tables.cluster_sort and not tables.cluster_watertight
    tables = integ.TraceTables(scene, CFG.replace(cluster_rounds=2), "cluster", accel=accel)
    assert tables.backend == "cluster"
    assert integ.TraceTables(scene, CFG, "bvh").backend == "bvh"


def _camera_wavefront(host, camera, n=256):
    rs = np.random.RandomState(0)
    w, h = camera.resolution
    px = rs.randint(0, w, n).astype(np.int32)
    py = rs.randint(0, h, n).astype(np.int32)
    ro, rd = (np.asarray(x) for x in generate_rays_jax(
        camera, jnp.asarray(px), jnp.asarray(py), jnp.uint32(1), seed=CFG.seed))
    return ro, rd, (py * w + px).astype(np.uint32)


def _mismatched_rays(a, b):
    return int((~np.isclose(a, b, rtol=1e-4, atol=1e-6).all(axis=1)).sum())


def test_trace_reference_cluster_matches_jax(terrain, clusters):
    """One wavefront of 256 camera rays at 4 bounces through backend
    "cluster" (MT leaves), against the JAX integrator's "cluster" backend
    and the float32 NumPy oracle: equal ray counts, <= 2% of rays apart,
    the port no further from the oracle than JAX (ROADMAP §C)."""
    host, camera = terrain
    cs, cs_j = clusters
    ro, rd, pixel = _camera_wavefront(host, camera)
    scene_j = jax.tree.map(jnp.asarray, host)
    tables_j = integ_jax.TraceTables(scene_j, CFG_JAX, "cluster", accel=cs_j)
    rad_j, n_j = integ_jax.trace_reference(
        scene_j, CFG_JAX, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(pixel),
        jnp.uint32(1), CFG.seed, tables=tables_j, with_stats=True)
    scene_t, _ = to_device(host, camera, "cpu")
    kc.reset_counters()
    rad, n = integ.trace_reference(
        scene_t, CFG, torch.from_numpy(ro.copy()), torch.from_numpy(rd.copy()),
        torch.from_numpy(pixel.astype(np.int64)), 1, CFG.seed,
        tables=integ.TraceTables(scene_t, CFG, "cluster", accel=cs), with_stats=True)
    assert kc.closest_hit.twin_calls == 4 and kc.occluded.twin_calls == 4
    kc.reset_counters()
    assert float(n) == float(n_j) > 256
    rad, rad_j = rad.numpy(), np.asarray(rad_j)
    assert float(rad_j.max()) > 0.05
    assert _mismatched_rays(rad, rad_j) <= 0.02 * 256
    rad_np = np.array([ref.trace_reference(host, CFG, ro[i], rd[i], int(pixel[i]), 1,
                                           CFG.seed, np.float32) for i in range(256)])
    assert _mismatched_rays(rad, rad_np) <= _mismatched_rays(rad_j, rad_np)


@pytest.mark.parametrize("watertight", [False, True])
def test_render_image_cluster_matches_jax(terrain, clusters, watertight):
    """render_image, 16x16, 2 spp, backend "cluster" against the JAX
    package's: > 95% of pixels close, median |diff| < 1e-5."""
    host, camera = terrain
    cs, cs_j = clusters
    camera = camera._replace(resolution=(16, 16))
    cfg = CFG.replace(cluster_watertight=watertight)
    scene_t, cam_t = to_device(host, camera, "cpu")
    img = integ.render_image(scene_t, cam_t, cfg, backend="cluster", accel=cs).numpy()
    img_j = np.asarray(integ_jax.render_image(
        jax.tree.map(jnp.asarray, host), camera,
        CFG_JAX.replace(cluster_watertight=watertight), backend="cluster", accel=cs_j))
    assert img.shape == (16, 16, 3) and np.isfinite(img).all() and img.max() > 0.05
    close = np.isclose(img, img_j, rtol=1e-3, atol=1e-4)
    assert close.mean() > 0.95
    assert np.median(np.abs(img - img_j)) < 1e-5


@pytest.mark.parametrize("backend", ["cluster", "auto"])
def test_progressive_renderer_builds_accel_and_matches_render_image(terrain, backend):
    """ProgressiveRenderer on an 8k-triangle scene builds the accelerator of
    its backend before the first pass (backend "cluster": a ClusterScene;
    "auto" on the CPU: a FlatBVH, backend "bvh"); its film equals
    render_image's image."""
    from pyrenderer_tpu_torch.accel.bvh import FlatBVH

    host, camera = terrain
    scene, cam = to_device(host, camera._replace(resolution=(8, 8)), "cpu")
    cfg = CFG.replace(spp=1)
    renderer = ProgressiveRenderer(scene, cam, cfg, backend=backend)
    expected = {"cluster": ("cluster", cl.ClusterScene), "auto": ("bvh", FlatBVH)}[backend]
    assert renderer.backend == expected[0]
    assert isinstance(renderer.accel, expected[1])
    film = renderer.run(quiet=True)
    img = integ.render_image(scene, cam, cfg, backend=backend, accel=renderer.accel).numpy()
    np.testing.assert_allclose(film.hdr, img, rtol=1e-6, atol=1e-7)


def test_cluster_sort_is_invisible_in_the_image(terrain, monkeypatch):
    """The per-query coherence sort (cluster_sort=True: each cluster query
    sorts its rays and scatters the results back) gives every pixel the
    radiance of cluster_sort=False on one ClusterScene, bit for bit, both
    estimators. Two suspend/resume rounds put the closest-hit query through
    the sorted operands on the CPU too; the sort is seen to reorder rays."""
    host, camera = terrain
    scene, cam = to_device(host, camera._replace(resolution=(24, 24)), "cpu")
    cfg = CFG.replace(spp=2, max_bounces=3, cluster_rounds=2, cluster_budget=2)
    accel = cl.build_clusters(host.vertices, host.faces)
    perms = []
    prepare = kc._prepare

    def recording_prepare(*args):
        rays, perm = prepare(*args)
        perms.append(perm)
        return rays, perm

    monkeypatch.setattr(kc, "_prepare", recording_prepare)
    for estimator in ("reference", "pbrt"):
        imgs = {}
        for sort in (True, False):
            c = cfg.replace(estimator=estimator, cluster_sort=sort)
            tables = integ.TraceTables(scene, c, "cluster", accel)
            assert tables.cluster_sort is sort
            perms.clear()
            imgs[sort] = integ.render_image(scene, cam, c, backend="cluster", accel=accel)
            moved = [p for p in perms if p is not None and not torch.equal(
                p, torch.arange(p.shape[0]))]
            assert bool(moved) is sort and len(perms) == 2 * c.max_bounces
        assert imgs[False].max() > 0
        assert torch.equal(imgs[True], imgs[False])


def test_build_runs_one_nvcc_per_source_then_links(tmp_path, monkeypatch):
    """build() starts one nvcc per csrc/*.cu (-c, the shared flags), all
    before waiting on any, then links the objects into one library. Here
    nvcc is a stand-in script that logs its arguments and writes its -o."""
    from pyrenderer_tpu_torch.kernels import build

    log = tmp_path / "calls.txt"
    fake = tmp_path / "nvcc"
    fake.write_text(
        f"#!{sys.executable}\nimport sys\n"
        f"open({str(log)!r}, 'a').write(' '.join(sys.argv[1:]) + '\\n')\n"
        "open(sys.argv[sys.argv.index('-o') + 1], 'w').close()\n")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "find_nvcc", lambda: str(fake))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    lib = build.build()
    calls = log.read_text().splitlines()
    compiles = [c for c in calls if " -c " in c]
    assert sorted(c.split(" -c ")[1].split()[0].rsplit("/", 1)[1] for c in compiles) \
        == ["binned.cu", "cluster.cu", "film.cu", "intersect.cu", "kernelbench.cu", "pbrt.cu",
            "reference.cu", "rng.cu"]
    assert all(c.startswith(" ".join(build.NVCC_FLAGS)) for c in compiles)
    (link,) = [c for c in calls if " -c " not in c]
    assert "-shared" in link and link.count(".o") == 8
    assert os.path.exists(lib) and build.build() == lib   # reused by digest
    assert len(log.read_text().splitlines()) == 9


@pytest.mark.cuda
def test_cluster_kernels_match_twins_on_gpu(clusters):
    """On a CUDA device: both cluster kernels against their twins, MT and
    watertight, sort off and on, on 2^14 random rays (a third dead, t1 =
    0.5 elsewhere), one ray, five rays (a block holds four) and a dead
    wavefront: the closest hit's t and slot equal to the twin's, its face
    too, and the occlusion equal to the twin's hit mask (run on the card
    with `python -m pytest tests/test_torch_cluster.py -m cuda`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    cs = clusters[0].to(dev)
    ro, rd = (torch.from_numpy(a).to(dev) for a in _random_rays(1 << 14, 0))
    t1 = torch.where(torch.arange(1 << 14, device=dev) % 3 == 0, 0.0, 0.5)
    sets = {"random": (ro, rd, t1), "one": (ro[:1], rd[:1], T1),
            "five": (ro[:5], rd[:5], T1),
            "dead": (ro[:256], rd[:256], torch.zeros(256, device=dev))}
    for label, (ro, rd, t1) in sets.items():
        for watertight in (False, True):
            h_r, t_r, slot_r = cl.closest_hit_ref(cs, ro, rd, T0, t1, watertight=watertight)
            occ_r = cl.occluded_ref(cs, ro, rd, T0, t1, watertight=watertight)
            for sort in (False, True):
                h, t, face = kc.closest_hit(cs, ro, rd, T0, t1, sort=sort,
                                            watertight=watertight, exact_t=False)
                assert torch.equal(h, h_r) and torch.equal(t, t_r), (label, watertight, sort)
                assert torch.equal(face, cl.slot_to_face(cs, slot_r).to(torch.int32))
                ops = kc._operands(cs, ro, rd, t1, sort)
                t_k = torch.empty(ro.shape[0], device=dev)
                slot = torch.empty(ro.shape[0], dtype=torch.int32, device=dev)
                kc._launch(kc.closest_hit, cs, ops, T0, watertight, (t_k, slot))
                assert torch.equal(kc._unsort(slot, ops[1]), slot_r), (label, watertight, sort)
                assert torch.equal(kc.occluded(cs, ro, rd, T0, t1, sort=sort,
                                               watertight=watertight), occ_r)
    assert label == "dead" and not h_r.any()
    kc.reset_counters()
