"""pyrenderer_tpu_torch large-scene path: the procgen scenes, the ClusterScene
build, the cluster-sweep kernels' plain twins against the JAX package (its
twin and its Pallas kernels in interpret mode), routing, and the "cluster"
backend end to end against the JAX integrator and the NumPy oracle."""

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
from pyrenderer_tpu_torch.kernels import cluster as kc
from pyrenderer_tpu_torch.render.driver import ProgressiveRenderer
from pyrenderer_tpu_torch.scene import procgen, to_device
from pyrenderer_tpu_torch.scene.tungsten import build_scene

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


def test_kernel_source_matches_twin_constants():
    """The constants written into csrc/leaf.cuh (shared by the sweep and the
    binned kernels) and csrc/binned.cu are the twins'."""
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
    assert int(const("kBin")) == cl.BIN and cl.BIN_TRIS == cl.BIN * cl.LANE_TRIS
    assert int(const("kThreads")) == kb._THREADS
    with open(os.path.join(csrc, "cluster.cu")) as fh:
        assert '#include "leaf.cuh"' in fh.read()


def test_routing_and_auto_policies(terrain):
    """"auto" picks the cluster sweep above AUTO_BRUTE_MAX_TRIS on the CPU
    and on CUDA; sort and watertight switch on at AUTO_SORT_MIN_CLUSTERS;
    suspend/resume rounds raise."""
    limit = integ.AUTO_BRUTE_MAX_TRIS
    for dev in ("cpu", "cuda:0"):
        assert integ.resolve_backend("auto", limit + 1, dev) == "cluster"
    assert integ.resolve_backend("auto", limit, "cpu") == "brute"
    assert integ.resolve_backend("auto", limit, "cuda:0") == "cuda"
    assert integ.resolve_backend("cluster", 36, "cpu") == "cluster"
    assert integ.resolve_backend("watertight", 10 ** 6, "cpu") == "watertight"
    for backend in ("bvh", "cluster_chunked"):
        with pytest.raises(NotImplementedError, match="A10"):
            integ.resolve_backend(backend, 10 ** 5, "cpu")

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
    accel = integ.maybe_build_accel(scene, "auto")
    assert isinstance(accel, cl.ClusterScene) and accel.n_clusters == 80
    assert integ.maybe_build_accel(scene, "brute") is None
    assert integ.maybe_build_accel(scene, "auto", accel) is accel
    tables = integ.TraceTables(scene, CFG, accel=accel)
    assert tables.backend == "cluster" and tables.accel is accel
    # 80 clusters: below the auto thresholds, MT leaves and no sort
    assert not tables.cluster_sort and not tables.cluster_watertight
    with pytest.raises(NotImplementedError, match="A10"):
        integ.TraceTables(scene, CFG.replace(cluster_rounds=2))


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


def test_progressive_renderer_builds_accel_and_matches_render_image(terrain):
    """ProgressiveRenderer with backend "auto" on an 8k-triangle scene
    resolves "cluster" and builds the ClusterScene before the first pass;
    its film equals render_image's image."""
    host, camera = terrain
    scene, cam = to_device(host, camera._replace(resolution=(8, 8)), "cpu")
    cfg = CFG.replace(spp=1)
    renderer = ProgressiveRenderer(scene, cam, cfg)
    assert renderer.backend == "cluster"
    assert isinstance(renderer.accel, cl.ClusterScene)
    film = renderer.run(quiet=True)
    img = integ.render_image(scene, cam, cfg, accel=renderer.accel).numpy()
    np.testing.assert_allclose(film.hdr, img, rtol=1e-6, atol=1e-7)


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
        == ["binned.cu", "cluster.cu", "intersect.cu", "kernelbench.cu"]
    assert all(c.startswith(" ".join(build.NVCC_FLAGS)) for c in compiles)
    (link,) = [c for c in calls if " -c " not in c]
    assert "-shared" in link and link.count(".o") == 4
    assert os.path.exists(lib) and build.build() == lib   # reused by digest
    assert len(log.read_text().splitlines()) == 5


@pytest.mark.cuda
def test_cluster_kernels_match_twins_on_gpu(clusters):
    """On a CUDA device: both cluster kernels against their twins, MT and
    watertight, sort off and on (run on the card with
    `python -m pytest tests/test_torch_cluster.py -m cuda`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    cs = clusters[0].to(dev)
    ro, rd = (torch.from_numpy(a).to(dev) for a in _random_rays(1 << 14, 0))
    t1 = torch.where(torch.arange(1 << 14, device=dev) % 3 == 0, 0.0, 0.5)
    for watertight in (False, True):
        h_r, t_r, slot_r = cl.closest_hit_ref(cs, ro, rd, T0, t1, watertight=watertight)
        occ_r = cl.occluded_ref(cs, ro, rd, T0, t1, watertight=watertight)
        for sort in (False, True):
            h, t, face = kc.closest_hit(cs, ro, rd, T0, t1, sort=sort,
                                        watertight=watertight, exact_t=False)
            assert torch.equal(h, h_r)
            same = (face == cl.slot_to_face(cs, slot_r)) & h
            assert int(same.sum()) >= 0.999 * int(h.sum())
            torch.testing.assert_close(t[same], t_r[same], rtol=1e-5, atol=0.0)
            assert torch.equal(kc.occluded(cs, ro, rd, T0, t1, sort=sort,
                                           watertight=watertight), occ_r)
