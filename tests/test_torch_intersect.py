"""pyrenderer_tpu_torch intersection: the CUDA kernels' plain twins against the
TPU kernels (Pallas interpret mode) and the brute backend."""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyrenderer_tpu.kernels import pallas_intersect as pk
from pyrenderer_tpu.ref import scalar as ref
from pyrenderer_tpu.scene.types import Scene
from pyrenderer_tpu.scene.tungsten import load_tungsten
from pyrenderer_tpu_torch.core import intersect as isect
from pyrenderer_tpu_torch.kernels import intersect as ki
from pyrenderer_tpu_torch.scene import to_device

torch.set_num_threads(2)


SPHERES_JSON = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "scenes", "spheres.json")


def _load(path):
    host, camera, _ = load_tungsten(path, dtype=np.float32)
    scene_t, _ = to_device(host, camera, "cpu", torch.float32)
    return jax.tree.map(jnp.asarray, host), scene_t


@pytest.fixture(scope="module")
def scenes(cornell_path):
    return _load(cornell_path)


@pytest.fixture(scope="module")
def spheres():
    """The spheres scene: 3,852 triangles, above the TPU kernels' unrolled
    64 (their fori_loop branch) and above a 512-triangle tile."""
    return _load(SPHERES_JSON)


def _random_rays(n, seed=0):
    """The rays of tests/test_pallas.py."""
    rs = np.random.RandomState(seed)
    ro = rs.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    ro[:, 1] += 1.0
    rd = rs.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro, rd


def _oracle_t(scene_j, ro, rd, t1):
    """Per-ray closest-hit t of the float32 NumPy oracle (0 on a miss)."""
    host = Scene(*[np.asarray(x) for x in scene_j])
    t1s = np.broadcast_to(np.asarray(t1, np.float32), (ro.shape[0],))
    return np.array([ref.intersect_ray(host, ro[i], rd[i], 1e-5, t1s[i])[1]
                     for i in range(ro.shape[0])], np.float32)


def _t1_cases(n):
    dead = np.where(np.arange(n) % 3 == 0, 0.0, 1e5).astype(np.float32)
    return {"scalar": 1e5, "per_ray_half": np.full(n, 0.5, np.float32), "dead_lanes": dead}


@pytest.mark.parametrize("n, t1_case", [
    (1000, "scalar"), (100, "scalar"), (1000, "per_ray_half"), (1000, "dead_lanes")])
def test_twins_match_pallas_interpret(scenes, n, t1_case):
    """closest_hit_ref / occluded_ref against the TPU kernels run in interpret
    mode: hit masks equal, faces equal on >= 0.995 of hits, occluded equal,
    and the miss contract tri = -1, t = 0.

    t is held at rtol 1e-5 against the unfused float32 NumPy oracle
    (ref/scalar.intersect_ray, the same operation order) and against the
    interpret-mode kernel. XLA:CPU contracts a*b + c into FMAs there
    (perf/RESULTS.md, "Watertight edge fallback"), which moves t by a few
    ulp of the largest product; where that exceeds rtol 1e-5 (a hit at
    small t whose dot product cancels), the twin must equal the oracle
    bit for bit."""
    _check_twins_against_interpret(*scenes, n, t1_case)


@pytest.mark.parametrize("t1_case", ["scalar", "per_ray_half", "dead_lanes"])
def test_twins_match_pallas_interpret_spheres(spheres, t1_case):
    """As test_twins_match_pallas_interpret, on the spheres table (T =
    3,852): the TPU kernels' fori_loop branch (pallas_intersect.py:95-105),
    256 rays, the same tolerances."""
    _check_twins_against_interpret(*spheres, 256, t1_case)


def _check_twins_against_interpret(scene_j, scene_t, n, t1_case):
    ro, rd = _random_rays(n, seed=n)
    t1 = _t1_cases(n)[t1_case]
    table_j = pk.pack_triangles(scene_j.vertices, scene_j.faces)
    t1_j = t1 if np.isscalar(t1) else jnp.asarray(t1)
    h_j, t_j, tri_j = (np.asarray(x) for x in pk.closest_hit(
        table_j, jnp.asarray(ro), jnp.asarray(rd), 1e-5, t1_j, interpret=True))
    o_j = np.asarray(pk.occluded(table_j, jnp.asarray(ro), jnp.asarray(rd), 1e-5, t1_j,
                                 interpret=True))

    table = ki.pack_triangles(scene_t.vertices, scene_t.faces)
    assert np.array_equal(table.numpy(), np.asarray(table_j))
    t1_t = t1 if np.isscalar(t1) else torch.from_numpy(t1)
    h, t, tri = (x.numpy() for x in ki.closest_hit_ref(
        table, torch.from_numpy(ro), torch.from_numpy(rd), 1e-5, t1_t))
    o = ki.occluded_ref(table, torch.from_numpy(ro), torch.from_numpy(rd), 1e-5, t1_t).numpy()

    assert h.shape == (n,) and tri.dtype == np.int32
    assert np.array_equal(h, h_j)
    same = (tri == tri_j) & h
    assert same[h].mean() >= 0.995
    t_np = _oracle_t(scene_j, ro, rd, t1)
    np.testing.assert_allclose(t[h], t_np[h], rtol=1e-5)
    fused = same & ~np.isclose(t, t_j, rtol=1e-5, atol=0.0)
    assert np.array_equal(t[fused], t_np[fused])
    assert np.array_equal(o, o_j)
    assert np.all(tri[~h] == -1) and np.all(t[~h] == 0)
    if t1_case == "dead_lanes":
        assert not h[np.arange(n) % 3 == 0].any()


def test_duplicate_triangles_resolve_to_the_lower_face(spheres):
    """Exact duplicate triangles where a lane split or a tile would separate
    them (faces 0/1, 31/32, 255/256, 511/512, first/last; perf/clusterbench
    whole_table_duplicates): the twin and the interpret-mode TPU kernel
    both return the source, the lower face, on every ray aimed into one."""
    from pyrenderer_tpu_torch.perf.clusterbench import WHOLE_DUPLICATES, whole_table_duplicates

    _, scene_t = spheres
    table = ki.pack_triangles(scene_t.vertices, scene_t.faces)
    n_tris = table.shape[1]
    assert n_tris > 512
    dup, ro, rd = whole_table_duplicates(table.numpy())
    h, t, tri = (x.numpy() for x in ki.closest_hit_ref(
        torch.from_numpy(dup), torch.from_numpy(ro), torch.from_numpy(rd), 1e-5, 1e5))
    h_j, t_j, tri_j = (np.asarray(x) for x in pk.closest_hit(
        jnp.asarray(dup), jnp.asarray(ro), jnp.asarray(rd), 1e-5, 1e5, interpret=True))
    sources = {src for src, _ in WHOLE_DUPLICATES}
    # nine rays aimed into each source (a ray may find the scene in front)
    aimed = np.repeat([src for src, _ in WHOLE_DUPLICATES], 9)
    assert h.all() and h_j.all()
    assert np.array_equal(tri, tri_j)
    assert set(tri.tolist()) <= sources
    assert (tri == aimed).mean() >= 0.8
    copies = [dst % n_tris for _, dst in WHOLE_DUPLICATES]
    assert not np.isin(tri, copies).any()
    assert np.array_equal(ki.occluded_ref(torch.from_numpy(dup), torch.from_numpy(ro),
                                          torch.from_numpy(rd), 1e-5, 1e5).numpy(), h)


@pytest.mark.parametrize("dead_t1", [0.0, 1e-6, float("nan")])
def test_dead_t1_misses(scenes, dead_t1):
    """A ray with t1 = 0, t1 below t0 or t1 = NaN accepts no triangle under
    t0 < t < t1 (the kernels skip it): a miss (tri = -1, t = 0, not
    occluded) in the twin and in the interpret-mode TPU kernel, every other
    ray as the interpret-mode kernel finds it."""
    scene_j, scene_t = scenes
    n = 300
    ro, rd = _random_rays(n, seed=7)
    dead = np.arange(n) % 3 == 0
    t1 = np.where(dead, np.float32(dead_t1), np.float32(1e5)).astype(np.float32)
    table = ki.pack_triangles(scene_t.vertices, scene_t.faces)
    args = (torch.from_numpy(ro), torch.from_numpy(rd), 1e-5, torch.from_numpy(t1))
    h, t, tri = (x.numpy() for x in ki.closest_hit_ref(table, *args))
    o = ki.occluded_ref(table, *args).numpy()
    table_j = pk.pack_triangles(scene_j.vertices, scene_j.faces)
    args_j = (jnp.asarray(ro), jnp.asarray(rd), 1e-5, jnp.asarray(t1))
    h_j, t_j, tri_j = (np.asarray(x) for x in pk.closest_hit(table_j, *args_j, interpret=True))
    o_j = np.asarray(pk.occluded(table_j, *args_j, interpret=True))
    for hit, tt, face, occ in ((h, t, tri, o), (h_j, t_j, tri_j, o_j)):
        assert not hit[dead].any() and not occ[dead].any()
        assert np.all(face[dead] == -1) and np.all(tt[dead] == 0)
    assert h[~dead].any()
    assert np.array_equal(h, h_j) and np.array_equal(o, o_j)


def test_brute_matches_twin_and_keeps_its_miss_contract(scenes):
    """The brute backend agrees with the kernel twin on hits; on a miss it
    returns tri = argmin = 0 (core/intersect.py:84), the twin -1."""
    _, scene_t = scenes
    ro, rd = (torch.from_numpy(a) for a in _random_rays(1000))
    h, t, tri = isect.intersect_brute(scene_t, ro, rd, 1e-5, 1e5)
    table = ki.pack_triangles(scene_t.vertices, scene_t.faces)
    h2, t2, tri2 = ki.closest_hit_ref(table, ro, rd, 1e-5, 1e5)
    assert torch.equal(h, h2)
    assert torch.equal(tri[h], tri2[h]) and torch.equal(t, t2)
    assert (~h).any() and bool((tri[~h] == 0).all()) and bool((tri2[~h] == -1).all())
    t1 = torch.full((1000,), 0.5)
    assert torch.equal(isect.occluded(scene_t, ro, rd, 1e-5, t1),
                       ki.occluded_ref(table, ro, rd, 1e-5, t1))


def test_cpu_wrappers_use_twins_and_count(scenes):
    """On CPU tensors the wrappers run the twins: no kernel launch is counted,
    each call is counted as a twin call."""
    _, scene_t = scenes
    ro, rd = (torch.from_numpy(a) for a in _random_rays(64))
    table = ki.pack_triangles(scene_t.vertices, scene_t.faces)
    ki.reset_counters()
    h, t, tri = ki.closest_hit(table, ro, rd, 1e-5, 1e5)
    o = ki.occluded(table, ro, rd, 1e-5, 1e5)
    assert ki.closest_hit.launches == 0 and ki.occluded.launches == 0
    assert ki.closest_hit.twin_calls == 1 and ki.occluded.twin_calls == 1
    h2, _, tri2 = ki.closest_hit_ref(table, ro, rd, 1e-5, 1e5)
    assert torch.equal(h, h2) and torch.equal(tri, tri2)
    assert torch.equal(o, h)  # occluded over (t0, t1) is "any hit"
    ki.reset_counters()


def test_wrappers_reject_other_devices(scenes):
    _, scene_t = scenes
    ro = torch.zeros((4, 3), device="meta")
    table = ki.pack_triangles(scene_t.vertices, scene_t.faces)
    with pytest.raises(ValueError, match="no kernel"):
        ki.closest_hit(table, ro, ro, 1e-5, 1e5)
    with pytest.raises(ValueError, match="no kernel"):
        ki.occluded(table, ro, ro, 1e-5, 1e5)


def test_kernel_module_imports_without_nvcc():
    """Importing the kernel modules builds nothing: nvcc and the GPU are
    looked for only at the first launch."""
    src = os.path.join(os.path.dirname(ki.__file__), "build.py")
    with open(src) as fh:
        tree = ast.parse(fh.read())
    top_calls = [n for n in tree.body if isinstance(n, ast.Expr)
                 and isinstance(n.value, ast.Call)]
    assert top_calls == []
    from pyrenderer_tpu_torch.kernels import build

    assert build.NVCC_FLAGS.count("-fmad=false") == 1
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


@pytest.mark.cuda
def test_kernels_match_twins_on_gpu(scenes, spheres):
    """On a CUDA device: both kernels bit-equal to their twins on every ray
    (hit, t's bits, face, occluded), against the Cornell (36 triangles) and
    spheres (3,852) tables, and the spheres table with duplicates: 2^16
    random rays with scalar and per-ray t1, N = 1, 31, 33 and 129, all
    rays dead, every third ray dead (run on the card with
    `python -m pytest tests/test_torch_intersect.py -m cuda`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pyrenderer_tpu_torch.perf.clusterbench import whole_table_duplicates

    dev = torch.device("cuda")
    n = 1 << 16
    ro, rd = (torch.from_numpy(a).to(dev) for a in _random_rays(n))
    tables = [ki.pack_triangles(s.vertices, s.faces).to(dev) for _, s in (scenes, spheres)]
    dead = torch.where(torch.arange(n, device=dev) % 3 == 0, 0.0, 1e5).float()
    cases = []
    for table in tables:
        cases += [(table, ro, rd, 1e5), (table, ro, rd, torch.full((n,), 0.5, device=dev)),
                  (table, ro, rd, dead)]
        cases += [(table, ro[:m], rd[:m], 1e5) for m in (1, 31, 33, 129)]
        cases.append((table, ro[:4096], rd[:4096], torch.zeros(4096, device=dev)))
    dup, dro, drd = whole_table_duplicates(tables[1].cpu().numpy())
    cases.append((torch.from_numpy(dup).to(dev), torch.from_numpy(dro).to(dev),
                  torch.from_numpy(drd).to(dev), 1e5))
    for table, r_o, r_d, t1 in cases:
        h, t, tri = ki.closest_hit(table, r_o, r_d, 1e-5, t1)
        o = ki.occluded(table, r_o, r_d, 1e-5, t1)
        h2, t2, tri2 = ki.closest_hit_ref(table, r_o, r_d, 1e-5, t1)
        o2 = ki.occluded_ref(table, r_o, r_d, 1e-5, t1)
        assert torch.equal(h, h2) and torch.equal(tri, tri2) and torch.equal(o, o2)
        assert torch.equal(t.view(torch.int32), t2.view(torch.int32))
