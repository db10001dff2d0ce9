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


@pytest.fixture(scope="module")
def scenes(cornell_path):
    host, camera, _ = load_tungsten(cornell_path, dtype=np.float32)
    scene_t, _ = to_device(host, camera, "cpu", torch.float32)
    return jax.tree.map(jnp.asarray, host), scene_t


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
    scene_j, scene_t = scenes
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
def test_kernels_match_twins_on_gpu(scenes):
    """On a CUDA device: both kernels against their twins (run on the card
    with `python -m pytest tests/test_torch_intersect.py -m cuda`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, scene_t = scenes
    dev = torch.device("cuda")
    ro, rd = (torch.from_numpy(a).to(dev) for a in _random_rays(1 << 16))
    table = ki.pack_triangles(scene_t.vertices, scene_t.faces).to(dev)
    for t1 in (1e5, torch.full((1 << 16,), 0.5, device=dev)):
        h, t, tri = ki.closest_hit(table, ro, rd, 1e-5, t1)
        h2, t2, tri2 = ki.closest_hit_ref(table, ro, rd, 1e-5, t1)
        assert torch.equal(h, h2)
        same = (tri == tri2) & h
        assert float(same[h].float().mean()) >= 0.995
        torch.testing.assert_close(t[same], t2[same], rtol=1e-5, atol=0.0)
        assert torch.equal(ki.occluded(table, ro, rd, 1e-5, t1),
                           ki.occluded_ref(table, ro, rd, 1e-5, t1))
