"""pyrenderer_tpu_torch BVH (backend "bvh"): the builds and the traversal
against the JAX package (tests/test_bvh.py), and CPU "auto" past 4096
triangles resolving to it, as the JAX package resolves off the TPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyrenderer_tpu.accel import bvh as bvh_jax
from pyrenderer_tpu.config import RenderConfig as JaxConfig
from pyrenderer_tpu.core import integrator as integ_jax
from pyrenderer_tpu_torch.accel import bvh as bvh_mod
from pyrenderer_tpu_torch.config import RenderConfig
from pyrenderer_tpu_torch.core import integrator as integ
from pyrenderer_tpu_torch.core import intersect as isect
from pyrenderer_tpu_torch.scene import procgen, to_device
from pyrenderer_tpu_torch.scene.tungsten import build_scene
from tests.test_bvh import make_sphere_mesh
from tests.torch_fixtures import private_jax_native_cache  # noqa: F401 (autouse)

torch.set_num_threads(2)

T0, T1 = 1e-5, 1e5
FIELDS = ("bbox_min", "bbox_max", "first", "count", "escape", "order")


def _arrays_equal(ours, theirs):
    assert ours.n_nodes == theirs.n_nodes and ours.leaf_size == theirs.leaf_size
    for name in FIELDS:
        a, b = getattr(ours, name).numpy(), np.asarray(getattr(theirs, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def _tris(bvh, verts, faces):
    """Triangles in traversal order, as TraceTables makes them."""
    v = torch.as_tensor(verts, dtype=torch.float32)
    ordered = torch.as_tensor(faces)[bvh.order.long()].long()
    v0 = v[ordered[:, 0]]
    return v0, v[ordered[:, 1]] - v0, v[ordered[:, 2]] - v0


def _tris_jax(bvh, verts, faces):
    v = jnp.asarray(verts, jnp.float32)
    ordered = jnp.asarray(faces)[bvh.order]
    v0 = v[ordered[:, 0]]
    return v0, v[ordered[:, 1]] - v0, v[ordered[:, 2]] - v0


@pytest.mark.parametrize("mesh", ["sphere", "terrain"])
def test_lbvh_arrays_match_jax(mesh):
    """build_lbvh gives the JAX package's node arrays bit for bit; its
    leaves cover every triangle once and escapes point forward."""
    verts, faces = make_sphere_mesh(8, 12) if mesh == "sphere" else procgen.terrain(res=12)
    ours = bvh_mod.build_lbvh(verts, faces)
    _arrays_equal(ours, bvh_jax.build_lbvh(verts, faces))
    count, first, escape = ours.count.numpy(), ours.first.numpy(), ours.escape.numpy()
    covered = sorted(i for n in range(ours.n_nodes) if count[n] > 0
                     for i in range(first[n], first[n] + count[n]))
    assert covered == list(range(faces.shape[0]))
    assert escape[0] == -1 and all(e == -1 or e > i for i, e in enumerate(escape))


def test_sah_arrays_match_jax():
    """The native SAH build (the port's copy of bvh_builder.cpp) gives the
    JAX package's arrays bit for bit; method="sah" never falls back."""
    verts, faces = make_sphere_mesh(16, 24)
    ours = bvh_mod.build_bvh(verts, faces, method="sah")
    _arrays_equal(ours, bvh_jax.build_bvh(verts, faces, method="sah"))
    _arrays_equal(bvh_mod.build_bvh(verts, faces), bvh_jax.build_bvh(verts, faces))


@pytest.mark.parametrize("method", ["lbvh", "sah"])
def test_traverse_matches_jax(method):
    """traverse, closest and any hit, on 512 random rays against the JAX
    traversal on the same tree: equal hit masks and occlusion, faces on
    >= 99.5% of hits, t at rtol 1e-5; and against the brute-force test."""
    verts, faces = make_sphere_mesh(16, 24)
    ours = bvh_mod.build_bvh(verts, faces, method=method)
    theirs = bvh_jax.build_bvh(verts, faces, method=method)
    rs = np.random.RandomState(0)
    ro = rs.uniform(-2, 2, (512, 3)).astype(np.float32)
    rd = rs.normal(size=(512, 3))
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    t1_ray = rs.uniform(0.2, 3.0, 512).astype(np.float32)
    ro_t, rd_t = torch.from_numpy(ro), torch.from_numpy(rd)
    for t1, t1_j in ((T1, T1), (torch.from_numpy(t1_ray), jnp.asarray(t1_ray))):
        h, t, f = (x.numpy() for x in bvh_mod.traverse(ours, *_tris(ours, verts, faces), ro_t,
                                                       rd_t, T0, t1))
        h_j, t_j, f_j = (np.asarray(x) for x in bvh_jax.traverse(
            theirs, *_tris_jax(theirs, verts, faces), jnp.asarray(ro), jnp.asarray(rd), T0,
            t1_j))
        assert h.any() and np.array_equal(h, h_j)
        assert f.dtype == np.int32 and (f[h] == f_j[h]).mean() >= 0.995
        np.testing.assert_allclose(t[h], t_j[h], rtol=1e-5)
        assert np.all(t[~h] == 0) and np.all(f[~h] == 0)
        occ = bvh_mod.traverse(ours, *_tris(ours, verts, faces), ro_t, rd_t, T0, t1,
                               any_hit=True)[0].numpy()
        occ_j = np.asarray(bvh_jax.traverse(theirs, *_tris_jax(theirs, verts, faces),
                                            jnp.asarray(ro), jnp.asarray(rd), T0, t1_j,
                                            any_hit=True)[0])
        assert np.array_equal(occ, occ_j) and np.array_equal(occ, h)
    v = torch.as_tensor(verts, dtype=torch.float32)
    f64 = torch.as_tensor(faces).long()
    v0 = v[f64[:, 0]]
    h_b, t_b, _ = isect.intersect_brute_arrays(v0, v[f64[:, 1]] - v0, v[f64[:, 2]] - v0, ro_t,
                                               rd_t, T0, T1)
    h, t, _ = bvh_mod.traverse(ours, *_tris(ours, verts, faces), ro_t, rd_t, T0, T1)
    assert torch.equal(h, h_b)
    torch.testing.assert_close(t[h], t_b[h], rtol=1e-5, atol=1e-6)


def test_cpu_auto_resolves_bvh_and_render_matches_jax():
    """CPU "auto" on terrain8k (past AUTO_BRUTE_MAX_TRIS) builds a FlatBVH
    and resolves to "bvh", as the JAX package does off the TPU (CUDA "auto"
    resolves to "cluster"); its 16x16 render matches the JAX package's CPU
    "auto" render: > 95% of pixels close, median |diff| < 1e-5."""
    host, camera, _ = build_scene(procgen.big_scene_data("terrain", res=64))
    n = host.faces.shape[0]
    assert n > integ.AUTO_BRUTE_MAX_TRIS
    assert integ.resolve_backend("auto", n, "cpu") == "bvh"
    assert integ.resolve_backend("auto", n, "cuda:0") == "cluster"
    camera = camera._replace(resolution=(16, 16))
    scene, cam = to_device(host, camera, "cpu")
    cfg = RenderConfig(max_bounces=3, spp=1, seed=3, estimator="reference")
    tables = integ.TraceTables(scene, cfg)
    assert tables.backend == "bvh" and isinstance(tables.accel, bvh_mod.FlatBVH)
    img = integ.render_image(scene, cam, cfg).numpy()
    img_j = np.asarray(integ_jax.render_image(
        jax.tree.map(jnp.asarray, host), camera,
        JaxConfig(max_bounces=3, spp=1, seed=3, estimator="reference")))
    assert np.isfinite(img).all() and img.max() > 0.05
    assert np.isclose(img, img_j, rtol=1e-3, atol=1e-4).mean() > 0.95
    assert np.median(np.abs(img - img_j)) < 1e-5
