"""pyrenderer_tpu_torch chunked sweep (backend "cluster_chunked"): the
ClusterChunks build, the chunk-by-chunk queries and the render, against the
JAX package (tests/test_cluster.py:405-473)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyrenderer_tpu.accel import clusters as clj
from pyrenderer_tpu.config import RenderConfig as JaxConfig
from pyrenderer_tpu.core import integrator as integ_jax
from pyrenderer_tpu.kernels import pallas_cluster as pc
from pyrenderer_tpu_torch.accel import clusters as cl
from pyrenderer_tpu_torch.config import RenderConfig
from pyrenderer_tpu_torch.core import integrator as integ
from pyrenderer_tpu_torch.kernels import cluster as kc
from pyrenderer_tpu_torch.scene import procgen, to_device
from pyrenderer_tpu_torch.scene.tungsten import build_scene
from tests.torch_fixtures import private_jax_native_cache  # noqa: F401 (autouse)

torch.set_num_threads(2)

T0, T1 = 1e-5, 1e5
MAX_TRIS = 4096


@pytest.fixture(scope="module")
def chunked():
    """terrain8k (8,204 triangles) cut at 4,096: three chunks, the port's
    and the JAX package's."""
    host, camera, _ = build_scene(procgen.big_scene_data("terrain", res=64))
    cc = cl.build_chunked_clusters(host.vertices, host.faces, max_tris=MAX_TRIS)
    cc_j = clj.build_chunked_clusters(np.asarray(host.vertices), np.asarray(host.faces),
                                      max_tris=MAX_TRIS)
    return host, camera, cc, cc_j


def _random_rays(n, seed):
    rs = np.random.RandomState(seed)
    ro = rs.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    ro[:, 1] += 1.0
    rd = rs.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro, rd


def test_chunk_tables_match_jax(chunked):
    """Three chunks of equal size (the last padded with zero faces) whose
    tables equal the JAX build's; one chunk's worth of faces gives a plain
    ClusterScene; .to() moves every chunk."""
    host, _, cc, cc_j = chunked
    assert isinstance(cc, cl.ClusterChunks) and len(cc.chunks) == 3
    assert cc.faces_per_chunk == cc_j.faces_per_chunk == -(-host.faces.shape[0] // 3)
    assert cc.n_clusters == cc_j.n_clusters
    for cs, cs_j in zip(cc.chunks, cc_j.chunks):
        k = cs.n_clusters
        for name in ("tri", "bin_box", "super_box", "super_cols", "order", "world_lo",
                     "world_inv_span"):
            np.testing.assert_array_equal(getattr(cs, name).numpy(),
                                          np.asarray(getattr(cs_j, name)), err_msg=name)
        np.testing.assert_array_equal(cs.child_box.numpy(), np.asarray(cs_j.child_box)[:k])
    assert isinstance(cl.build_chunked_clusters(host.vertices, host.faces), cl.ClusterScene)
    moved = cc.to(torch.device("cpu"))
    assert isinstance(moved, cl.ClusterChunks) and moved.faces_per_chunk == cc.faces_per_chunk
    assert all(torch.equal(a.tri, b.tri) for a, b in zip(moved.chunks, cc.chunks))


@pytest.mark.parametrize("watertight", [False, True])
def test_chunked_queries_match_jax(chunked, watertight):
    """closest_hit_chunked and occluded_chunked against the JAX package's
    (its twins per chunk) on 384 random rays, scalar and per-ray t1: equal
    hit masks, global faces and t on every ray (faces >= 0.995 of hits where
    an exact tie may fall either way), equal occlusion; rounds=2 gives the
    one-pass result bit for bit."""
    _, _, cc, cc_j = chunked
    ro, rd = _random_rays(384, 1)
    t1_ray = np.random.RandomState(1).uniform(0.1, 3.0, 384).astype(np.float32)
    ro_t, rd_t = torch.from_numpy(ro), torch.from_numpy(rd)
    for t1, t1_j in ((T1, T1), (torch.from_numpy(t1_ray), jnp.asarray(t1_ray))):
        h, t, f = (x.numpy() for x in kc.closest_hit_chunked(cc, ro_t, rd_t, T0, t1,
                                                             watertight=watertight))
        h_j, t_j, f_j = (np.asarray(x) for x in pc.closest_hit_chunked(
            cc_j, jnp.asarray(ro), jnp.asarray(rd), T0, t1_j, watertight=watertight))
        assert h.any() and np.array_equal(h, h_j)
        assert (f[h] == f_j[h]).mean() >= 0.995
        np.testing.assert_allclose(t[h], t_j[h], rtol=1e-5)
        assert np.all(t[~h] == 0) and np.all(f[~h] == 0)
        occ = kc.occluded_chunked(cc, ro_t, rd_t, T0, t1, watertight=watertight).numpy()
        occ_j = np.asarray(pc.occluded_chunked(cc_j, jnp.asarray(ro), jnp.asarray(rd), T0, t1_j,
                                               watertight=watertight))
        assert np.array_equal(occ, occ_j) and np.array_equal(occ, h)
        h2, t2, f2 = (x.numpy() for x in kc.closest_hit_chunked(
            cc, ro_t, rd_t, T0, t1, watertight=watertight, rounds=2, budget=1))
        assert np.array_equal(h2, h) and np.array_equal(t2, t) and np.array_equal(f2, f)
    kc.reset_counters()


def test_chunked_routing_and_render_match_jax(chunked):
    """A ClusterChunks routes "auto", "cluster" and "cluster_chunked" to
    "cluster_chunked" (a ClusterScene routes "cluster_chunked" to
    "cluster"), its sort is off under "auto", and its 16x16 render matches
    the JAX package's (> 95% of pixels close, median |diff| < 1e-5) and the
    monolithic "cluster" render."""
    host, camera, cc, cc_j = chunked
    n = host.faces.shape[0]
    for backend in ("auto", "cluster", "cluster_chunked"):
        assert integ.resolve_backend(backend, n, "cpu", cc) == "cluster_chunked"
    cs = cl.build_clusters(host.vertices, host.faces)
    assert integ.resolve_backend("cluster_chunked", n, "cpu", cs) == "cluster"
    assert integ.resolve_backend("cluster_chunked", n, "cpu") == "cluster_chunked"
    camera = camera._replace(resolution=(16, 16))
    scene, cam = to_device(host, camera, "cpu")
    assert isinstance(integ.maybe_build_accel(scene, "cluster_chunked"), cl.ClusterScene)
    cfg = RenderConfig(max_bounces=2, spp=1, seed=3, estimator="reference")
    tables = integ.TraceTables(scene, cfg, "cluster_chunked", accel=cc)
    assert tables.backend == "cluster_chunked" and not tables.cluster_sort
    assert not tables.cluster_watertight
    img = integ.render_image(scene, cam, cfg, backend="cluster_chunked", accel=cc).numpy()
    img_j = np.asarray(integ_jax.render_image(
        jax.tree.map(jnp.asarray, host), camera,
        JaxConfig(max_bounces=2, spp=1, seed=3, estimator="reference"),
        backend="cluster_chunked", accel=cc_j))
    img_mono = integ.render_image(scene, cam, cfg, backend="cluster", accel=cs).numpy()
    assert np.isfinite(img).all() and img.max() > 0.05
    assert np.isclose(img, img_j, rtol=1e-3, atol=1e-4).mean() > 0.95
    assert np.median(np.abs(img - img_j)) < 1e-5
    assert np.isclose(img, img_mono, rtol=1e-4, atol=1e-6).mean() > 0.99
