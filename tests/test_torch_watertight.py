"""pyrenderer_tpu_torch watertight test (core/watertight.py) against the JAX
package's, the shared-edge leak hunt on the twins, and backend
"watertight" end to end."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyrenderer_tpu.config import RenderConfig as JaxConfig
from pyrenderer_tpu.core import integrator as integ_jax
from pyrenderer_tpu.core import watertight as wt_jax
from pyrenderer_tpu.scene.tungsten import load_tungsten
from pyrenderer_tpu_torch.accel import clusters as cl
from pyrenderer_tpu_torch.config import RenderConfig
from pyrenderer_tpu_torch.core import integrator as integ
from pyrenderer_tpu_torch.core import watertight as wt
from pyrenderer_tpu_torch.scene import to_device
from pyrenderer_tpu_torch.scene.types import Scene

torch.set_num_threads(2)

N_EDGE = 4096


@pytest.fixture(scope="module")
def cornell(cornell_path):
    host, camera, _ = load_tungsten(cornell_path, dtype=np.float32)
    scene_t, _ = to_device(host, camera, "cpu")
    return host, jax.tree.map(jnp.asarray, host), scene_t


def _quad_scene():
    """The unit quad of tests/test_watertight.py, split along its diagonal
    (only the geometry fields are read)."""
    verts = torch.tensor([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], dtype=torch.float32)
    faces = torch.tensor([[0, 1, 2], [0, 2, 3]])
    return Scene(verts, faces, *([None] * (len(Scene._fields) - 2)))


def _edge_rays():
    """4096 rays straight down onto the shared diagonal x == y of the quad
    (tests/test_watertight.py:168-205)."""
    ts = np.linspace(1e-4, 1.0 - 1e-4, N_EDGE).astype(np.float32)
    ro = np.stack([ts, ts, np.ones_like(ts)], axis=1)
    rd = np.broadcast_to(np.asarray([0.0, 0.0, -1.0], np.float32), (N_EDGE, 3)).copy()
    return torch.from_numpy(ro), torch.from_numpy(rd)


def _skewed_edge_rays():
    """4096 rays from skewed origins through points of the diagonal
    (tests/test_watertight.py:150-165)."""
    a = np.linspace(0.001, 0.999, N_EDGE, dtype=np.float32)
    target = np.stack([a, a, np.zeros_like(a)], axis=1)
    ro = np.stack([a * 0.3 + 0.1, a * 0.7 + 0.05, np.full_like(a, 2.0)],
                  axis=1).astype(np.float32)
    rd = target - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return torch.from_numpy(ro), torch.from_numpy(rd)


def test_diff_of_products_and_edge_fn_match_jax():
    """Bit-equal to the JAX functions, on random operands and on products
    that cancel exactly or to within a few ulp (where the compensated
    recomputation takes over)."""
    rs = np.random.RandomState(0)
    a, b, c = (rs.uniform(-4, 4, 4096).astype(np.float32) for _ in range(3))
    d = (a * b / np.where(c == 0, 1, c)).astype(np.float32)   # a*b ~ c*d
    d[::4] = rs.uniform(-4, 4, 1024).astype(np.float32)
    a[:2], b[:2], c[:2], d[:2] = [1 + 2 ** -12, 3], [1 - 2 ** -12, 5], [1, 5], [1 - 2 ** -24, 3]
    args_t = [torch.from_numpy(x) for x in (a, b, c, d)]
    args_j = [jnp.asarray(x) for x in (a, b, c, d)]
    for ours, theirs in ((wt.diff_of_products, wt_jax.diff_of_products),
                         (wt.edge_fn, wt_jax.edge_fn)):
        assert np.array_equal(ours(*args_t).numpy(), np.asarray(theirs(*args_j)))
    exact = np.float64(a[0]) * np.float64(b[0]) - np.float64(c[0]) * np.float64(d[0])
    assert abs(float(wt.diff_of_products(*args_t)[0]) - exact) < 1e-12
    assert float(wt.edge_fn(*args_t)[1]) == 0.0  # 3*5 - 5*3 cancels exactly


def test_watertight_terms_match_jax():
    """(valid, t) of 64 random triangles against 256 random rays, including
    axis-aligned directions and ties of |d| components."""
    rs = np.random.RandomState(1)
    v0, v1, v2 = (rs.uniform(-1, 1, (64, 3)).astype(np.float32) for _ in range(3))
    ro = rs.uniform(-2, 2, (256, 3)).astype(np.float32)
    rd = rs.normal(size=(256, 3)).astype(np.float32)
    rd[:6] = [[1, 0, 0], [0, -1, 0], [0, 0, 1], [1, 1, 0], [0, -1, 1], [1, 1, 1]]
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    valid, t = (x.numpy() for x in wt.watertight_terms(
        *(torch.from_numpy(x) for x in (v0, v1, v2, ro, rd))))
    valid_j, t_j = (np.asarray(x) for x in wt_jax.watertight_terms(
        *(jnp.asarray(x) for x in (v0, v1, v2, ro, rd))))
    assert valid.any() and np.array_equal(valid, valid_j)
    np.testing.assert_allclose(t[valid], t_j[valid], rtol=1e-6)


def test_intersect_and_occluded_watertight_match_jax(cornell):
    host, scene_j, scene_t = cornell
    rs = np.random.RandomState(7)
    ro = rs.uniform(-0.9, 0.9, (1000, 3)).astype(np.float32)
    ro[:, 1] += 1.0
    rd = rs.normal(size=(1000, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    t1 = np.where(np.arange(1000) % 3 == 0, 0.0, 0.5).astype(np.float32)
    h, t, tri = (x.numpy() for x in wt.intersect_watertight(
        scene_t, torch.from_numpy(ro), torch.from_numpy(rd), 1e-5, 1e5))
    h_j, t_j, tri_j = (np.asarray(x) for x in wt_jax.intersect_watertight(
        scene_j, jnp.asarray(ro), jnp.asarray(rd), 1e-5, 1e5))
    assert np.array_equal(h, h_j)
    assert tri.dtype == np.int32 and (tri[h] == tri_j[h]).mean() > 0.995
    np.testing.assert_allclose(t[h], t_j[h], rtol=1e-5)
    assert np.all(t[~h] == 0)
    occ = wt.occluded_watertight(scene_t, torch.from_numpy(ro), torch.from_numpy(rd),
                                 1e-5, torch.from_numpy(t1)).numpy()
    occ_j = np.asarray(wt_jax.occluded_watertight(
        scene_j, jnp.asarray(ro), jnp.asarray(rd), 1e-5, jnp.asarray(t1)))
    assert np.array_equal(occ, occ_j) and not occ[::3].any()


@pytest.mark.parametrize("rays", ["vertical", "skewed"])
def test_shared_edge_leak_hunt_on_twins(rays):
    """4096 rays exactly onto the shared diagonal of a quad: the brute
    watertight test and the cluster twins with watertight leaves hit every
    one (0 leaked)."""
    scene = _quad_scene()
    ro, rd = _edge_rays() if rays == "vertical" else _skewed_edge_rays()
    hit, t, _ = wt.intersect_watertight(scene, ro, rd, 1e-5, 1e5)
    assert int((~hit).sum()) == 0
    assert bool(wt.occluded_watertight(scene, ro, rd, 1e-5, 1e5).all())
    cs = cl.build_clusters(scene.vertices, scene.faces)
    hit_c, t_c, _ = cl.closest_hit_ref(cs, ro, rd, 1e-5, 10.0, watertight=True)
    assert int((~hit_c).sum()) == 0
    assert bool(cl.occluded_ref(cs, ro, rd, 1e-5, 10.0, watertight=True).all())
    torch.testing.assert_close(t_c, t, rtol=0.0, atol=0.0)
    if rays == "vertical":
        torch.testing.assert_close(t, torch.ones(N_EDGE), rtol=1e-4, atol=0.0)


def test_watertight_backend_render_matches_jax(cornell_path):
    """render_image with backend "watertight", 16x16, 2 spp, against the JAX
    package's: > 95% of pixels close, median |diff| < 1e-5."""
    host, camera, _ = load_tungsten(cornell_path, dtype=np.float32)
    camera = camera._replace(resolution=(16, 16))
    cfg = RenderConfig(max_bounces=4, spp=2, seed=3, estimator="reference")
    scene_t, cam_t = to_device(host, camera, "cpu")
    img = integ.render_image(scene_t, cam_t, cfg, backend="watertight").numpy()
    img_j = np.asarray(integ_jax.render_image(
        jax.tree.map(jnp.asarray, host), camera,
        JaxConfig(max_bounces=4, spp=2, seed=3, estimator="reference"),
        backend="watertight"))
    assert np.isfinite(img).all() and img.max() > 0.1
    close = np.isclose(img, img_j, rtol=1e-3, atol=1e-4)
    assert close.mean() > 0.95
    assert np.median(np.abs(img - img_j)) < 1e-5
