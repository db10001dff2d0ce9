"""The matmul backend of pyrenderer_tpu_torch (core/intersect.py) against the
JAX package's (pyrenderer_tpu/core/intersect.py) and against the port's
"brute" test, at the bounds of tests/test_intersect.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyrenderer_tpu.config import RenderConfig as JaxConfig
from pyrenderer_tpu.core import integrator as integ_jax
from pyrenderer_tpu.core import intersect as isect_jax
from pyrenderer_tpu.scene.tungsten import load_tungsten
from pyrenderer_tpu_torch.config import RenderConfig
from pyrenderer_tpu_torch.core import integrator as integ
from pyrenderer_tpu_torch.core import intersect as isect
from pyrenderer_tpu_torch.scene import to_device

torch.set_num_threads(2)

T0, T1 = 1e-5, 1e5


@pytest.fixture(scope="module")
def scenes(cornell_path):
    host, camera, _ = load_tungsten(cornell_path, dtype=np.float32)
    scene_t, _ = to_device(host, camera, "cpu", torch.float32)
    return host, scene_t, jax.tree.map(jnp.asarray, host)


def _random_rays(n, seed=0):
    """tests/test_intersect.py's rays: origins inside the box, unit directions."""
    rs = np.random.RandomState(seed)
    ro = rs.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    ro[:, 1] += 1.0
    rd = rs.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro, rd


def test_tri_matrix_and_terms_match_jax(scenes):
    """W (16, T, 4) and the (N, T) terms (det, t, u, v) against JAX's,
    float32 (rtol 1e-5, atol 1e-6 of the largest entry: the products are
    summed in another order), and W's entries against the terms they stand
    for (phi @ W equals the Moeller-Trumbore triple products)."""
    _, scene_t, scene_j = scenes
    w = isect.build_tri_matrix(scene_t)
    w_j = np.asarray(isect_jax.build_tri_matrix(scene_j))
    assert w.shape == w_j.shape == (16, 36, 4)
    np.testing.assert_allclose(w.numpy(), w_j, rtol=1e-5, atol=1e-6 * np.abs(w_j).max())

    ro, rd = _random_rays(128, seed=2)
    terms = isect.mt_terms_matmul(w, torch.from_numpy(ro), torch.from_numpy(rd))
    terms_j = isect_jax.mt_terms_matmul(jnp.asarray(w_j), jnp.asarray(ro), jnp.asarray(rd))
    det, det_j = terms[0].numpy(), np.asarray(terms_j[0])
    np.testing.assert_allclose(det, det_j, rtol=1e-5, atol=1e-6 * np.abs(det_j).max())
    # t, u, v are ratios over det: compare where det is not near 0
    ok = np.abs(det_j) > 1e-3 * np.abs(det_j).max()
    for a, b in zip(terms[1:], terms_j[1:]):
        np.testing.assert_allclose(a.numpy()[ok], np.asarray(b)[ok], rtol=1e-4, atol=1e-5)
    det_b, t_b, _, _ = isect._mt_terms(*isect._gather_tris(scene_t), torch.from_numpy(ro),
                                       torch.from_numpy(rd))
    np.testing.assert_allclose(det, det_b.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(terms[1].numpy()[ok], t_b.numpy()[ok], rtol=1e-4, atol=1e-4)


def test_intersect_matmul_matches_jax_and_brute(scenes):
    """tests/test_intersect.py::test_matmul_matches_brute's bounds: equal hit
    masks, faces equal on > 99.5% of rays (ties on the shared edges of
    coplanar pairs), t within rtol 2e-4 / atol 2e-5 where the faces agree;
    against the port's brute and against JAX's matmul."""
    _, scene_t, scene_j = scenes
    ro, rd = _random_rays(512)
    hit, t, tri = isect.intersect_matmul(scene_t, torch.from_numpy(ro), torch.from_numpy(rd),
                                         T0, T1)
    assert tri.dtype == torch.int32
    hit_b, t_b, tri_b = isect.intersect_brute(scene_t, torch.from_numpy(ro),
                                              torch.from_numpy(rd), T0, T1)
    hit_j, t_j, tri_j = isect_jax.intersect_matmul(scene_j, jnp.asarray(ro), jnp.asarray(rd),
                                                   T0, T1)
    for h2, t2, tri2 in ((hit_b.numpy(), t_b.numpy(), tri_b.numpy()),
                         (np.asarray(hit_j), np.asarray(t_j), np.asarray(tri_j))):
        assert np.array_equal(hit.numpy(), h2)
        same = tri.numpy() == tri2
        assert same.mean() > 0.995
        np.testing.assert_allclose(t.numpy()[same], t2[same], rtol=2e-4, atol=2e-5)
    assert 0.5 < hit.float().mean() < 1.0  # the box is open towards the camera
    miss = ~hit
    assert bool((t[miss] == 0).all()) and bool((tri[miss] == 0).all())  # brute's contract


def test_occluded_matmul_matches_jax_and_brute(scenes):
    """tests/test_intersect.py::test_occlusion_paths_agree's bound, > 99.5%
    of rays equal, at a per-ray t1 of 1.5."""
    _, scene_t, scene_j = scenes
    ro, rd = _random_rays(256, seed=1)
    t1 = torch.full((256,), 1.5)
    occ = isect.occluded_matmul(scene_t, torch.from_numpy(ro), torch.from_numpy(rd), T0, t1)
    occ_b = isect.occluded(scene_t, torch.from_numpy(ro), torch.from_numpy(rd), T0, t1)
    occ_j = isect_jax.occluded_matmul(scene_j, jnp.asarray(ro), jnp.asarray(rd), T0,
                                      jnp.full((256,), 1.5, jnp.float32))
    assert 0.05 < occ.float().mean() < 0.95
    assert (occ == occ_b).float().mean() > 0.995
    assert (occ.numpy() == np.asarray(occ_j)).mean() > 0.995


def test_hit_t_gradient_matches_jax_float64(cornell_path):
    """d t / d vertices through W, float64, against jax.grad (the JAX
    package's test_tri_matrix_differentiable: a ray down the camera axis,
    the back wall's first face), to 1e-10 of the largest entry."""
    host, camera, _ = load_tungsten(cornell_path, dtype=np.float64)
    ro = np.array([[0.0, 1.0, 6.8]])
    rd = np.array([[0.0, 0.0, -1.0]])
    tri = 4

    scene_t, _ = to_device(host, camera, "cpu", torch.float64)
    v = scene_t.vertices.clone().requires_grad_()
    w = isect.build_tri_matrix(scene_t._replace(vertices=v))
    t = isect.mt_terms_matmul(w, torch.from_numpy(ro), torch.from_numpy(rd))[1][0, tri]
    (g,) = torch.autograd.grad(t, v)

    with jax.enable_x64(True):
        scene_j = jax.tree.map(jnp.asarray, host)

        def hit_t(vertices):
            w_j = isect_jax.build_tri_matrix(scene_j._replace(vertices=vertices))
            return isect_jax.mt_terms_matmul(w_j, jnp.asarray(ro), jnp.asarray(rd))[1][0, tri]

        g_j = np.asarray(jax.grad(hit_t)(scene_j.vertices))
        t_j = float(hit_t(scene_j.vertices))
    assert abs(float(t.detach()) - t_j) <= 1e-12 * abs(t_j)
    assert np.abs(g_j).sum() > 1e-3
    np.testing.assert_allclose(g.numpy(), g_j, rtol=0, atol=1e-10 * np.abs(g_j).max())


@pytest.mark.parametrize("precision", ["high", "medium"])
def test_matmul_is_ieee_whatever_the_process_sets(scenes, precision):
    """Under torch.set_float32_matmul_precision("high" or "medium") the
    product stays IEEE float32 (the counterpart of JAX's
    Precision.HIGHEST), bit for bit the result under "highest", forward and
    backward, and the process's setting is back afterwards."""
    _, scene_t, _ = scenes
    ro, rd = (torch.from_numpy(x) for x in _random_rays(256, seed=3))

    def run():
        v = scene_t.vertices.clone().requires_grad_()
        w = isect.build_tri_matrix(scene_t._replace(vertices=v))
        det, t, _, _ = isect.mt_terms_matmul(w, ro, rd)
        (g,) = torch.autograd.grad((det.sum() + t.clamp(-10, 10).sum()), v)
        return det.detach(), t.detach(), g

    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("highest")
        ref = run()
        torch.set_float32_matmul_precision(precision)
        out = run()
        assert torch.get_float32_matmul_precision() == precision
    finally:
        torch.set_float32_matmul_precision(prev)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


def test_render_image_matmul_matches_jax(cornell_path):
    """render_image(backend="matmul") at 16x16, 2 spp, 4 bounces, reference
    estimator, float32, against the JAX package's matmul render (> 95% of
    values close at rtol 1e-3 / atol 1e-4, median |diff| < 1e-5, as the
    port's other float32 renders are held) and against the port's "brute"
    render (> 99% of values equal: the hit geometry is re-derived from the
    face, so only a flipped decision moves a value)."""
    host, camera, _ = load_tungsten(cornell_path, dtype=np.float32)
    camera = camera._replace(resolution=(16, 16))
    cfg = RenderConfig(max_bounces=4, spp=2, seed=3, estimator="reference")
    scene_t, cam_t = to_device(host, camera, "cpu", torch.float32)
    img = integ.render_image(scene_t, cam_t, cfg, backend="matmul").numpy()
    img_b = integ.render_image(scene_t, cam_t, cfg, backend="brute").numpy()
    img_j = np.asarray(integ_jax.render_image(
        jax.tree.map(jnp.asarray, host), camera,
        JaxConfig(max_bounces=4, spp=2, seed=3, estimator="reference"), backend="matmul"))
    assert img.shape == (16, 16, 3) and np.isfinite(img).all() and img.max() > 0.1
    assert np.isclose(img, img_j, rtol=1e-3, atol=1e-4).mean() > 0.95
    assert np.median(np.abs(img - img_j)) < 1e-5
    assert (img == img_b).mean() > 0.99


@pytest.mark.cuda
def test_matmul_is_ieee_on_card(cornell_path):
    """On the card, where "high" means TF32 for a float32 product:
    intersect_matmul and the terms' gradient under "high" are bit for bit
    those under "highest"."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    host, camera, _ = load_tungsten(cornell_path, dtype=np.float32)
    scene, _ = to_device(host, camera, "cuda:0", torch.float32)
    ro, rd = (torch.from_numpy(x).cuda() for x in _random_rays(1 << 16, seed=4))

    def run():
        v = scene.vertices.clone().requires_grad_()
        w = isect.build_tri_matrix(scene._replace(vertices=v))
        (g,) = torch.autograd.grad(isect.mt_terms_matmul(w, ro, rd)[0].sum(), v)
        return isect.intersect_matmul(scene, ro, rd, T0, T1, w.detach()) + (g,)

    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("highest")
        ref = run()
        torch.set_float32_matmul_precision("high")
        out = run()
    finally:
        torch.set_float32_matmul_precision(prev)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


def test_frame_decisions_against_brute(cornell_path, monkeypatch, capsys):
    """How often the matmul test decides otherwise than the brute one on a
    frame's own rays (Cornell 64x64, 16 spp, 4 bounces, reference,
    float32): each closest-hit and any-hit query of a "brute" render is
    asked of intersect_matmul / occluded_matmul too. The two round t, u
    and v differently, so grazing rays flip: no hit mask differs, faces of
    another material on < 0.01% of live rays, occlusion on < 0.1% of
    shadow rays (chip_smoke.py phase 27 holds the card's 1024x1024 frame
    to these bounds, hit masks to < 1e-5 of the live rays)."""
    host, camera, _ = load_tungsten(cornell_path, dtype=np.float32)
    scene, cam = to_device(host, camera._replace(resolution=(64, 64)), "cpu", torch.float32)
    cfg = RenderConfig(max_bounces=4, spp=16, seed=0, estimator="reference")
    w = isect.build_tri_matrix(scene)
    counts = dict(rays=0, hit=0, material=0, shadow_rays=0, occluded=0)
    closest, any_hit = integ._closest, integ._any_hit

    def both_closest(scene, tables, cfg, ro, rd, t1):
        hit, t, tri = closest(scene, tables, cfg, ro, rd, t1)
        hit_m, _, tri_m = isect.intersect_matmul(scene, ro, rd, cfg.t_min, t1, w)
        live, mat = t1 > 0, scene.face_material
        counts["rays"] += int(live.sum())
        counts["hit"] += int((hit != hit_m)[live].sum())
        counts["material"] += int((live & hit & hit_m & (mat[tri.long()] != mat[tri_m.long()])).sum())
        return hit, t, tri

    def both_any_hit(scene, tables, cfg, ro, rd, t1):
        occ = any_hit(scene, tables, cfg, ro, rd, t1)
        live = t1 > 0
        counts["shadow_rays"] += int(live.sum())
        counts["occluded"] += int((occ != isect.occluded_matmul(scene, ro, rd, cfg.t_min, t1,
                                                                w))[live].sum())
        return occ

    monkeypatch.setattr(integ, "_closest", both_closest)
    monkeypatch.setattr(integ, "_any_hit", both_any_hit)
    integ.render_image(scene, cam, cfg, backend="brute")
    with capsys.disabled():
        print(f"\nmatmul against brute on a frame's rays: {counts}")
    assert counts["rays"] > 200_000 and counts["shadow_rays"] > 150_000
    assert counts["hit"] == 0
    assert counts["material"] < 1e-4 * counts["rays"]
    assert counts["occluded"] < 1e-3 * counts["shadow_rays"]
