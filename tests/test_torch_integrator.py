"""pyrenderer_tpu_torch integrator against the JAX integrator (Pallas kernels
in interpret mode) and the float64 NumPy oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyrenderer_tpu.config import RenderConfig as JaxConfig
from pyrenderer_tpu.core import integrator as integ_jax
from pyrenderer_tpu.core.camera import generate_rays as generate_rays_jax
from pyrenderer_tpu.kernels import pallas_intersect as pk
from pyrenderer_tpu.ref import scalar as ref
from pyrenderer_tpu.scene.tungsten import load_tungsten
from pyrenderer_tpu_torch.config import RenderConfig
from pyrenderer_tpu_torch.core import integrator as integ
from pyrenderer_tpu_torch.kernels import intersect as ki
from pyrenderer_tpu_torch.scene import to_device

torch.set_num_threads(2)

CFG = RenderConfig(max_bounces=4, spp=2, seed=3, estimator="reference")
CFG_JAX = JaxConfig(max_bounces=4, spp=2, seed=3, estimator="reference")


def _pallas_tables(scene_j, cfg):
    """JAX TraceTables whose closures run the TPU kernels in interpret mode."""
    table = pk.pack_triangles(scene_j.vertices, scene_j.faces)
    return integ_jax.TraceTables.custom(
        integ_jax.pack_face_data(scene_j),
        integ_jax.pack_light_data(scene_j, use_emission=False),
        closest_fn=lambda ro, rd, t1: pk.closest_hit(table, ro, rd, cfg.t_min, t1,
                                                     interpret=True),
        any_hit_fn=lambda ro, rd, t1: pk.occluded(table, ro, rd, cfg.t_min, t1,
                                                  interpret=True),
    )


def _mismatched_rays(a, b):
    return int((~np.isclose(a, b, rtol=1e-4, atol=1e-6).all(axis=1)).sum())


def test_trace_reference_matches_pallas_path(cornell_path):
    """One wavefront of 256 camera rays, 4 bounces, against the JAX
    integrator driving the Pallas kernels; the port runs its "cuda" backend,
    i.e. the kernel wrappers, which take the plain twins on CPU tensors.

    Ray counts are equal. Radiance agrees at rtol 1e-4, atol 1e-6 on at
    least 98% of the rays: in float32 a grazing shadow ray's occlusion
    depends on the last ulp of its origin, which the two frameworks round
    differently (XLA:CPU contracts into FMAs). The float32 NumPy oracle
    arbitrates: the port may disagree with it on no more rays than the JAX
    path does (1 and 2 of these 256)."""
    host, camera, _ = load_tungsten(cornell_path, dtype=np.float32)
    scene_j = jax.tree.map(jnp.asarray, host)
    rs = np.random.RandomState(0)
    px = rs.randint(0, 1024, 256).astype(np.int32)
    py = rs.randint(0, 1024, 256).astype(np.int32)
    ro, rd = (np.asarray(x) for x in generate_rays_jax(
        camera, jnp.asarray(px), jnp.asarray(py), jnp.uint32(1), seed=CFG.seed))
    pixel = (py * 1024 + px).astype(np.uint32)

    rad_j, n_j = integ_jax.trace_reference(
        scene_j, CFG_JAX, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(pixel),
        jnp.uint32(1), CFG.seed, tables=_pallas_tables(scene_j, CFG_JAX),
        with_stats=True)

    scene_t, _ = to_device(host, camera, "cpu", torch.float32)
    ki.reset_counters()
    rad, n = integ.trace_reference(
        scene_t, CFG, torch.from_numpy(ro.copy()), torch.from_numpy(rd.copy()),
        torch.from_numpy(pixel.astype(np.int64)), 1, CFG.seed, backend="cuda",
        with_stats=True)
    assert ki.closest_hit.twin_calls == 4 and ki.occluded.twin_calls == 4
    assert ki.closest_hit.launches == 0
    ki.reset_counters()
    assert float(n) == float(n_j) > 256
    rad, rad_j = rad.numpy(), np.asarray(rad_j)
    assert float(rad_j.max()) > 0.1
    assert _mismatched_rays(rad, rad_j) <= 0.02 * 256
    rad_np = np.array([ref.trace_reference(host, CFG, ro[i], rd[i], int(pixel[i]), 1,
                                           CFG.seed, np.float32) for i in range(256)])
    assert _mismatched_rays(rad, rad_np) <= _mismatched_rays(rad_j, rad_np)


@pytest.mark.parametrize("backend", ["brute", "cuda"])
def test_render_image_f64_matches_oracle(cornell_path, backend):
    """float64 render_image against the scalar NumPy oracle, 16x16, 2 spp,
    seed 3, 4 bounces: rtol 1e-9, atol 1e-10."""
    host, camera, _ = load_tungsten(cornell_path, dtype=np.float64)
    camera = camera._replace(resolution=(16, 16))
    scene_t, cam_t = to_device(host, camera, "cpu", torch.float64)
    img = integ.render_image(scene_t, cam_t, CFG, backend=backend).numpy()
    img_ref = ref.render_image(host, camera, CFG, dtype=np.float64)
    assert img.shape == (16, 16, 3) and img.dtype == np.float64
    assert np.isfinite(img).all() and img.max() > 0.1
    np.testing.assert_allclose(img, img_ref, rtol=1e-9, atol=1e-10)


def test_render_image_f32_matches_jax_and_oracle(cornell_path):
    """float32: more than 95% of pixels close and a median |diff| below 1e-5,
    against the JAX render_image and against the oracle."""
    host, camera, _ = load_tungsten(cornell_path, dtype=np.float32)
    camera = camera._replace(resolution=(16, 16))
    scene_t, cam_t = to_device(host, camera, "cpu", torch.float32)
    img = integ.render_image(scene_t, cam_t, CFG).numpy()
    img_j = np.asarray(integ_jax.render_image(jax.tree.map(jnp.asarray, host), camera, CFG_JAX))
    img_ref = ref.render_image(host, camera, CFG, dtype=np.float32)
    for other in (img_j, img_ref):
        close = np.isclose(img, other, rtol=1e-3, atol=1e-4)
        assert close.mean() > 0.95
        assert np.median(np.abs(img - other)) < 1e-5


def test_packed_tables_match_jax(cornell_path):
    host, camera, _ = load_tungsten(cornell_path, dtype=np.float32)
    scene_j = jax.tree.map(jnp.asarray, host)
    scene_t, _ = to_device(host, camera, "cpu", torch.float32)
    np.testing.assert_array_equal(integ.pack_face_data(scene_t).numpy(),
                                  np.asarray(integ_jax.pack_face_data(scene_j)))
    np.testing.assert_allclose(integ.pack_light_data(scene_t).numpy(),
                               np.asarray(integ_jax.pack_light_data(scene_j, False)),
                               rtol=1e-6)
    np.testing.assert_allclose(integ.light_area_pdf(scene_t).numpy(),
                               np.asarray(integ_jax.light_area_pdf(scene_j)), rtol=1e-6)


def test_backend_resolution_and_unported_paths(cornell_path):
    """"auto" is "brute" on CPU tensors and "cuda" on CUDA ones, and past
    AUTO_BRUTE_MAX_TRIS the BVH on the CPU and the cluster sweep on CUDA;
    both estimators render, an unknown one is refused; what is not ported
    raises NotImplementedError instead of taking another path. "matmul" is
    explicit only, as in the JAX package; adaptive sampling renders."""
    assert integ.resolve_backend("auto", 36, "cpu") == "brute"
    assert integ.resolve_backend("auto", 36, "cuda:0") == "cuda"
    assert integ.resolve_backend("cuda", 36, "cpu") == "cuda"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        integ.resolve_backend("pallas", 36, "cpu")
    for device in ("cpu", "cuda:0"):
        assert integ.resolve_backend("matmul", 36, device) == "matmul"
        for n_tris in (36, integ.AUTO_BRUTE_MAX_TRIS + 1):
            assert integ.resolve_backend("auto", n_tris, device) != "matmul"
    assert integ.resolve_backend("auto", integ.AUTO_BRUTE_MAX_TRIS + 1, "cpu") == "bvh"
    assert integ.resolve_backend("auto", integ.AUTO_BRUTE_MAX_TRIS + 1, "cuda:0") == "cluster"
    with pytest.raises(ValueError):
        integ.resolve_backend("nope", 36, "cpu")

    host, camera, _ = load_tungsten(cornell_path, dtype=np.float32)
    scene_t, cam_t = to_device(host, camera._replace(resolution=(4, 4)), "cpu")
    assert integ.render_image(scene_t, cam_t, CFG.replace(estimator="pbrt")).shape == (4, 4, 3)
    with pytest.raises(ValueError, match="estimator"):
        integ.render_image(scene_t, cam_t, CFG.replace(estimator="nope"))
    # render_image renders a uniform frame; adaptivity is the driver's
    assert torch.equal(integ.render_image(scene_t, cam_t, CFG.replace(adaptive=True)),
                       integ.render_image(scene_t, cam_t, CFG))
    assert integ.render_image(scene_t, cam_t, CFG, backend="matmul").shape == (4, 4, 3)
    ro = torch.zeros((2, 3))
    with pytest.raises(NotImplementedError, match="A12"):
        integ.trace_reference(scene_t, CFG, ro, ro, torch.zeros(2, dtype=torch.int64),
                              0, 0, collect_paths=True)
