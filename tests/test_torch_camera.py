"""pyrenderer_tpu_torch camera rays and pixel orders against the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyrenderer_tpu.core import camera as cam_jax
from pyrenderer_tpu.scene.tungsten import load_tungsten
from pyrenderer_tpu_torch.core import camera as cam_t
from pyrenderer_tpu_torch.scene import to_device

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def camera64(cornell_path):
    return load_tungsten(cornell_path, dtype=np.float64)


@pytest.mark.parametrize("strata", [0, 3])
@pytest.mark.parametrize("aperture", [0.0, 0.2])
def test_generate_rays_f64(camera64, strata, aperture):
    """float64 rays equal the JAX rays to rtol 1e-12."""
    scene, camera, _ = camera64
    camera = camera._replace(aperture=np.asarray(aperture), focal_dist=np.asarray(5.0))
    rs = np.random.RandomState(strata)
    n = 300
    px = rs.randint(0, 1024, n).astype(np.int32)
    py = rs.randint(0, 1024, n).astype(np.int32)
    sample = rs.randint(0, 2**20, n).astype(np.uint32)
    with jax.enable_x64(True):
        cj = camera._replace(iview=jnp.asarray(camera.iview))
        ro_j, rd_j = cam_jax.generate_rays(cj, jnp.asarray(px), jnp.asarray(py),
                                           jnp.asarray(sample), seed=9, strata=strata)
        ro_j, rd_j = np.asarray(ro_j), np.asarray(rd_j)
    assert ro_j.dtype == np.float64
    _, ct = to_device(scene, camera, "cpu", torch.float64)
    ro, rd = cam_t.generate_rays(ct, torch.from_numpy(px), torch.from_numpy(py),
                                 torch.from_numpy(sample.astype(np.int64)), seed=9,
                                 strata=strata)
    np.testing.assert_allclose(ro.numpy(), ro_j, rtol=1e-12)
    np.testing.assert_allclose(rd.numpy(), rd_j, rtol=1e-12)
    if aperture > 0:
        assert ro.numpy()[:, 0].std() > 0.01


def test_generate_rays_scalar_sample_f32(cornell_path):
    """A scalar sample id (the integrator's call) and float32 tensors."""
    scene, camera, _ = load_tungsten(cornell_path, dtype=np.float32)
    xs = np.array([0, 3, 511, 1023], np.int32)
    ys = np.array([0, 7, 600, 1023], np.int32)
    ro_j, rd_j = cam_jax.generate_rays(camera, jnp.asarray(xs), jnp.asarray(ys),
                                       jnp.uint32(5), seed=9)
    _, ct = to_device(scene, camera, "cpu", torch.float32)
    ro, rd = cam_t.generate_rays(ct, torch.from_numpy(xs), torch.from_numpy(ys), 5, seed=9)
    assert rd.dtype == torch.float32
    np.testing.assert_allclose(ro.numpy(), np.asarray(ro_j), atol=1e-6)
    np.testing.assert_allclose(rd.numpy(), np.asarray(rd_j), atol=1e-6)


@pytest.mark.parametrize("kind", ["morton", "hilbert", "row"])
@pytest.mark.parametrize("shape", [(16, 16), (13, 7), (64, 40)])
def test_pixel_orders_equal(kind, shape):
    w, h = shape
    perm, inv = cam_t.pixel_order(w, h, kind)
    perm_j, inv_j = cam_jax.pixel_order(w, h, kind)
    assert np.array_equal(perm, perm_j) and np.array_equal(inv, inv_j)
    assert np.array_equal(perm[inv], np.arange(w * h))


def test_pixel_order_rejects_unknown():
    with pytest.raises(ValueError):
        cam_t.pixel_order(8, 8, "zigzag")
