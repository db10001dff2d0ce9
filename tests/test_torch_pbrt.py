"""pyrenderer_tpu_torch "pbrt" estimator against the float64 NumPy oracle and
the JAX package (mirrors tests/test_pbrt.py)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyrenderer_tpu.config import RenderConfig as JaxConfig
from pyrenderer_tpu.core import bsdf as bsdf_jax
from pyrenderer_tpu.core import integrator as integ_jax
from pyrenderer_tpu.ref import scalar as ref
from pyrenderer_tpu.scene.tungsten import build_scene as build_scene_jax
from pyrenderer_tpu.scene.tungsten import load_tungsten as load_jax
from pyrenderer_tpu_torch.config import RenderConfig
from pyrenderer_tpu_torch.core import bsdf
from pyrenderer_tpu_torch.core import integrator as integ
from pyrenderer_tpu_torch.render import cli
from pyrenderer_tpu_torch.scene import to_device
from pyrenderer_tpu_torch.scene.tungsten import build_scene
from pyrenderer_tpu_torch.utils.exr import read_exr

torch.set_num_threads(2)

SCENES = os.path.join(os.path.dirname(os.path.dirname(__file__)), "scenes")
CFG = RenderConfig(max_bounces=5, spp=2, seed=7, estimator="pbrt", russian_roulette_start=3)
CFG_JAX = JaxConfig(max_bounces=5, spp=2, seed=7, estimator="pbrt", russian_roulette_start=3)


def _scene_data(cornell_path, metal_glass=False):
    """The Cornell box; with metal_glass the tall box is metal (roughness
    0.1) and the short box glass (ior 1.5), as tests/test_pbrt.py makes it."""
    with open(cornell_path) as f:
        data = json.load(f)
    if metal_glass:
        for b in data["bsdfs"]:
            if b["name"] == "TallBox":
                b.update(type="metal", roughness=0.1)
            if b["name"] == "ShortBox":
                b.update(type="dielectric", ior=1.5)
    return data


def _render(host, camera, cfg, res, dtype=torch.float32):
    scene, cam = to_device(host, camera._replace(resolution=(res, res)), "cpu", dtype)
    return integ.render_image(scene, cam, cfg).numpy()


def _close_enough(img, other):
    """The float32 image criterion: > 95% of pixels close at rtol 1e-3 and a
    median |diff| below 1e-5 (grazing shadow rays flip between float32
    implementations, ROADMAP C)."""
    assert np.isclose(img, other, rtol=1e-3, atol=1e-4).mean() > 0.95
    assert np.median(np.abs(img - other)) < 1e-5


@pytest.mark.parametrize("metal_glass", [False, True])
def test_pbrt_parity_f64(cornell_path, metal_glass):
    """float64 at 12x12, 2 spp, 5 bounces, RR from bounce 3, against the
    NumPy oracle at rtol 1e-8, atol 1e-9 (the JAX test's tolerance)."""
    host, camera, _ = build_scene(_scene_data(cornell_path, metal_glass), dtype=np.float64)
    img = _render(host, camera, CFG, 12, torch.float64)
    img_ref = ref.render_image(host, camera._replace(resolution=(12, 12)), CFG_JAX,
                               dtype=np.float64)
    assert np.isfinite(img).all() and img.max() > 0.05
    np.testing.assert_allclose(img, img_ref, rtol=1e-8, atol=1e-9)


@pytest.mark.parametrize("metal_glass", [False, True])
def test_pbrt_f32_matches_jax(cornell_path, metal_glass):
    data = _scene_data(cornell_path, metal_glass)
    host, camera, _ = build_scene(data)
    img = _render(host, camera, CFG, 16)
    host_j, cam_j, _ = build_scene_jax(data)
    img_j = np.asarray(integ_jax.render_image(
        jax.tree.map(jnp.asarray, host_j), cam_j._replace(resolution=(16, 16)), CFG_JAX))
    _close_enough(img, img_j)


def test_spheres_f32_matches_jax():
    """scenes/spheres.json (3,852 triangles: metal and glass spheres) at
    8x8 against the JAX CPU render."""
    host, camera, _ = load_jax(os.path.join(SCENES, "spheres.json"))
    cfg = CFG.replace(max_bounces=4, spp=1)
    img = _render(host, camera, cfg, 8)
    img_j = np.asarray(integ_jax.render_image(
        jax.tree.map(jnp.asarray, host), camera._replace(resolution=(8, 8)),
        CFG_JAX.replace(max_bounces=4, spp=1)))
    assert np.isfinite(img).all() and img.max() > 0.0
    _close_enough(img, img_j)


def test_pbrt_uses_scene_emission(cornell_path):
    """Direct light pixels carry the scene's (17, 12, 4) radiance: the band
    of the light panel at 192x192 (tests/test_pbrt.py)."""
    host, camera, _ = build_scene(_scene_data(cornell_path))
    scene, cam = to_device(host, camera._replace(resolution=(192, 192)), "cpu")
    ys, xs = np.mgrid[160:176, 64:128]
    out = integ.render_block(scene, cam, CFG, CFG.seed, 4, torch.from_numpy(xs.reshape(-1)),
                             torch.from_numpy(ys.reshape(-1))).numpy()
    bright = out[np.argmax(out[:, 0])]
    assert bright[0] > 10
    np.testing.assert_allclose(bright[0] / bright[1], 17 / 12, rtol=0.05)


def test_russian_roulette_unbiased_mean(cornell_path):
    """RR from bounce 2 and no RR agree in the mean within Monte-Carlo noise."""
    host, camera, _ = build_scene(_scene_data(cornell_path))
    base = CFG.replace(max_bounces=8, spp=48, seed=11)
    img_rr = _render(host, camera, base.replace(russian_roulette_start=2), 16)
    img_norr = _render(host, camera, base.replace(russian_roulette_start=99), 16)
    assert abs(img_rr.mean() - img_norr.mean()) / img_norr.mean() < 0.05


def test_metal_reflects(cornell_path):
    host, camera, _ = build_scene(_scene_data(cornell_path, metal_glass=True))
    img = _render(host, camera, CFG.replace(spp=8, max_bounces=6), 32)
    assert np.isfinite(img).all() and img.mean() > 0.01


def _uniforms(rs, n):
    return [torch.from_numpy(rs.uniform(0, 1, n)) for _ in range(3)]


def _unit(rs, n):
    v = rs.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


@pytest.mark.parametrize("name", [
    "reflect", "refract", "schlick", "point_in_unit_sphere", "lambert_sample",
    "lambert_pdf", "metal_sample", "dielectric_sample", "power_heuristic"])
def test_bsdf_matches_jax_f64(name):
    """Each bsdf function against JAX's on the same numpy-seeded float64
    inputs. Equal to rtol 1e-12, except that point_in_unit_sphere (and
    metal_sample through it) takes u3 ** (1/3) where JAX takes cbrt: the
    two differ by a few ulp, so those two hold rtol 1e-14 on the radius."""
    rs = np.random.RandomState(5)
    n = 512
    u1, u2, u3 = _uniforms(rs, n)
    rd, nrm, wi = (torch.from_numpy(_unit(rs, n)) for _ in range(3))
    ior = torch.from_numpy(rs.uniform(1.1, 2.0, n))
    rough = torch.from_numpy(rs.uniform(0.0, 0.5, n))
    pf, pg = torch.from_numpy(rs.uniform(0, 3, n)), torch.from_numpy(rs.uniform(0, 3, n))
    args = {
        "reflect": (rd, nrm), "refract": (rd, nrm, 1.0 / ior), "schlick": (u1, ior),
        "point_in_unit_sphere": (u1, u2, u3), "lambert_sample": (nrm, u1, u2),
        "lambert_pdf": (nrm, wi), "metal_sample": (rd, nrm, rough, u1, u2, u3),
        "dielectric_sample": (rd, nrm, ior, u3), "power_heuristic": (pf, pg),
    }[name]
    out = getattr(bsdf, name)(*args)
    with jax.enable_x64(True):
        out_j = getattr(bsdf_jax, name)(*(jnp.asarray(a.numpy()) for a in args))
        out_j = jax.tree.map(np.asarray, out_j)
    outs = out if isinstance(out, tuple) else (out,)
    outs_j = out_j if isinstance(out_j, tuple) else (out_j,)
    rtol = 1e-14 if name in ("point_in_unit_sphere", "metal_sample") else 1e-12
    for a, b in zip(outs, outs_j):
        if a.dtype == torch.bool:
            assert np.array_equal(a.numpy(), b)
        else:
            np.testing.assert_allclose(a.numpy(), b, rtol=rtol, atol=1e-15)


def test_cube_root_against_cbrt():
    """u3 ** (1/3) against np.cbrt over [0, 1]: within 2 ulp in float32."""
    u = np.random.RandomState(0).uniform(0, 1, 1 << 16).astype(np.float32)
    r = torch.from_numpy(u).pow(1.0 / 3.0).numpy()
    ulp = np.spacing(np.cbrt(u).astype(np.float32))
    assert (np.abs(r - np.cbrt(u)) <= 2 * ulp).all()


def test_extended_tables_match_jax(cornell_path):
    """pack_face_data(extended=True) and pack_light_data(use_emission=True)
    equal JAX's, on the metal/glass box (every material column in use)."""
    host, camera, _ = build_scene(_scene_data(cornell_path, metal_glass=True))
    scene_t, _ = to_device(host, camera, "cpu")
    scene_j = jax.tree.map(jnp.asarray, host)
    face = integ.pack_face_data(scene_t, extended=True).numpy()
    face_j = np.asarray(integ_jax.pack_face_data(scene_j, extended=True))
    assert face.shape == face_j.shape == (36, 24)
    np.testing.assert_array_equal(face[:, :21], face_j[:, :21])
    np.testing.assert_allclose(face[:, 21:], face_j[:, 21:], rtol=1e-6)
    assert set(face[:, 15].tolist()) == {0.0, 1.0, 2.0, 3.0}
    light = integ.pack_light_data(scene_t, use_emission=True).numpy()
    light_j = np.asarray(integ_jax.pack_light_data(scene_j, use_emission=True))
    np.testing.assert_allclose(light, light_j, rtol=1e-6)
    np.testing.assert_array_equal(light[:, 9:12], light_j[:, 9:12])


def test_cli_default_estimator_cpu(cornell_path, tmp_path):
    """The CLI's default estimator (pbrt) runs: --cpu at 16x16, the HDR equal
    to render_image's."""
    exr = str(tmp_path / "out.exr")
    rc = cli.main([cornell_path, "--cpu", "--res", "16", "16", "--spp", "2", "--depth", "5",
                   "--seed", "7", "--out", str(tmp_path / "out.png"), "--hdr-out", exr,
                   "--quiet"])
    assert rc == 0
    hdr = read_exr(exr)
    host, camera, _ = build_scene(_scene_data(cornell_path))
    img = _render(host, camera, RenderConfig(max_bounces=5, spp=2, seed=7, estimator="pbrt"),
                  16)
    np.testing.assert_allclose(hdr, img, rtol=1e-6, atol=1e-7)
