"""pyrenderer_tpu_torch/analytic.py, the analytic-primitive tracer: every test
of tests/test_analytic.py on the port (the float64 NumPy oracles of the
intersectors, the MIS estimator against the area integral, the render's
walls, the display transform, the CLI), then parity with the JAX module
pyrenderer_tpu/analytic.py on the same seeded inputs: the intersectors,
the camera rays, the two sampling steps and the whole image."""

import os
import subprocess
import sys

import imageio.v3 as iio
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyrenderer_tpu import analytic as an_jax
from pyrenderer_tpu_torch import analytic as an
from pyrenderer_tpu_torch.render import cli

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.as_tensor(np.array(a))


def _rand_rays(n, seed):
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-2.0, 2.0, (n, 3))
    rd = rng.standard_normal((n, 3))
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro, rd


def _f32(*arrays):
    return [torch.as_tensor(a, dtype=torch.float32) for a in arrays]


def test_sphere_matches_quadratic_oracle():
    n = 2048
    ro, rd = _rand_rays(n, 1)
    center = np.asarray(an.SP1_CENTER)
    r = an.SP1_RADIUS
    # aim half the rays at points near the sphere so the hit set is dense
    rng = np.random.default_rng(11)
    aim = center + rng.uniform(-1.5 * r, 1.5 * r, (n // 2, 3))
    rd[: n // 2] = aim - ro[: n // 2]
    rd[: n // 2] /= np.linalg.norm(rd[: n // 2], axis=1, keepdims=True)

    t, hit_pos = an.intersect_sphere(*_f32(ro, rd), tuple(center), r)
    t = t.numpy()

    # float64 oracle: smallest positive root of |o + t d - c|^2 = r^2
    oc = ro - center
    b = 2.0 * np.sum(oc * rd, axis=1)
    c = np.sum(oc * oc, axis=1) - r * r
    delta = b * b - 4.0 * c
    has = delta > 0
    sq = np.sqrt(np.maximum(delta, 0.0))
    t0 = 0.5 * (-b - sq)
    t1 = 0.5 * (-b + sq)
    t_oracle = np.where(t0 > 0, t0, t1)
    expect_hit = has & (t_oracle > 1e-3)

    got_hit = t < an.INF
    # ignore grazing rays where f32 vs f64 legitimately disagree
    grazing = np.abs(delta) < 1e-3
    agree = (got_hit == expect_hit) | grazing
    assert agree.mean() > 0.995

    both = got_hit & expect_hit & ~grazing
    assert both.sum() > 50
    np.testing.assert_allclose(t[both], t_oracle[both], rtol=2e-3, atol=2e-3)
    # hit point sits on the sphere
    hp = hit_pos.numpy()[both]
    np.testing.assert_allclose(np.linalg.norm(hp - center, axis=1), r, rtol=3e-3)


def test_plane_matches_oracle():
    n = 1024
    ro, rd = _rand_rays(n, 2)
    t = an.intersect_plane(*_f32(ro, rd), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0)).numpy()
    denom = rd[:, 1]
    t_oracle = np.where(np.abs(denom) > an.EPS, -ro[:, 1] / denom, np.inf)
    expect = (t_oracle > 0) & np.isfinite(t_oracle)
    got = t < an.INF
    assert (got == expect).mean() > 0.999
    both = got & expect
    np.testing.assert_allclose(t[both], t_oracle[both], rtol=1e-4, atol=1e-5)


def test_aabb_matches_slab_oracle():
    n = 4096
    ro, rd = _rand_rays(n, 3)
    bmin = np.asarray([-0.4, -0.2, -0.6])
    bmax = np.asarray([0.5, 0.7, 0.3])
    hit, t_near, _, normal = an.intersect_aabb(*_f32(ro, rd), tuple(bmin), tuple(bmax))
    hit, t_near, normal = hit.numpy(), t_near.numpy(), normal.numpy()

    with np.errstate(divide="ignore", invalid="ignore"):
        i1 = (bmin - ro) / rd
        i2 = (bmax - ro) / rd
    near = np.fmin(i1, i2)
    far = np.fmax(i1, i2)
    # parallel-axis handling identical to the explicit mask
    inside = (ro >= bmin) & (ro <= bmax)
    near = np.where(np.abs(rd) < 1e-300, -np.inf, near)
    far = np.where(np.abs(rd) < 1e-300, np.inf, far)
    tn = near.max(axis=1)
    tf = far.min(axis=1)
    expect = (tn <= tf) & ~((np.abs(rd) < 1e-300) & ~inside).any(axis=1)

    # skip near-degenerate boundary cases
    clear = np.abs(tn - tf) > 1e-4
    assert ((hit == expect) | ~clear).mean() > 0.998
    both = hit & expect & clear
    assert both.sum() > 200
    np.testing.assert_allclose(t_near[both], tn[both], rtol=1e-3, atol=1e-4)

    # entry normal: axis of the max near-plane, signed against the ray
    axis = near.argmax(axis=1)
    for i in np.nonzero(both)[0][:300]:
        a = axis[i]
        assert abs(abs(normal[i, a]) - 1.0) < 1e-6
        assert normal[i].sum() == normal[i, a]  # one-hot
        # entering face: normal opposes the ray component on that axis
        assert normal[i, a] * rd[i, a] < 0


def test_transformed_aabb_hit_on_local_surface():
    n = 2048
    ro, rd = _rand_rays(n, 4)
    hit, t, n_w = an.intersect_aabb_transformed(
        *_f32(ro, rd), an.BOX_MIN, an.BOX_MAX, an._BOX_M_INV, an._BOX_M_INV_T)
    hit, t = hit.numpy(), t.numpy()
    assert hit.sum() > 20
    p = ro + t[:, None] * rd
    m_inv = np.asarray(an._BOX_M_INV, np.float64)
    p_local = p @ m_inv[:3, :3].T + m_inv[:3, 3]
    bmin, bmax = np.asarray(an.BOX_MIN), np.asarray(an.BOX_MAX)
    for i in np.nonzero(hit)[0]:
        pl = p_local[i]
        assert (pl > bmin - 1e-3).all() and (pl < bmax + 1e-3).all()
        # on the boundary: some axis within tol of a face
        d_face = np.minimum(np.abs(pl - bmin), np.abs(pl - bmax)).min()
        assert d_face < 1e-3
    # world normal is unit length where hit
    nn = np.linalg.norm(n_w.numpy()[hit], axis=1)
    np.testing.assert_allclose(nn, 1.0, atol=1e-3)


def test_mis_direct_light_matches_area_integral():
    """sample_direct_light at an unoccluded lambert floor point equals the
    analytic area integral of the light (MC oracle, f64): MIS weights must
    sum both strategies to exactly one integral's worth."""
    p_np = np.asarray([0.3, 0.0, 1.0])
    albedo = np.asarray([0.93, 0.93, 0.93])

    # oracle: uniform area sampling of the light rectangle, 400k samples
    rng = np.random.default_rng(5)
    m = 400_000
    lx = rng.uniform(an.LIGHT_X_MIN, an.LIGHT_X_MIN + an.LIGHT_X_RANGE, m)
    lz = rng.uniform(an.LIGHT_Z_MIN, an.LIGHT_Z_MIN + an.LIGHT_Z_RANGE, m)
    lp = np.stack([lx, np.full(m, an.LIGHT_Y), lz], axis=1)
    d = lp - p_np
    dist2 = (d * d).sum(axis=1)
    wd = d / np.sqrt(dist2)[:, None]
    cos_s = np.maximum(0.0, wd[:, 1])           # surface normal +y
    # light normal (0,-1,0) vs direction light->surface (= -wd): cos = +wd_y
    cos_l = np.maximum(0.0, wd[:, 1])
    g = cos_s * cos_l / dist2
    lc = np.asarray(an.LIGHT_COLOR)
    oracle = (albedo / np.pi) * lc * an.LIGHT_AREA * g.mean()

    # estimator: many independent RNG streams at the same point
    n = 8192
    p = torch.tensor(p_np, dtype=torch.float32).expand(n, 3)
    nrm = torch.tensor([0.0, 1.0, 0.0]).expand(n, 3)
    col = torch.tensor(albedo, dtype=torch.float32).expand(n, 3)
    pixel = torch.arange(n)
    sample = torch.zeros(n, dtype=torch.int64)
    li = an.sample_direct_light(p, nrm, col, pixel, sample, 0, 7).numpy()
    assert np.isfinite(li).all()
    np.testing.assert_allclose(li.mean(axis=0), oracle, rtol=0.05)


def test_render_smoke_walls_and_light():
    hdr = an.render(res=(24, 24), spp=1, seed=0, max_depth=3, device="cpu")
    assert hdr.shape == (24, 24, 3) and hdr.device.type == "cpu"
    hdr = hdr.numpy()
    assert np.isfinite(hdr).all()
    assert hdr.max() > 0

    ldr = an.tonemap(torch.from_numpy(hdr)).numpy()
    left = ldr[:, :6].mean(axis=(0, 1))
    right = ldr[:, -6:].mean(axis=(0, 1))
    assert left[0] > left[1] * 1.15    # red wall dominates on the left
    assert right[1] > right[0] * 1.15  # green wall dominates on the right


def test_tonemap_convention():
    out = an.tonemap(torch.tensor([[0.0, 0.01, 1.0]])).numpy()
    np.testing.assert_allclose(out, np.sqrt([[0.0, 1.0, 100.0]]), rtol=1e-6)


@pytest.mark.slow
def test_mis_self_consistency_across_spp():
    """Unbiasedness smoke: mean image radiance at two sample counts agrees
    (same estimator, independent strata/streams)."""
    # 25 = one full 5x5 stratum cover (camera_rays picks strata by pass
    # index): partial covers bias the pixel-footprint sampling
    lo = an.render(res=(12, 12), spp=25, seed=0, max_depth=4, device="cpu")
    hi = an.render(res=(12, 12), spp=50, seed=3, max_depth=4, device="cpu")
    assert torch.isfinite(lo).all() and torch.isfinite(hi).all()
    # compare tonemapped means: sqrt compresses the heavy-tailed caustic
    # outliers that dominate raw-radiance variance at this tiny budget
    np.testing.assert_allclose(an.tonemap(lo).mean().item(), an.tonemap(hi).mean().item(),
                               rtol=0.1)


def test_cli_analytic(tmp_path, monkeypatch, capsys):
    """`cli analytic --cpu` renders the standalone scene end to end (as a
    subprocess, `python -m`); without --cpu and with no GPU it exits 2."""
    out = tmp_path / "analytic_cli.png"
    hdr = tmp_path / "analytic_cli.npy"
    res = subprocess.run(
        [sys.executable, "-m", "pyrenderer_tpu_torch.render.cli", "analytic",
         "--cpu", "--res", "16", "16", "--spp", "1", "--depth", "2",
         "--out", str(out), "--hdr-out", str(hdr)],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO), cwd=tmp_path)
    assert res.returncode == 0, res.stderr
    img = iio.imread(out)
    assert img.shape == (16, 16, 3)
    assert img.max() > 0
    np.testing.assert_array_equal(
        np.load(hdr), an.render(res=(16, 16), spp=1, seed=0, max_depth=2, device="cpu").numpy())

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gpu_out = tmp_path / "gpu.png"
    assert cli.main(["analytic", "--res", "4", "4", "--spp", "1", "--out", str(gpu_out)]) == 2
    assert "--cpu" in capsys.readouterr().err and not gpu_out.exists()


# --- parity with the JAX module -------------------------------------------


def _scene_rays(n=2048, seed=0):
    """Rays from inside the box, a quarter each in random directions and
    aimed near the sphere, the rotated box and the light, as float32 JAX
    arrays and tensors."""
    rng = np.random.default_rng(seed)
    ro = rng.uniform((-1.0, 0.05, 0.2), (1.0, 1.95, 3.0), (n, 3))
    rd = rng.standard_normal((n, 3))
    q = n // 4
    for k, (lo, hi) in enumerate([
            (np.asarray(an.SP1_CENTER) - 0.33, np.asarray(an.SP1_CENTER) + 0.33),
            ((-0.9, 0.0, 0.4), (0.0, 1.2, 1.3)),
            (an.LIGHT_MIN, an.LIGHT_MAX)], start=1):
        rd[k * q:(k + 1) * q] = rng.uniform(lo, hi, (q, 3)) - ro[k * q:(k + 1) * q]
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    ro, rd = ro.astype(np.float32), rd.astype(np.float32)
    return (jnp.asarray(ro), jnp.asarray(rd)), (torch.from_numpy(ro), torch.from_numpy(rd))


def _hits(name, mod, ro, rd):
    """(hit mask, t, material or None) of one intersector of `mod`."""
    if name == "sphere":
        t, _ = mod.intersect_sphere(ro, rd, mod.SP1_CENTER, mod.SP1_RADIUS)
        return t < mod.INF, t, None
    if name == "plane":
        t = mod.intersect_plane(ro, rd, (0.0, 2.0, 0.0), (0.0, -1.0, 0.0))
        return t < mod.INF, t, None
    if name == "aabb":
        hit, t, _, _ = mod.intersect_aabb(ro, rd, mod.BOX_MIN, mod.BOX_MAX)
        return hit, t, None
    if name == "aabb_transformed":
        hit, t, _ = mod.intersect_aabb_transformed(
            ro, rd, mod.BOX_MIN, mod.BOX_MAX, mod._BOX_M_INV, mod._BOX_M_INV_T)
        return hit, t, None
    if name == "light":
        hit, t = mod.intersect_light(ro, rd, mod.INF)
        return hit, t, None
    t, _, _, mat = mod.intersect_scene(ro, rd)
    return mat != mod.MAT_NONE, t, mat


@pytest.mark.parametrize("name", ["sphere", "plane", "aabb", "aabb_transformed", "light",
                                  "scene"])
def test_intersectors_match_jax(name):
    """Each intersector on 2,048 seeded rays against the JAX module's: hit
    masks (and intersect_scene's materials) equal on >= 99.9% of the rays,
    t at rtol 1e-5 where they agree. Measured: masks and materials equal
    on every ray for every intersector, t bit for bit but for the rotated
    box's (3.5e-6 relative at most: its transform's multiply-adds round
    apart from XLA's product)."""
    (ro_j, rd_j), (ro, rd) = _scene_rays()
    hit_j, t_j, mat_j = (None if x is None else np.asarray(x)
                         for x in _hits(name, an_jax, ro_j, rd_j))
    hit, t, mat = (None if x is None else x.numpy() for x in _hits(name, an, ro, rd))
    agree = hit == hit_j
    if mat is not None:
        agree &= mat == mat_j
    assert agree.mean() >= 0.999
    assert hit[agree].sum() > 100
    np.testing.assert_allclose(t[agree & hit], t_j[agree & hit], rtol=1e-5)


def test_box_constants_bit_identical():
    np.testing.assert_array_equal(an._BOX_M_INV, an_jax._BOX_M_INV)
    np.testing.assert_array_equal(an._BOX_M_INV_T, an_jax._BOX_M_INV_T)
    assert an._BOX_M_INV.dtype == np.float32


@pytest.mark.parametrize("sample", [0, 7, 24])
def test_camera_rays_match_jax(sample):
    """camera_rays at rtol 1e-6 (measured: within 2 float32 ulps; XLA:CPU
    contracts some of the constants' multiply-adds into FMAs); the pixel
    and sample ids equal."""
    ro_j, rd_j, pix_j, smp_j = (np.asarray(x) for x in an_jax.camera_rays((24, 16), sample, 5))
    ro, rd, pix, smp = (x.numpy() for x in an.camera_rays((24, 16), sample, 5, device="cpu"))
    np.testing.assert_array_equal(ro, ro_j)
    np.testing.assert_allclose(rd, rd_j, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(pix, pix_j)
    np.testing.assert_array_equal(smp, smp_j)


def _first_hits(bounce_res=(64, 32), seed=2):
    """Camera rays' first hits (2,048 rays): point, normal, color, material,
    direction, pixel and sample ids as NumPy arrays, from the JAX module."""
    ro, rd, pixel, sample = an_jax.camera_rays(bounce_res, 3, seed)
    t, nrm, col, mat = an_jax.intersect_scene(ro, rd)
    p = ro + t[:, None] * rd
    return [np.asarray(x) for x in (p, nrm, col, mat, rd, pixel, sample)]


def _vis_both(mod, p, nrm, pixel, sample, bounce, seed, dtype):
    """Visibility of both MIS strategies' light directions, as
    sample_direct_light draws them."""
    ux, uz = mod.rng.uniform2(seed, pixel, sample, bounce, mod.rng.U_LIGHT_U, dtype)
    stack = jnp.stack if mod is an_jax else torch.stack
    full = jnp.full_like if mod is an_jax else torch.full_like
    on_light = stack([ux * mod.LIGHT_X_RANGE + mod.LIGHT_X_MIN, full(ux, mod.LIGHT_Y),
                      uz * mod.LIGHT_Z_RANGE + mod.LIGHT_Z_MIN], 1)
    vis1 = mod.visible_to_light(p, mod.sampling.safe_normalize(on_light - p))
    u1, u2 = mod.rng.uniform2(seed, pixel, sample, bounce, mod.rng.U_BSDF_1, dtype)
    bdir = mod.sampling.rotate_z_to(nrm, mod.sampling.cosine_sample_hemisphere(u1, u2))
    return np.asarray(vis1), np.asarray(mod.visible_to_light(p, bdir))


def test_sampling_steps_match_jax():
    """sample_direct_light per ray against the JAX module's, where both
    strategies' visibility agrees, at rtol 1e-4 (measured: visibility
    agrees on every one of the 2,048 rays, li within 5e-7 relative);
    sample_ray_dir's direction and
    pdf at rtol 1e-4 on >= 99.9% of the rays (measured: every ray; the
    glass choice may flip on an ulp)."""
    p, nrm, col, mat, rd, pixel, sample = _first_hits()
    assert set(np.unique(mat)) >= {an.MAT_LAMBERT, an.MAT_SPECULAR, an.MAT_GLASS}
    seed, bounce = 4, 2
    li_j = np.asarray(an_jax.sample_direct_light(*(jnp.asarray(x) for x in (p, nrm, col, pixel,
                                                                          sample)), bounce, seed))
    args = [_t(x) for x in (p, nrm, col)] + [_t(pixel.astype(np.int64)),
                                             _t(sample.astype(np.int64))]
    li = an.sample_direct_light(*args, bounce, seed).numpy()
    vis_j = _vis_both(an_jax, *(jnp.asarray(x) for x in (p, nrm, pixel, sample)), bounce, seed,
                      jnp.float32)
    vis = _vis_both(an, *args[:2], *args[3:], bounce, seed, torch.float32)
    agree = (vis[0] == vis_j[0]) & (vis[1] == vis_j[1])
    assert agree.mean() >= 0.99 and (li[agree] > 0).any()
    np.testing.assert_allclose(li[agree], li_j[agree], rtol=1e-4, atol=1e-7)

    d_j, pdf_j = (np.asarray(x) for x in an_jax.sample_ray_dir(
        *(jnp.asarray(x) for x in (rd, nrm, mat, pixel, sample)), bounce, seed))
    d, pdf = (x.numpy() for x in an.sample_ray_dir(
        _t(rd), _t(nrm), _t(mat), _t(pixel.astype(np.int64)), _t(sample.astype(np.int64)),
        bounce, seed))
    close = (np.isclose(d, d_j, rtol=1e-4, atol=1e-6).all(axis=1)
             & np.isclose(pdf, pdf_j, rtol=1e-4))
    assert close.mean() >= 0.999


def test_render_matches_jax():
    """render at 24x24, 1 spp, depth 3 against the JAX module's: >= 99% of
    the values close at rtol 1e-3 (atol 1e-6) and the mean within 1e-3
    relative. The bounce loop and the glass choice can part two
    implementations' paths on an ulp, so the image is compared by
    statistics. Measured: every value close, the means 7e-8 apart."""
    hdr_j = np.asarray(an_jax.render(res=(24, 24), spp=1, seed=0, max_depth=3))
    hdr = an.render(res=(24, 24), spp=1, seed=0, max_depth=3, device="cpu").numpy()
    assert hdr.shape == hdr_j.shape == (24, 24, 3)
    assert np.isclose(hdr, hdr_j, rtol=1e-3, atol=1e-6).mean() >= 0.99
    assert abs(hdr.mean() - hdr_j.mean()) <= 1e-3 * hdr_j.mean()


def test_render_takes_an_explicit_device():
    """render and camera_rays have no default device; every function
    computes on the device of its inputs."""
    with pytest.raises(TypeError):
        an.render(res=(4, 4), spp=1)
    with pytest.raises(TypeError):
        an.camera_rays((4, 4), 0, 0)
    ro, rd, _, _ = an.camera_rays((4, 4), 0, 0, device="cpu")
    assert ro.device.type == rd.device.type == "cpu"
    assert an.intersect_scene(ro, rd)[0].device.type == "cpu"
