"""Gradients of pyrenderer_tpu_torch (torch autograd) against jax.grad of the
JAX package, central finite differences, the card's kernels and the cluster
backend (mirrors tests/test_grad.py and tests/test_cluster.py
::test_grad_flows_with_cluster_backend).

With the counter-based RNG the fixed-seed estimator is a deterministic
function of the scene parameters; where a perturbation flips no discrete
decision (hit ids, visibility), central differences of the same estimator
converge to the detached-sampling gradient. Float64 on the CPU, Cornell at
12x12 as in tests/test_grad.py; backend "auto" is "brute" in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyrenderer_tpu.config import RenderConfig as JaxConfig
from pyrenderer_tpu.core.integrator import render_sample as render_sample_jax
from pyrenderer_tpu.scene.tungsten import load_tungsten as load_jax
from pyrenderer_tpu_torch.accel import clusters as cl
from pyrenderer_tpu_torch.config import RenderConfig
from pyrenderer_tpu_torch.core import integrator as integ
from pyrenderer_tpu_torch.core import integrator_pbrt as integ_pbrt
from pyrenderer_tpu_torch.dist.render import pixel_grid, render_field
from pyrenderer_tpu_torch.scene import procgen, to_device
from pyrenderer_tpu_torch.scene.tungsten import build_scene

torch.set_num_threads(2)

RES = 12
PARAMS = ("vertices", "albedo", "emission")


@pytest.fixture(scope="module")
def cornell64(cornell_path):
    """The host Cornell box in float64 (the JAX loader's NumPy arrays, which
    both packages take), its camera at 12x12 and every pixel."""
    host, camera, _ = load_jax(cornell_path, dtype=np.float64)
    camera = camera._replace(resolution=(RES, RES))
    ys, xs = np.mgrid[0:RES, 0:RES]
    return host, camera, xs.reshape(-1).astype(np.int32), ys.reshape(-1).astype(np.int32)


def _grey(host, value=0.7):
    """Every albedo grey, so that the throughput's channels tie."""
    return host._replace(albedo=np.full_like(host.albedo, value))


def jax_loss_and_grads(host, camera, cfg, px, py):
    """jax.grad of tests/test_grad.py's loss (render_sample summed over the
    pixels, averaged over spp) w.r.t. (vertices, albedo, emission)."""
    with jax.enable_x64(True):
        s = jax.tree.map(jnp.asarray, host)
        px_j, py_j = jnp.asarray(px), jnp.asarray(py)

        def loss(vertices, albedo, emission):
            sc = s._replace(vertices=vertices, albedo=albedo, emission=emission)
            total = 0.0
            for smp in range(cfg.spp):
                total = total + render_sample_jax(sc, camera, cfg, cfg.seed, jnp.uint32(smp),
                                                  px_j, py_j).sum()
            return total / cfg.spp

        val, g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2)))(
            s.vertices, s.albedo, s.emission)
        return float(val), [np.asarray(x) for x in g]


def torch_loss(host, camera, cfg, backend="auto", accel=None, px=None, py=None):
    """The same loss in the port, as a function of (vertices, albedo,
    emission), and the port's float64 scene on the CPU."""
    scene, cam = to_device(host, camera, "cpu", torch.float64)
    if px is None:
        px, py = pixel_grid(cam)
    else:
        px, py = torch.from_numpy(px.astype(np.int64)), torch.from_numpy(py.astype(np.int64))

    def loss(vertices, albedo, emission):
        s = scene._replace(vertices=vertices, albedo=albedo, emission=emission)
        if backend == "auto":
            img = render_field(s, cam, cfg, px, py, accel=accel)
        else:
            img = integ.render_block(s, cam, cfg, cfg.seed, cfg.spp, px, py, backend=backend,
                                     accel=accel)
        return img.sum()

    return loss, scene


def torch_grads(loss, scene):
    params = [getattr(scene, k).clone().requires_grad_() for k in PARAMS]
    val = loss(*params)
    grads = torch.autograd.grad(val, params, allow_unused=True, materialize_grads=True)
    return float(val.detach()), [g.numpy() for g in grads]


def assert_grads_match_jax(host, camera, cfg, px, py):
    cfg_j = JaxConfig(max_bounces=cfg.max_bounces, spp=cfg.spp, seed=cfg.seed,
                      estimator=cfg.estimator)
    val_j, g_j = jax_loss_and_grads(host, camera, cfg_j, px, py)
    loss, scene = torch_loss(host, camera, cfg, px=px, py=py)
    val_t, g_t = torch_grads(loss, scene)
    np.testing.assert_allclose(val_t, val_j, rtol=1e-10)
    for name, a, b in zip(PARAMS, g_t, g_j):
        scale = float(np.abs(b).max())
        print(f"{name}: max|g| {scale:.6g}, max|port - jax| {float(np.abs(a - b).max()):.3g}")
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-8 * scale, err_msg=name)
    return g_j


@pytest.mark.parametrize("estimator", ["reference", "pbrt"])
def test_grad_matches_jax(cornell64, estimator):
    """All three parameters' gradients equal jax.grad's to 1e-8 of each
    parameter's largest |g| (3 bounces, 2 spp, seed 5)."""
    host, camera, px, py = cornell64
    cfg = RenderConfig(max_bounces=3, spp=2, seed=5, estimator=estimator)
    g = assert_grads_match_jax(host, camera, cfg, px, py)
    assert np.abs(g[0]).max() > 0 and np.abs(g[1]).max() > 0
    # the reference estimator ignores the scene's emission
    assert (np.abs(g[2]).max() > 0) == (estimator == "pbrt")


def test_pbrt_rr_grad_matches_jax(cornell64):
    """Russian roulette (from bounce 4 of 6) under a grey albedo, where the
    throughput's channels tie: the continuation probability's gradient must
    split among the tied channels as jnp.max's does (torch.max(dim) gives
    it all to one channel)."""
    host, camera, px, py = cornell64
    cfg = RenderConfig(max_bounces=6, spp=2, seed=5, estimator="pbrt")
    assert cfg.russian_roulette_start < cfg.max_bounces
    g = assert_grads_match_jax(_grey(host), camera, cfg, px, py)
    assert np.abs(g[1]).max() > 0


@pytest.mark.parametrize("estimator", ["reference", "pbrt"])
def test_grad_albedo_vs_fd(cornell64, estimator):
    host, camera, _, _ = cornell64
    cfg = RenderConfig(max_bounces=3, spp=2, seed=5, estimator=estimator)
    loss, scene = torch_loss(host, camera, cfg)
    g = torch_grads(loss, scene)[1][1]
    eps = 1e-5
    checked = 0
    with torch.no_grad():
        for mi, ci in [(0, 0), (2, 1), (5, 2), (6, 0)]:
            a_p, a_m = scene.albedo.clone(), scene.albedo.clone()
            a_p[mi, ci] += eps
            a_m[mi, ci] -= eps
            fd = float(loss(scene.vertices, a_p, scene.emission)
                       - loss(scene.vertices, a_m, scene.emission)) / (2 * eps)
            if abs(fd) > 1e-6:
                np.testing.assert_allclose(g[mi, ci], fd, rtol=1e-5)
                checked += 1
    assert checked >= 3


def test_grad_emission_vs_fd(cornell64):
    host, camera, _, _ = cornell64
    cfg = RenderConfig(max_bounces=3, spp=2, seed=5, estimator="pbrt")
    loss, scene = torch_loss(host, camera, cfg)
    g = torch_grads(loss, scene)[1][2]
    light_mat = int(host.face_material[-1])
    checked = 0
    with torch.no_grad():
        for ci in range(3):
            e_p, e_m = scene.emission.clone(), scene.emission.clone()
            e_p[light_mat, ci] += 1e-4
            e_m[light_mat, ci] -= 1e-4
            fd = float(loss(scene.vertices, scene.albedo, e_p)
                       - loss(scene.vertices, scene.albedo, e_m)) / 2e-4
            assert fd > 0  # more emission -> brighter
            np.testing.assert_allclose(g[light_mat, ci], fd, rtol=1e-5)
            checked += 1
    assert checked >= 3


class Decisions:
    """Records the discrete outcome of every query of a render: per
    closest-hit query the face where it hit (-1 elsewhere), per any-hit
    query the occlusion. Wraps the integrator's _closest and _any_hit in
    core.integrator and in core.integrator_pbrt, which imports them by
    name."""

    def __init__(self, monkeypatch):
        self.log = []
        closest, any_hit = integ._closest, integ._any_hit

        def rec_closest(*args, **kwargs):
            hit, t, tri = closest(*args, **kwargs)
            self.log.append(torch.where(hit, tri.to(torch.int64), -1))
            return hit, t, tri

        def rec_any_hit(*args, **kwargs):
            occ = any_hit(*args, **kwargs)
            self.log.append(occ.clone())
            return occ

        for mod in (integ, integ_pbrt):
            monkeypatch.setattr(mod, "_closest", rec_closest)
            monkeypatch.setattr(mod, "_any_hit", rec_any_hit)

    def run(self, fn, *args):
        """(fn(*args) as a float, the decisions it took)."""
        self.log = []
        with torch.no_grad():
            val = float(fn(*args))
        out, self.log = self.log, []
        return val, out

    @staticmethod
    def same(a, b):
        return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("estimator", ["reference", "pbrt"])
def test_grad_vertices_vs_fd(cornell64, estimator, monkeypatch):
    """Every vertex gradient against central differences, with the straddle
    detector: an entry whose +eps or -eps render takes another hit id or
    visibility than the unperturbed one on any lane is skipped; every other
    entry must agree (rtol 1e-4, atol 1e-6)."""
    host, camera, _, _ = cornell64
    cfg = RenderConfig(max_bounces=2, spp=1, seed=5, estimator=estimator)
    loss, scene = torch_loss(host, camera, cfg)
    g = torch_grads(loss, scene)[1][0]
    dec = Decisions(monkeypatch)
    v, a, e = scene.vertices, scene.albedo, scene.emission
    _, base = dec.run(loss, v, a, e)
    assert len(base) == 2 * cfg.max_bounces
    # the detector sees the flips of a move far larger than eps (a back
    # wall corner, half the box's width)
    moved = v.clone()
    moved[host.faces[4, 0], 0] += 1.0
    assert not dec.same(dec.run(loss, moved, a, e)[1], base)
    eps = 1e-6
    skipped, agree, signal = [], 0, 0
    for vid in range(v.shape[0]):
        for ci in range(3):
            v_p, v_m = v.clone(), v.clone()
            v_p[vid, ci] += eps
            v_m[vid, ci] -= eps
            l_p, d_p = dec.run(loss, v_p, a, e)
            l_m, d_m = dec.run(loss, v_m, a, e)
            if not (dec.same(d_p, base) and dec.same(d_m, base)):
                skipped.append((vid, ci))
                continue
            fd = (l_p - l_m) / (2 * eps)
            np.testing.assert_allclose(g[vid, ci], fd, rtol=1e-4, atol=1e-6,
                                       err_msg=f"vertex {vid}, axis {ci}")
            agree += 1
            signal += abs(fd) > 1e-4
    print(f"{estimator}: {agree} of {v.numel()} entries agree with FD ({signal} with "
          f"|fd| > 1e-4), {len(skipped)} skipped for a flipped decision: {skipped}")
    assert signal >= 4


def _two_light_scene(host):
    """Cornell with a second light prim of one face (the tall box's top
    face made emissive), so that the first prim's row of light_faces holds
    two faces and the second's one face and its padding copy."""
    light_mat = int(host.face_material[-1])
    face = 26
    fm = host.face_material.copy()
    fm[face] = light_mat
    lf = np.stack([host.light_faces[0], np.array([face, face], host.light_faces.dtype)])
    return host._replace(face_material=fm, light_faces=lf,
                         light_nfaces=np.array([2, 1], host.light_nfaces.dtype))


def test_two_light_grad_matches_jax(cornell64):
    """Two light prims of different face counts: light_faces pads the
    shorter row by repeating a face, and the area pdf's vertex gradient
    must count that face once, as the JAX package's scatter does (pbrt:
    the reference estimator does not use the pdf)."""
    host, camera, px, py = cornell64
    cfg = RenderConfig(max_bounces=2, spp=1, seed=5, estimator="pbrt")
    assert_grads_match_jax(_two_light_scene(host), camera, cfg, px, py)


@pytest.fixture(scope="module")
def terrain16():
    host, camera, _ = build_scene(procgen.big_scene_data("terrain", res=16))
    return host, camera._replace(resolution=(8, 8))


@pytest.mark.parametrize("backend", ["cluster", "cluster_binned", "cluster_streamed",
                                     "cluster_chunked", "bvh", "watertight"])
def test_grad_cluster_backend(terrain16, backend, monkeypatch):
    """The other backends' gradients (through the kernels' CPU twins, the
    BVH or the watertight test) are finite and non-zero, and equal "brute"'s on the lanes
    whose hit ids and visibility agree between the two (the loss summed
    over those pixels). "cluster_chunked" gets three chunks."""
    host, camera = terrain16
    cfg = RenderConfig(max_bounces=2, spp=1, seed=0, estimator="reference")
    scene, cam = to_device(host, camera, "cpu", torch.float64)
    if backend == "cluster_chunked":
        accel = cl.build_chunked_clusters(scene.vertices, scene.faces,
                                          max_tris=-(-scene.faces.shape[0] // 3))
        assert isinstance(accel, cl.ClusterChunks)
    else:
        accel = integ.maybe_build_accel(scene, backend)
        assert isinstance(accel, cl.ClusterScene) == backend.startswith("cluster")
    px, py = pixel_grid(cam)
    dec = Decisions(monkeypatch)

    def image(b, acc):
        def fn(vertices, albedo, emission):
            s = scene._replace(vertices=vertices, albedo=albedo, emission=emission)
            return integ.render_block(s, cam, cfg, cfg.seed, cfg.spp, px, py, backend=b,
                                      accel=acc)
        return fn

    img_c, img_b = image(backend, accel), image("brute", None)
    params = [getattr(scene, k) for k in PARAMS]
    _, d_c = dec.run(lambda *p: img_c(*p).sum(), *params)
    _, d_b = dec.run(lambda *p: img_b(*p).sum(), *params)
    assert len(d_c) == len(d_b) == 2 * cfg.max_bounces
    keep = torch.stack([x == y for x, y in zip(d_c, d_b)]).all(dim=0)
    print(f"{backend}: {int(keep.sum())} of {keep.numel()} lanes decide as brute does")
    assert keep.float().mean() > 0.9

    grads = {}
    for name, fn in ((backend, img_c), ("brute", img_b)):
        params = [getattr(scene, k).clone().requires_grad_() for k in PARAMS]
        img = fn(*params)
        grads[name] = torch.autograd.grad(img[keep].sum(), params, allow_unused=True,
                                          materialize_grads=True)
    for k, gc, gb in zip(PARAMS, grads[backend], grads["brute"]):
        assert bool(torch.isfinite(gc).all()), k
        torch.testing.assert_close(gc, gb, rtol=1e-10, atol=1e-12 * float(gb.abs().max()),
                                   msg=k)
    assert float(grads[backend][1].abs().sum()) > 0
    assert float(grads[backend][0].abs().sum()) > 0


@pytest.mark.cuda
def test_grad_kernels_match_brute_on_card(cornell_path):
    """chip_smoke phase 22(a) at 64x64: the gradients through the whole-table
    kernels (backend "cuda") against the plain Moeller-Trumbore ("brute")
    on the card, float32, with the kernels launched and no twin called."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pyrenderer_tpu_torch import kernels

    host, camera, _ = load_jax(cornell_path)
    scene, cam = to_device(host, camera._replace(resolution=(64, 64)), "cuda:0")
    cfg = RenderConfig(max_bounces=4, spp=4, seed=0, estimator="reference")
    px, py = pixel_grid(cam)
    grads = {}
    for backend in ("cuda", "brute"):
        params = [getattr(scene, k).clone().requires_grad_() for k in PARAMS]
        s = scene._replace(**dict(zip(PARAMS, params)))
        kernels.reset_counters()
        img = integ.render_block(s, cam, cfg, cfg.seed, cfg.spp, px, py, backend=backend)
        grads[backend] = torch.autograd.grad(img.sum(), params, allow_unused=True,
                                             materialize_grads=True)
        launches, twins = kernels.counts()
        assert not twins
        per = cfg.spp * cfg.max_bounces if backend == "cuda" else 0
        assert launches.get("closest_hit", 0) == per and launches.get("occluded", 0) == per
    for k, gc, gb in zip(PARAMS, grads["cuda"], grads["brute"]):
        assert bool(torch.isfinite(gc).all()), k
        rel = float(torch.linalg.vector_norm(gc - gb) / torch.linalg.vector_norm(gb).clamp_min(
            1e-30))
        assert rel <= 1e-5, (k, rel)


def test_maximum_minimum_tie_gradient():
    """sampling.maximum / minimum against a constant: torch.clamp's values
    (bit for bit, also without a gradient) and jnp.maximum / jnp.minimum's
    gradients, half of it at a tie."""
    from pyrenderer_tpu_torch.core import sampling

    xs = np.array([0.05, 0.02, 0.5, 1.0, 1.5], np.float64)
    for fn, jfn, c, clamp in ((sampling.maximum, jnp.maximum, 0.05, dict(min=0.05)),
                              (sampling.minimum, jnp.minimum, 1.0, dict(max=1.0))):
        x = torch.tensor(xs, requires_grad=True)
        y = fn(x, c)
        assert torch.equal(y.detach(), torch.clamp(x.detach(), **clamp))
        assert torch.equal(fn(x.detach(), c), torch.clamp(x.detach(), **clamp))
        (g,) = torch.autograd.grad(y.sum(), x)
        with jax.enable_x64(True):
            g_j = jax.grad(lambda v: jfn(v, c).sum())(jnp.asarray(xs))
        np.testing.assert_array_equal(g.numpy(), np.asarray(g_j))
