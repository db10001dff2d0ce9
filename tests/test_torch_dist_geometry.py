"""pyrenderer_tpu_torch's dist/geometry.py: the triangles sharded over "gp"
in gloo worlds of CPU ranks, mirroring tests/test_dist_geometry.py case by
case.

The module spawns two worlds, once each: four ranks for the (dp, gp) =
(1, 4) and (2, 2) layouts, and three for gp = 3, where terrain8k's 8,204
triangles leave the last shard one zero row of padding. Every scenario of
a world runs in _rank4 / _rank3 (processes that import the port and no
JAX); the tests compare the saved results with the port's one-process
render and train_step, and with the JAX package's functions on the
conftest's 8-device mesh (make_geom_mesh(8, gp=4, dp=2)) in float64. On
the CPU each shard's query runs the twins of B1/B2 (kernels/intersect.py)
or of B3/B4 (kernels/cluster.py).
"""

import os
import sys

import numpy as np
import pytest
import torch

from pyrenderer_tpu_torch.accel.clusters import build_clusters
from pyrenderer_tpu_torch.config import RenderConfig
from pyrenderer_tpu_torch.core.integrator import render_block
from pyrenderer_tpu_torch.dist.geometry import build_shard_clusters, shard_geometry
from pyrenderer_tpu_torch.dist.render import train_step
from pyrenderer_tpu_torch.scene import load_tungsten, procgen, to_device
from pyrenderer_tpu_torch.scene.tungsten import build_scene
from tests.torch_fixtures import REPO, private_jax_native_cache, spawn_world  # noqa: F401

torch.set_num_threads(2)

CORNELL = os.path.join(REPO, "tests", "data", "cornell_box.json")
CFG = RenderConfig(max_bounces=3, spp=2, seed=5)      # tests/test_dist_geometry.py's
CFG_PBRT = RenderConfig(max_bounces=3, spp=2, seed=1, estimator="pbrt")
CFG_GRAD = RenderConfig(max_bounces=2, spp=1, seed=3)
CFG_TERRAIN = RenderConfig(max_bounces=2, spp=1, seed=2)
LR = 0.1
LAYOUTS = {"dp1gp4": (1, 4), "dp2gp2": (2, 2)}


def _cornell(dtype):
    host, camera, _ = load_tungsten(CORNELL, dtype=np.float64 if dtype == torch.float64
                                    else np.float32)
    return to_device(host, camera._replace(resolution=(16, 16)), "cpu", dtype)


def _terrain():
    """terrain8k (8,204 triangles) at 16x16: the host scene and the port's."""
    host, camera, _ = build_scene(procgen.big_scene_data("terrain", res=64))
    camera = camera._replace(resolution=(16, 16))
    return host, camera, *to_device(host, camera, "cpu")


def _pixels(n=64, w=16, h=16):
    """tests/test_dist_geometry.py's pixels: every third of the image."""
    idx = torch.arange(n) * 3 % (w * h)
    return idx % w, idx // w


def _one_process(scene, camera, cfg, px, py, backend="brute", accel=None):
    return render_block(scene, camera, cfg, cfg.seed, cfg.spp, px, py, backend=backend,
                        accel=accel)


def _rank_common(rank, world, init):
    import torch.distributed as dist

    from pyrenderer_tpu_torch.dist import multihost

    torch.set_num_threads(1)
    assert multihost.initialize(init, world, rank, device="cpu") is True
    return dist


def _field(scene, camera, cfg, mesh, px, py, cluster_stack=None):
    """The whole field from every rank's slice (an all-gather in rank
    order)."""
    from pyrenderer_tpu_torch.dist.geometry import render_field_geometry_sharded
    from pyrenderer_tpu_torch.dist.render import all_gather

    with torch.no_grad():
        part = render_field_geometry_sharded(scene, camera, cfg, mesh, px, py,
                                             cluster_stack=cluster_stack)
        return all_gather(part).flatten(0, 1)


def _step(scene, camera, cfg, mesh, px, py):
    from pyrenderer_tpu_torch.dist.geometry import train_step_geometry

    target = torch.zeros((px.shape[0], 3), dtype=scene.vertices.dtype)
    params = (scene.vertices, scene.albedo, scene.emission)
    return train_step_geometry(params, scene, camera, cfg, mesh, target, px, py, LR)


def _rank4(rank, world, init, out_dir):
    """The four-rank world's scenarios; saves them to out_dir/rank{rank}.pt."""
    dist = _rank_common(rank, world, init)
    from pyrenderer_tpu_torch.dist.geometry import make_geom_mesh
    from pyrenderer_tpu_torch.dist.render import axis_index

    try:
        out = {"default": tuple(make_geom_mesh().shape)}
        meshes = {k: make_geom_mesh(dp=dp, gp=gp) for k, (dp, gp) in LAYOUTS.items()}
        px, py = _pixels()
        for dtype in (torch.float32, torch.float64):
            scene, camera = _cornell(dtype)
            for k, m in meshes.items():
                out[f"render_{k}_{dtype}"] = _field(scene, camera, CFG, m, px, py)
            out[f"pbrt_{dtype}"] = _field(scene, camera, CFG_PBRT, meshes["dp2gp2"], px, py)
        scene, camera = _cornell(torch.float64)
        gx, gy = _pixels(32)
        for k, m in meshes.items():
            out[f"grad_{k}"] = _step(scene, camera, CFG_GRAD, m, gx, gy)
        scene, camera = _cornell(torch.float32)
        out["runs"] = _step(scene, camera, CFG.replace(max_bounces=2, seed=0),
                            meshes["dp1gp4"], gx, gy)
        host, _, scene, camera = _terrain()
        m = meshes["dp1gp4"]
        cs = build_shard_clusters(scene, 4, rank=axis_index(m, "gp"))
        out["terrain_brute"] = _field(scene, camera, CFG_TERRAIN, m, px, py)
        out["terrain_cluster"] = _field(scene, camera, CFG_TERRAIN, m, px, py, cs)
        out["jax_imported"] = any(n == "jax" or n.startswith(("jax.", "pyrenderer_tpu."))
                                  for n in sys.modules)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


def _rank3(rank, world, init, out_dir):
    """The three-rank world (gp = 3): saves to out_dir/rank{rank}.pt."""
    dist = _rank_common(rank, world, init)
    from pyrenderer_tpu_torch.dist.geometry import make_geom_mesh

    try:
        mesh = make_geom_mesh(gp=3)
        px, py = _pixels(48)
        scene, camera = _cornell(torch.float64)
        out = {"cornell": _field(scene, camera, CFG, mesh, px, py),
               "grad": _step(scene, camera, CFG_GRAD, mesh, *_pixels(24))}
        host, _, scene, camera = _terrain()
        out["terrain_brute"] = _field(scene, camera, CFG_TERRAIN, mesh, px, py)
        out["terrain_cluster"] = _field(scene, camera, CFG_TERRAIN, mesh, px, py,
                                        build_shard_clusters(host, 3))
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return spawn_world("tests.test_torch_dist_geometry:_rank4", 4,
                       tmp_path_factory.mktemp("world4"))


@pytest.fixture(scope="module")
def world3(tmp_path_factory):
    return spawn_world("tests.test_torch_dist_geometry:_rank3", 3,
                       tmp_path_factory.mktemp("world3"))


def _jax_geometry(cfg, fn, *args):
    """fn(scene, camera, jax cfg, make_geom_mesh(8, gp=4, dp=2), *args) of
    the JAX package in float64 on the Cornell box at 16x16."""
    import jax
    import jax.numpy as jnp

    from pyrenderer_tpu.config import RenderConfig as JaxConfig
    from pyrenderer_tpu.dist.geometry import make_geom_mesh
    from pyrenderer_tpu.scene.tungsten import load_tungsten as load_jax

    host, camera, _ = load_jax(CORNELL, dtype=np.float64)
    jcfg = JaxConfig(max_bounces=cfg.max_bounces, spp=cfg.spp, seed=cfg.seed,
                     estimator=cfg.estimator)
    with jax.enable_x64(True):
        scene = jax.tree.map(jnp.asarray, host)
        return fn(scene, camera._replace(resolution=(16, 16)), jcfg,
                  make_geom_mesh(8, gp=4, dp=2), *args)


def _jax_field(cfg, n=64):
    import jax.numpy as jnp

    from pyrenderer_tpu.dist.geometry import render_field_geometry_sharded

    px, py = (jnp.asarray(x.numpy(), jnp.int32) for x in _pixels(n))
    return np.asarray(_jax_geometry(cfg, render_field_geometry_sharded, px, py))


def test_world_layouts(world4, world3):
    assert len(world4) == 4 and len(world3) == 3
    assert all(out["default"] == (1, 4) and out["jax_imported"] is False for out in world4)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_geometry_sharded_matches_single_device(world4, layout):
    """float32 against the one-process brute render (JAX's tolerance), and
    float64 against the JAX package's sharded render."""
    px, py = _pixels()
    scene, camera = _cornell(torch.float32)
    want = _one_process(scene, camera, CFG, px, py).numpy()
    for out in world4:
        np.testing.assert_allclose(out[f"render_{layout}_{torch.float32}"].numpy(), want,
                                   rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(world4[0][f"render_{layout}_{torch.float64}"].numpy(),
                               _jax_field(CFG), rtol=2e-5, atol=2e-6)


def test_geometry_sharded_pbrt_estimator(world4):
    px, py = _pixels()
    scene, camera = _cornell(torch.float32)
    want = _one_process(scene, camera, CFG_PBRT, px, py).numpy()
    np.testing.assert_allclose(world4[1][f"pbrt_{torch.float32}"].numpy(), want,
                               rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(world4[2][f"pbrt_{torch.float64}"].numpy(),
                               _jax_field(CFG_PBRT), rtol=2e-5, atol=2e-6)


def _single_step(n=32):
    scene, camera = _cornell(torch.float64)
    px, py = _pixels(n)
    params = (scene.vertices, scene.albedo, scene.emission)
    target = torch.zeros((px.shape[0], 3), dtype=torch.float64)
    return params, train_step(params, scene, camera, CFG_GRAD, target, px, py, LR)


def _assert_step(params, got, want, rtol):
    (loss, new), (loss_1, new_1) = got, want
    np.testing.assert_allclose(float(loss), float(loss_1), rtol=rtol)
    for p, q, q1 in zip(params, new, new_1):
        q, q1, p = (np.asarray(x) for x in (q, q1, p))
        np.testing.assert_allclose(q, q1, rtol=rtol, atol=1e-15)
        np.testing.assert_allclose(q - p, q1 - p, rtol=0,
                                   atol=rtol * float(np.abs(q1 - p).max()))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_geometry_sharded_gradients_match(world4, layout):
    """float64: train_step_geometry's loss and new params on every rank
    equal the one-process train_step's to rtol 1e-10 (the face rows'
    gradients reach their owners once, the replicated light rows' are
    summed once), and the JAX package's train_step_geometry to 1e-8."""
    params, single = _single_step()
    for out in world4:
        _assert_step(params, out[f"grad_{layout}"], single, 1e-10)
        assert float((out[f"grad_{layout}"][1][0] - params[0]).abs().max()) > 0

    import jax.numpy as jnp

    from pyrenderer_tpu.dist.geometry import train_step_geometry

    def jax_step(scene, camera, cfg, mesh):
        px, py = (jnp.asarray(x.numpy(), jnp.int32) for x in _pixels(32))
        params_j = (scene.vertices, scene.albedo, scene.emission)
        loss, new = train_step_geometry(params_j, scene, camera, cfg, mesh,
                                        jnp.zeros((32, 3)), px, py, LR)
        return float(loss), [np.asarray(q) for q in new]

    _assert_step(params, world4[3][f"grad_{layout}"], _jax_geometry(CFG_GRAD, jax_step),
                 1e-8)


def test_geometry_sharded_cluster_accel_matches_brute(world4):
    """Each rank's own ClusterScene (build_shard_clusters) against the
    per-shard B1/B2 twins on terrain8k at gp = 4 (JAX's criterion: > 99%
    of the values close, only fp-tie faces may differ); the B1/B2 frame
    equal to the one-process brute render."""
    px, py = _pixels()
    host, _, scene, camera = _terrain()
    got = world4[0]["terrain_cluster"].numpy()
    brute = world4[0]["terrain_brute"].numpy()
    assert np.isfinite(got).all() and got.max() > 0.01
    assert np.isclose(got, brute, rtol=1e-3, atol=1e-4).mean() > 0.99
    np.testing.assert_allclose(brute, _one_process(scene, camera, CFG_TERRAIN, px, py).numpy(),
                               rtol=2e-5, atol=2e-6)


def test_train_step_geometry_runs(world4):
    for out in world4:
        loss, new = out["runs"]
        assert np.isfinite(float(loss)) and float(loss) > 0
        assert all(bool(torch.isfinite(q).all()) for q in new)


def test_shard_geometry_pads_and_matches_jax():
    """gp = 3 over terrain8k: ceil(8,204 / 3) = 2,735 rows a shard, the one
    pad row zero, every stack equal to the JAX package's shard_geometry;
    build_shard_clusters(rank=g) is the g-th of the list rank=None gives."""
    import jax.numpy as jnp

    from pyrenderer_tpu.config import RenderConfig as JaxConfig
    from pyrenderer_tpu.dist.geometry import shard_geometry as shard_geometry_jax

    host, _, scene, _ = _terrain()
    (v0, e1, e2), faces, lights = shard_geometry(scene, CFG, 3)
    assert v0.shape == (3, 2735, 3) and faces.shape == (3, 2735, 16)
    assert not bool(faces[2, -1].any()) and not bool(e1[2, -1].any())
    (v0j, e1j, e2j), faces_j, lights_j = shard_geometry_jax(
        type(host)(*[jnp.asarray(x) for x in host]), JaxConfig(), 3)
    for a, b in ((v0, v0j), (e1, e1j), (e2, e2j), (faces, faces_j), (lights, lights_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    shards = build_shard_clusters(host, 3)
    one = build_shard_clusters(host, 3, rank=2)
    assert len(shards) == 3 and torch.equal(one.order, shards[2].order)
    whole = build_clusters(host.vertices, host.faces)
    assert sum(s.n_clusters for s in shards) >= whole.n_clusters


def test_padded_gp3(world3):
    """gp = 3: Cornell (36 triangles, no pad) in float64 and terrain8k (one
    zero pad row in the last shard) through the B1/B2 twins, equal to the
    one-process brute renders; the padded cluster shards against them; and
    a float64 train step equal to the one-process one to rtol 1e-10."""
    px, py = _pixels(48)
    scene, camera = _cornell(torch.float64)
    want = _one_process(scene, camera, CFG, px, py).numpy()
    host, _, tscene, tcamera = _terrain()
    want_t = _one_process(tscene, tcamera, CFG_TERRAIN, px, py).numpy()
    params, single = _single_step(24)
    for out in world3:
        np.testing.assert_allclose(out["cornell"].numpy(), want, rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(out["terrain_brute"].numpy(), want_t, rtol=2e-5, atol=2e-6)
        got = out["terrain_cluster"].numpy()
        assert np.isfinite(got).all()
        assert np.isclose(got, want_t, rtol=1e-3, atol=1e-4).mean() > 0.99
        _assert_step(params, out["grad"], single, 1e-10)
