"""pyrenderer_tpu_torch's dist/render.py sharded over a gloo world of four
CPU ranks (make_mesh, render_field_sharded, gather_dp, train_step(mesh=...)),
mirroring tests/test_dist.py case by case.

The module spawns its world once (_rank, in four processes that import the
port and no JAX) and runs every scenario in it; the tests compare the saved
results with the port's one-process render_field / train_step and with the
JAX package's functions on the conftest's 8-device mesh (make_mesh(8, dp=4,
sp=2)). The JAX comparisons run in float64, where the two packages agree
to rounding; in float32 a grazing shadow ray may flip between them (ROADMAP
C4), so the cluster scenes, float32 only, are held to the JAX render by the
criterion of tests/test_torch_cluster.py.

tests/test_dist.py:138 and :198 check how Pallas kernels type and execute
inside jax.shard_map; a rank of the port is an ordinary process, so they
have no counterpart here.
"""

import os
import sys

import numpy as np
import pytest
import torch

from pyrenderer_tpu_torch.accel.clusters import (ClusterChunks, build_chunked_clusters,
                                                 build_clusters)
from pyrenderer_tpu_torch.config import RenderConfig
from pyrenderer_tpu_torch.core.integrator import render_block, resolve_backend
from pyrenderer_tpu_torch.dist.render import pixel_grid, render_field, train_step
from pyrenderer_tpu_torch.scene import load_tungsten, procgen, to_device
from pyrenderer_tpu_torch.scene.tungsten import build_scene
from tests.torch_fixtures import REPO, private_jax_native_cache, spawn_world  # noqa: F401

torch.set_num_threads(2)

WORLD = 4
CORNELL = os.path.join(REPO, "tests", "data", "cornell_box.json")
CORNELL_MESH = os.path.join(REPO, "scenes", "cornell_mesh.json")
CFG = RenderConfig(max_bounces=3, spp=4, seed=5)                 # tests/test_dist.py's
CFG5 = RenderConfig(max_bounces=4, spp=8, seed=1, estimator="pbrt", stratified=True)
CFG_TRAIN = RenderConfig(max_bounces=3, spp=4, seed=0)
LR = (1e-3, 2.0, 0.5)
MESHES = {"dp2sp2": (2, 2), "dp4sp1": (4, 1), "dp1sp4": (1, 4)}


def _cornell(dtype, res=16, path=CORNELL):
    """The scene loaded in `dtype` (float64 parsed as float64, as the JAX
    package's loader does), at res x res."""
    host, camera, _ = load_tungsten(path, dtype=np.float64 if dtype == torch.float64
                                    else np.float32)
    return to_device(host, camera._replace(resolution=(res, res)), "cpu", dtype)


def _terrain():
    """terrain8k (8,204 triangles), 16x16, tests/test_dist.py's config."""
    host, host_camera, cfg = build_scene(procgen.big_scene_data("terrain", res=64))
    host_camera = host_camera._replace(resolution=(16, 16))
    scene, camera = to_device(host, host_camera, "cpu")
    return (host, host_camera), scene, camera, cfg.replace(max_bounces=2, spp=2, seed=4)


def _train_start(scene):
    """tests/test_torch_train.py's start: the reddest albedo set to grey."""
    alb = scene.albedo.clone()
    alb[int(torch.argmax(alb[:, 0] - alb[:, 1]))] = 0.5
    return (scene.vertices, alb, scene.emission)


def _rank(rank, world, init, out_dir):
    """One rank of the module's world: every scenario, in the same order on
    every rank; saves {scenario: result} to out_dir/rank{rank}.pt."""
    import torch.distributed as dist

    from pyrenderer_tpu_torch.dist import multihost
    from pyrenderer_tpu_torch.dist.render import (axis_index, gather_dp, make_mesh,
                                                  render_field_sharded)

    torch.set_num_threads(1)
    assert multihost.initialize(init, world, rank, device="cpu") is True
    out = {}
    try:
        meshes = {k: make_mesh(dp=dp, sp=sp) for k, (dp, sp) in MESHES.items()}
        out["default"] = tuple(make_mesh().shape)
        out["coords"] = {k: (axis_index(m, "dp"), axis_index(m, "sp")) for k, m in meshes.items()}
        out["errors"] = []
        for kw in ({"dp": 3}, {"n_devices": 8}):
            try:
                make_mesh(**kw)
            except ValueError as e:
                out["errors"].append(str(e))

        def field(scene, camera, cfg, mesh, accel=None):
            px, py = pixel_grid(camera)
            with torch.no_grad():
                return gather_dp(render_field_sharded(scene, camera, cfg, mesh, px, py,
                                                      accel=accel), mesh)

        for dtype in (torch.float32, torch.float64):
            scene, camera = _cornell(dtype)
            for k, m in meshes.items():
                out[f"render_{k}_{dtype}"] = field(scene, camera, CFG, m)
            scene, camera = _cornell(dtype, path=CORNELL_MESH)
            out[f"config5_{dtype}"] = field(scene, camera, CFG5, meshes["dp2sp2"])

        scene, camera = _cornell(torch.float32)
        px, py = pixel_grid(camera)
        params = (scene.vertices, scene.albedo, scene.emission)
        target = torch.zeros((px.shape[0], 3))
        loss1, params2 = train_step(params, scene, camera, CFG, target, px, py, 0.05,
                                    mesh=meshes["dp2sp2"])
        loss2, _ = train_step(params2, scene, camera, CFG, target, px, py, 0.05,
                              mesh=meshes["dp2sp2"])
        out["descend"] = (float(loss1), float(loss2), params2[1] - params[1])

        scene, camera = _cornell(torch.float64, res=8)
        px, py = pixel_grid(camera)
        target = torch.zeros((px.shape[0], 3), dtype=torch.float64)
        for k, m in meshes.items():
            out[f"train_{k}"] = train_step(_train_start(scene), scene, camera, CFG_TRAIN,
                                           target, px, py, LR, mesh=m)

        (host, _), scene, camera, cfg = _terrain()
        out["cluster"] = field(scene, camera, cfg, meshes["dp2sp2"],
                               build_clusters(host.vertices, host.faces))
        chunks = build_chunked_clusters(host.vertices, host.faces, max_tris=4096)
        out["chunked"] = field(scene, camera, cfg, meshes["dp2sp2"], chunks)
        out["jax_imported"] = any(m == "jax" or m.startswith(("jax.", "pyrenderer_tpu."))
                                  for m in sys.modules)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return spawn_world("tests.test_torch_dist:_rank", WORLD, tmp_path_factory.mktemp("world"))


@pytest.fixture(scope="module")
def jax_mesh():
    from pyrenderer_tpu.dist import render as dist_jax

    return dist_jax.make_mesh(8, dp=4, sp=2)


def _jax_field(host, camera, cfg, mesh, accel=None, x64=True):
    """The JAX package's render_field_sharded of all pixels, row-major."""
    import jax
    import jax.numpy as jnp

    from pyrenderer_tpu.config import RenderConfig as JaxConfig
    from pyrenderer_tpu.dist import render as dist_jax

    jcfg = JaxConfig(**{f: getattr(cfg, f) for f in ("max_bounces", "spp", "seed",
                                                      "estimator", "stratified")})
    with jax.enable_x64(x64):
        dtype = np.float64 if x64 else np.float32
        scene = jax.tree.map(lambda x: jnp.asarray(x.astype(dtype) if x.dtype.kind == "f"
                                                   else x), host)
        px, py = dist_jax.pixel_grid(camera)
        return np.asarray(dist_jax.render_field_sharded(scene, camera, jcfg, mesh, px, py,
                                                        accel=accel))


def test_world_of_four_ranks(world):
    """Counterpart of test_eight_devices_available: four ranks, the meshes'
    shapes and each rank's coordinates (dp-major), the spawned ranks free of
    JAX, and a mesh that does not cover the world refused."""
    assert len(world) == WORLD
    for rank, out in enumerate(world):
        assert out["default"] == (4, 1)
        assert out["coords"] == {"dp2sp2": (rank // 2, rank % 2), "dp4sp1": (rank, 0),
                                 "dp1sp4": (0, rank)}
        assert len(out["errors"]) == 2 and "world" in out["errors"][1]
        assert out["jax_imported"] is False


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_matches_single(world, mesh):
    """dp x sp render == the one-process render_field (float32, the JAX
    test's tolerance; only the grouping of the sample sum differs), every
    rank holding the same assembled field."""
    scene, camera = _cornell(torch.float32)
    px, py = pixel_grid(camera)
    want = render_field(scene, camera, CFG, px, py).numpy()
    for out in world:
        got = out[f"render_{mesh}_{torch.float32}"].numpy()
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)
    assert float(want.max()) > 0.1


def test_sharded_matches_jax(world, jax_mesh):
    """float64, every layout of the world against the JAX package's
    render_field_sharded on make_mesh(8, dp=4, sp=2)."""
    host, camera, _ = load_tungsten(CORNELL, dtype=np.float64)
    want = _jax_field(host, camera._replace(resolution=(16, 16)), CFG, jax_mesh)
    for mesh in MESHES:
        got = world[0][f"render_{mesh}_{torch.float64}"].numpy()
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)


def test_sharded_dp_only(world):
    out = world[3]["render_dp4sp1_" + str(torch.float32)].numpy()
    assert np.isfinite(out).all()
    assert out.max() > 0.1


def test_config5_scene_sharded(world, jax_mesh):
    """BASELINE config 5's shape: the Cornell+mesh scene (36 triangles),
    pbrt, stratified, 8 spp over dp = 2 x sp = 2; against render_field in
    float32 and the JAX package in float64."""
    scene, camera = _cornell(torch.float32, path=CORNELL_MESH)
    assert scene.faces.shape[0] == 5 * 2 + 12 + 12 + 2
    px, py = pixel_grid(camera)
    want = render_field(scene, camera, CFG5, px, py).numpy()
    got = world[1][f"config5_{torch.float32}"].numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)
    assert got.mean() > 0.01
    host, camera, _ = load_tungsten(CORNELL_MESH, dtype=np.float64)
    want = _jax_field(host, camera._replace(resolution=(16, 16)), CFG5, jax_mesh)
    np.testing.assert_allclose(world[2][f"config5_{torch.float64}"].numpy(), want,
                               rtol=2e-5, atol=1e-6)


def test_train_step_runs_and_descends(world):
    for out in world:
        loss1, loss2, d_albedo = out["descend"]
        assert np.isfinite(loss1) and loss1 > 0
        assert float(d_albedo.abs().max()) > 0   # the reference estimator shades albedo
        assert loss2 < loss1
        assert out["descend"][0] == world[0]["descend"][0]


@pytest.fixture(scope="module")
def train_single():
    """The one-process float64 step the sharded ones must equal."""
    scene, camera = _cornell(torch.float64, res=8)
    px, py = pixel_grid(camera)
    target = torch.zeros((px.shape[0], 3), dtype=torch.float64)
    return _train_start(scene), train_step(_train_start(scene), scene, camera, CFG_TRAIN,
                                           target, px, py, LR)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_train_step_matches_one_process(world, train_single, mesh):
    """float64: the sharded step's loss and new params equal the
    one-process step's to rtol 1e-10 on every rank (a gradient counted
    sp, dp or world-size times would be off by that factor)."""
    params, (loss_1, new_1) = train_single
    for out in world:
        loss, new = out[f"train_{mesh}"]
        np.testing.assert_allclose(float(loss), float(loss_1), rtol=1e-10)
        for p, q, q1 in zip(params, new, new_1):
            np.testing.assert_allclose(q.numpy(), q1.numpy(), rtol=1e-10, atol=1e-15)
            d, d1 = (q - p).numpy(), (q1 - p).numpy()
            np.testing.assert_allclose(d, d1, rtol=0, atol=1e-10 * float(np.abs(d1).max()))


def test_train_step_matches_jax(world, train_single, jax_mesh):
    """float64: the dp2 x sp2 step against the JAX package's train_step
    on make_mesh(8, dp=4, sp=2) to 1e-8 (tests/test_torch_train.py's)."""
    import jax
    import jax.numpy as jnp

    from pyrenderer_tpu.config import RenderConfig as JaxConfig
    from pyrenderer_tpu.dist import render as dist_jax

    params, _ = train_single
    host, camera, _ = load_tungsten(CORNELL, dtype=np.float64)
    camera = camera._replace(resolution=(8, 8))
    jcfg = JaxConfig(max_bounces=3, spp=4, seed=0)
    with jax.enable_x64(True):
        s = jax.tree.map(jnp.asarray, host)
        px, py = dist_jax.pixel_grid(camera)
        jparams = tuple(jnp.asarray(p.numpy()) for p in params)
        loss_j, new_j = dist_jax.train_step(jparams, s, camera, jcfg, jax_mesh,
                                            jnp.zeros((px.shape[0], 3)), px, py, LR)
        loss_j, new_j = float(loss_j), [np.asarray(q) for q in new_j]
    loss, new = world[0]["train_dp2sp2"]
    np.testing.assert_allclose(float(loss), loss_j, rtol=1e-8)
    for p, q, qj in zip(params, new, new_j):
        np.testing.assert_allclose(q.numpy(), qj, rtol=1e-8, atol=1e-15)
        d, dj = q.numpy() - p.numpy(), qj - p.numpy()
        np.testing.assert_allclose(d, dj, rtol=0, atol=1e-8 * float(np.abs(dj).max()))


def _jax_close(got, want):
    """tests/test_torch_cluster.py's criterion between the two packages'
    float32 cluster renders: > 95% of the values close, median |diff| < 1e-5."""
    assert np.isclose(got, want, rtol=1e-3, atol=1e-4).mean() > 0.95
    assert np.median(np.abs(got - want)) < 1e-5


def test_sharded_cluster_accel_replicated(world, jax_mesh):
    """Large (> 4096-triangle) scene through the dp x sp mesh with a
    replicated ClusterScene: equal to the one-process "cluster" render, and
    close to the JAX package's sharded render with its own ClusterScene."""
    from pyrenderer_tpu.accel.clusters import build_clusters as build_clusters_jax

    (host, host_camera), scene, camera, cfg = _terrain()
    px, py = pixel_grid(camera)
    accel = build_clusters(host.vertices, host.faces)
    want = render_block(scene, camera, cfg, cfg.seed, cfg.spp, px, py, backend="cluster",
                        accel=accel).numpy()
    for out in world:
        got = out["cluster"].numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)
    accel_j = build_clusters_jax(np.asarray(host.vertices), np.asarray(host.faces))
    _jax_close(got, _jax_field(host, host_camera, cfg, jax_mesh, accel=accel_j, x64=False))


def test_sharded_chunked_accel_replicated(world):
    """A ClusterChunks (three chunks of terrain8k) replicated over the mesh:
    "auto" resolves to "cluster_chunked", and the frame equals the
    one-process chunked render."""
    (host, _), scene, camera, cfg = _terrain()
    accel = build_chunked_clusters(host.vertices, host.faces, max_tris=4096)
    assert isinstance(accel, ClusterChunks) and len(accel.chunks) == 3
    assert resolve_backend("auto", scene.faces.shape[0], "cpu", accel) == "cluster_chunked"
    px, py = pixel_grid(camera)
    want = render_block(scene, camera, cfg, cfg.seed, cfg.spp, px, py, accel=accel).numpy()
    for out in world:
        got = out["chunked"].numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)
