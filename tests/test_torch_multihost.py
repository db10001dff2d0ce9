"""pyrenderer_tpu_torch's dist/multihost.py and dist/worker.py: real
separate worker processes on the CPU (`python -m
pyrenderer_tpu_torch.dist.worker --cpu`, gloo, a file:// rendezvous),
mirroring tests/test_multihost.py, plus the module's functions in a world
of one in this process.

  1. two processes assemble the image one process renders, and both see it;
  2. train steps over two processes give the one-process losses and
     gradients (the gradient all-reduce crosses the processes);
  3. samples sharded over "sp" across the processes give the same image.

The JAX worker gives each process 4 virtual devices (--cpu-devices); a rank
of the port is one process with one device, so the worlds here have two
ranks where the JAX tests' meshes have eight devices.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from pyrenderer_tpu_torch.config import RenderConfig
from pyrenderer_tpu_torch.core.camera import generate_rays
from pyrenderer_tpu_torch.core.integrator import render_image, trace_reference
from pyrenderer_tpu_torch.dist import multihost, worker
from pyrenderer_tpu_torch.dist.render import make_mesh, pixel_grid
from pyrenderer_tpu_torch.scene import load_tungsten, to_device
from tests.torch_fixtures import REPO

torch.set_num_threads(2)

CORNELL = os.path.join(REPO, "tests", "data", "cornell_box.json")


def _spawn_workers(n_proc, tmp_path, out=None, res=32, spp=2, depth=2, sp=1, train_steps=0):
    """n_proc worker processes of one world (--cpu); their RESULT lines.
    Outputs go to files: a rank blocked in a collective must not wait on a
    full pipe. Survivors of the timeout are killed."""
    init = "file://" + str(tmp_path / f"pg{n_proc}_{sp}_{train_steps}")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = []
    try:
        for pid in range(n_proc):
            cmd = [sys.executable, "-m", "pyrenderer_tpu_torch.dist.worker", CORNELL, "--cpu",
                   "--res", str(res), "--spp", str(spp), "--depth", str(depth), "--sp", str(sp)]
            if n_proc > 1:
                cmd += ["--coordinator", init, "--num-processes", str(n_proc),
                        "--process-id", str(pid)]
            if train_steps:
                cmd += ["--train-steps", str(train_steps)]
            if pid == 0 and out:
                cmd += ["--out", out]
            log = open(tmp_path / f"worker{n_proc}_{pid}_{sp}_{train_steps}.log", "w+")
            procs.append((subprocess.Popen(cmd, cwd=REPO, env=env, stdout=log,
                                           stderr=subprocess.STDOUT), log))
        results = []
        for p, log in procs:
            p.wait(timeout=120)
            log.seek(0)
            text = log.read()
            assert p.returncode == 0, f"worker failed:\n{text[-3000:]}"
            line = [ln for ln in text.splitlines() if ln.startswith("RESULT ")]
            assert line, f"no RESULT line:\n{text[-2000:]}"
            results.append(json.loads(line[-1][len("RESULT "):]))
        return results
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()


def test_two_process_render_matches_single_process(tmp_path):
    out2 = str(tmp_path / "mh2.npy")
    res2 = _spawn_workers(2, tmp_path, out2)
    assert all(r["multi"] for r in res2)
    assert all(r["num_processes"] == 2 and r["global_devices"] == 2 for r in res2)
    assert all(r["device"] == "cpu" and r["backend"] == "gloo" for r in res2)
    # every process saw the same assembled frame; the CPU ran the twins
    assert res2[0]["image_mean"] == res2[1]["image_mean"]
    assert all(r["launches"] == {} for r in res2)

    out1 = str(tmp_path / "mh1.npy")
    res1 = _spawn_workers(1, tmp_path, out1)
    assert res1[0]["num_processes"] == 1 and res1[0]["multi"] is False

    img2, img1 = np.load(out2), np.load(out1)
    assert img2.shape == img1.shape == (32, 32, 3)
    np.testing.assert_allclose(img2, img1, rtol=2e-5, atol=2e-6)
    # and the port's render_image of the same config, in this process
    host, camera, cfg = load_tungsten(CORNELL)
    scene, cam = to_device(host, camera._replace(resolution=(32, 32)), "cpu")
    cfg = cfg.replace(spp=2, max_bounces=2, seed=0, estimator="reference", resolution=None)
    np.testing.assert_allclose(img2, render_image(scene, cam, cfg).numpy(), rtol=2e-5,
                               atol=2e-6)


def test_two_process_image_matches_jax(tmp_path):
    """The two-process frame against the JAX package's render_field_sharded
    of the same config on make_mesh(8, dp=4, sp=2) (float32: > 95% of the
    values close, median |diff| < 1e-5, tests/test_torch_cluster.py's
    criterion between the packages)."""
    import jax
    import jax.numpy as jnp

    from pyrenderer_tpu.dist import render as dist_jax
    from pyrenderer_tpu.scene.tungsten import load_tungsten as load_jax

    out = str(tmp_path / "mh.npy")
    _spawn_workers(2, tmp_path, out, spp=4, sp=2)
    host, camera, cfg = load_jax(CORNELL)
    camera = camera._replace(resolution=(32, 32))
    cfg = cfg.replace(spp=4, max_bounces=2, seed=0, estimator="reference", resolution=None)
    px, py = dist_jax.pixel_grid(camera)
    want = np.asarray(dist_jax.render_field_sharded(
        jax.tree.map(jnp.asarray, host), camera, cfg, dist_jax.make_mesh(8, dp=4, sp=2),
        px, py)).reshape(32, 32, 3)[::-1]
    got = np.load(out)
    assert np.isclose(got, want, rtol=1e-3, atol=1e-4).mean() > 0.95
    assert np.median(np.abs(got - want)) < 1e-5


def test_two_process_train_step(tmp_path):
    """Train steps over two processes: the parameter gradients all-reduce
    across them. Loss and gradient statistics equal on both ranks and to
    the one-process run."""
    res2 = _spawn_workers(2, tmp_path, train_steps=2)
    assert res2[0]["train_losses"] == res2[1]["train_losses"]
    assert res2[0]["grad_mean_abs"] == res2[1]["grad_mean_abs"]
    res1 = _spawn_workers(1, tmp_path, train_steps=2)
    assert res2[0]["train_losses"] == pytest.approx(res1[0]["train_losses"], rel=2e-5)
    assert res2[0]["grad_mean_abs"] == pytest.approx(res1[0]["grad_mean_abs"], rel=2e-4)
    assert res2[0]["param_mean_abs"] == pytest.approx(res1[0]["param_mean_abs"], rel=2e-5)
    assert all(np.isfinite(v) and v > 0 for v in res2[0]["train_losses"])
    g_verts, g_albedo, g_emission = res2[0]["grad_mean_abs"]
    assert g_verts > 0 and g_albedo > 0
    # the "reference" estimator ignores scene emission (the reference's
    # hardcoded light color), so its gradient is exactly 0
    assert g_emission == 0.0


def test_two_process_spp_sharding(tmp_path):
    """dp x sp across processes (sp = 2: the sample sum crosses the
    process boundary): the one-process image."""
    out = str(tmp_path / "mh_sp.npy")
    res = _spawn_workers(2, tmp_path, out, sp=2, spp=4)
    assert all(r["global_devices"] == 2 for r in res)
    out1 = str(tmp_path / "mh_sp1.npy")
    _spawn_workers(1, tmp_path, out1, spp=4)
    np.testing.assert_allclose(np.load(out), np.load(out1), rtol=2e-5, atol=2e-6)


@pytest.fixture
def world_of_one(monkeypatch):
    """initialize() from the environment with one process: a gloo world of
    one in this process, destroyed after the test."""
    assert not dist.is_initialized()
    monkeypatch.setenv("PYRT_NUM_PROCESSES", "1")
    assert multihost.initialize(device="cpu") is False
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_world_of_one_functions(world_of_one):
    """make_host_mesh, _global_pixel_arrays, render_image_multihost and
    _count_rays in a world of one: the one-process image and ray count."""
    assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
    mesh = multihost.make_host_mesh()
    assert tuple(mesh.shape) == (1, 1) and multihost.rank_device(cpu=True).type == "cpu"
    host, camera, _ = load_tungsten(CORNELL)
    scene, cam = to_device(host, camera._replace(resolution=(8, 8)), "cpu")
    cfg = RenderConfig(max_bounces=2, spp=2, seed=3)
    px, py = multihost._global_pixel_arrays(cam, mesh)
    gx, gy = pixel_grid(cam)
    assert torch.equal(px, gx) and torch.equal(py, gy)
    img = multihost.render_image_multihost(scene, cam, cfg, mesh)
    np.testing.assert_allclose(img, render_image(scene, cam, cfg).numpy(), rtol=2e-5,
                               atol=1e-7)
    ro, rd = generate_rays(cam, px, py, 0, cfg.seed)
    _, n = trace_reference(scene, cfg, ro, rd, py * 8 + px, 0, cfg.seed, with_stats=True)
    assert multihost._count_rays(scene, cam, cfg, mesh, px, py) == float(n) > 64
    with pytest.raises(ValueError, match="world"):
        make_mesh(dp=2)


def test_initialize_refusals(monkeypatch):
    """NCCL is never swapped for gloo: CPU ranks asking for it, or GPU
    ranks on a machine without one, are refused; and no mesh without a
    process group."""
    monkeypatch.delenv("PYRT_NUM_PROCESSES", raising=False)
    with pytest.raises(ValueError, match="gloo"):
        multihost.initialize(device="cpu", backend="nccl")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        multihost.initialize()
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh()


def test_initialize_nccl_takes_one_rank_per_gpu(monkeypatch):
    """More ranks than GPUs under NCCL raise (ask for gloo), before any
    process group is brought up."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(dist, "is_nccl_available", lambda: True)
    with pytest.raises(ValueError, match="one rank per GPU"):
        multihost.initialize("localhost:1", 4, 0)
    assert not dist.is_initialized()


def test_worker_without_gpu_exits_2(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert worker.main([CORNELL]) == 2
    assert "--cpu" in capsys.readouterr().err
