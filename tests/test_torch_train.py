"""pyrenderer_tpu_torch's dist/render.py (render_field, train_step) and the
inverse-rendering example against the JAX package's dist/render.py on a
one-device mesh (mirrors tests/test_invrender.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyrenderer_tpu.config import RenderConfig as JaxConfig
from pyrenderer_tpu.dist import render as dist_jax
from pyrenderer_tpu.scene.tungsten import load_tungsten as load_jax
from pyrenderer_tpu_torch.config import RenderConfig
from pyrenderer_tpu_torch.dist import render as dist_render
from pyrenderer_tpu_torch.dist.render import pixel_grid, render_field, train_step
from pyrenderer_tpu_torch.examples import invrender
from pyrenderer_tpu_torch.scene import to_device

torch.set_num_threads(2)

CFG = RenderConfig(max_bounces=3, spp=2, seed=0, estimator="reference")
CFG_JAX = JaxConfig(max_bounces=3, spp=2, seed=0, estimator="reference")


@pytest.fixture(scope="module")
def cornell8(cornell_path):
    """The host Cornell box in float64 at 8x8, and the albedo the example
    starts from: the reddest material set to grey."""
    host, camera, _ = load_jax(cornell_path, dtype=np.float64)
    camera = camera._replace(resolution=(8, 8))
    alb = host.albedo.copy()
    alb[int(np.argmax(alb[:, 0] - alb[:, 1]))] = [0.5, 0.5, 0.5]
    return host, camera, alb


@pytest.fixture(scope="module")
def jax_target(cornell8):
    """The JAX package's pixel grid and target (render_field_sharded of the
    true scene), float64 on make_mesh(1)."""
    host, camera, _ = cornell8
    with jax.enable_x64(True):
        s = jax.tree.map(jnp.asarray, host)
        px, py = dist_jax.pixel_grid(camera)
        target = dist_jax.render_field_sharded(s, camera, CFG_JAX, dist_jax.make_mesh(1), px, py)
        return np.asarray(px), np.asarray(py), np.array(target)


def _jax_step(host, camera, alb_init, jax_target, lr):
    """One JAX train_step from alb_init: (loss, new params)."""
    px, py, target = jax_target
    with jax.enable_x64(True):
        s = jax.tree.map(jnp.asarray, host)
        params = (s.vertices, jnp.asarray(alb_init), s.emission)
        loss, new = dist_jax.train_step(params, s, camera, CFG_JAX, dist_jax.make_mesh(1),
                                        jnp.asarray(target), jnp.asarray(px), jnp.asarray(py),
                                        lr)
        return float(loss), [np.asarray(p) for p in new]


@pytest.mark.parametrize("lr", [(0.0, 30.0, 0.0), (1e-3, 2.0, 0.5)], ids=["albedo", "all"])
def test_train_step_matches_jax(cornell8, jax_target, lr):
    """pixel_grid, render_field and one train_step equal the JAX package's
    (float64: in float32 a grazing shadow ray may flip, ROADMAP C4): the
    target image and the loss to rtol 1e-10, the new params to rtol 1e-8
    (atol 1e-15 for the coordinates at 0) and their steps to 1e-8 of the
    largest; a parameter with lr 0 comes back as the same tensor, equal to
    JAX's bit for bit."""
    host, camera, alb_init = cornell8
    px_j, py_j, target_j = jax_target
    loss_j, new_j = _jax_step(host, camera, alb_init, jax_target, lr)

    scene, cam = to_device(host, camera, "cpu", torch.float64)
    px, py = pixel_grid(cam)
    np.testing.assert_array_equal(px.numpy(), px_j)
    np.testing.assert_array_equal(py.numpy(), py_j)
    with torch.no_grad():
        target = render_field(scene, cam, CFG, px, py)
    np.testing.assert_allclose(target.numpy(), target_j, rtol=1e-10, atol=1e-14)

    params = (scene.vertices, torch.from_numpy(alb_init), scene.emission)
    loss, new = train_step(params, scene, cam, CFG, torch.from_numpy(target_j), px, py, lr)
    assert not loss.requires_grad
    np.testing.assert_allclose(float(loss), loss_j, rtol=1e-10)
    for name, step, p, q, pj in zip(("vertices", "albedo", "emission"), lr, params, new, new_j):
        if step == 0:
            assert q is p, name
            np.testing.assert_array_equal(q.numpy(), pj, err_msg=name)
            continue
        np.testing.assert_allclose(q.numpy(), pj, rtol=1e-8, atol=1e-15, err_msg=name)
        d, dj = q.numpy() - p.numpy(), pj - p.numpy()
        np.testing.assert_allclose(d, dj, rtol=0, atol=1e-8 * float(np.abs(dj).max()),
                                   err_msg=name)
    assert float(np.abs(new[1].numpy() - alb_init).max()) > 0


def test_train_step_chunks(cornell8, monkeypatch):
    """Chunks of 16 of the 64 pixels (each chunk's loss differentiated on
    its own) give the loss and the step of one chunk of all 64 (float64,
    rtol 1e-12: only the order of the sums differs)."""
    host, camera, alb_init = cornell8
    scene, cam = to_device(host, camera, "cpu", torch.float64)
    px, py = pixel_grid(cam)
    with torch.no_grad():
        target = render_field(scene, cam, CFG, px, py)
    params = (scene.vertices, torch.from_numpy(alb_init), scene.emission)
    lr = (1e-3, 2.0, 0.5)
    monkeypatch.setattr(dist_render, "CHUNK", 64)
    loss_1, new_1 = train_step(params, scene, cam, CFG, target, px, py, lr)
    monkeypatch.setattr(dist_render, "CHUNK", 16)
    loss_4, new_4 = train_step(params, scene, cam, CFG, target, px, py, lr)
    torch.testing.assert_close(loss_4, loss_1, rtol=1e-12, atol=0)
    for p, a, b in zip(params, new_4, new_1):
        step = (b - p).abs().max()
        torch.testing.assert_close(a - p, b - p, rtol=0, atol=1e-12 * float(step))
    assert float((new_1[0] - params[0]).abs().max()) > 0


def test_train_step_frozen_inf_gradient(cornell8):
    """A frozen parameter comes back unchanged even where its gradient
    would not be finite (p - 0 * inf is NaN): an infinite target makes
    every gradient infinite or NaN."""
    host, camera, alb_init = cornell8
    scene, cam = to_device(host, camera, "cpu", torch.float64)
    px, py = pixel_grid(cam)
    target = torch.full((px.shape[0], 3), float("inf"), dtype=torch.float64)
    params = (scene.vertices, torch.from_numpy(alb_init), scene.emission)
    _, new = train_step(params, scene, cam, CFG, target, px, py, (0.0, 1.0, 0.0))
    assert new[0] is params[0] and new[2] is params[2]
    assert not bool(torch.isfinite(new[1]).all())


def test_invrender_example_cpu(capsys):
    """The example's entry point on the CPU at a small size: the loss
    falls 10x (exit code 0)."""
    assert invrender.main(["--cpu", "--res", "12", "--spp", "1", "--steps", "20"]) == 0
    assert "done: loss" in capsys.readouterr().out


def test_invrender_example_needs_a_device(monkeypatch, capsys):
    """Without a GPU and without --cpu the example exits 2, it does not
    fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert invrender.main([]) == 2
    assert "--cpu" in capsys.readouterr().err


@pytest.mark.slow
def test_albedo_recovery_converges():
    """tests/test_invrender.py::test_albedo_recovery_converges on the port,
    on the CPU (24x24, 2 spp, 60 steps, albedo lr 30)."""
    out = invrender.recover("cpu", res=24, spp=2, steps=60, lr=30.0, log=lambda _: None)
    assert out["loss"] < out["loss0"] / 10, f"loss {out['loss0']:.3e} -> {out['loss']:.3e}"
    assert np.abs(out["albedo"] - out["true_albedo"]).max() < 0.05
    # untouched parameters stayed frozen
    for i in (0, 2):
        assert torch.equal(out["params"][i], out["params0"][i])
