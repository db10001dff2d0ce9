"""pyrenderer_tpu_torch driver, tone mapping, image output and CLI, and the
package's independence from JAX."""

import ast
import os

import imageio.v3 as iio
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyrenderer_tpu.core import tonemap as tonemap_jax
from pyrenderer_tpu.scene.tungsten import load_tungsten
from pyrenderer_tpu_torch.config import RenderConfig
from pyrenderer_tpu_torch.core.film import Film
from pyrenderer_tpu_torch.core.integrator import render_image
from pyrenderer_tpu_torch.core.tonemap import tonemap
from pyrenderer_tpu_torch.render import cli
from pyrenderer_tpu_torch.render.driver import ProgressiveRenderer
from pyrenderer_tpu_torch.scene import to_device
from pyrenderer_tpu_torch.utils.exr import read_exr, write_exr
from pyrenderer_tpu_torch.utils.image_io import write_hdr, write_png

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "pyrenderer_tpu_torch")
CFG = RenderConfig(max_bounces=4, spp=2, seed=3, estimator="reference")


@pytest.fixture(scope="module")
def cornell16(cornell_path):
    host, camera, _ = load_tungsten(cornell_path, dtype=np.float32)
    return to_device(host, camera._replace(resolution=(16, 16)), "cpu", torch.float32)


def test_progressive_matches_render_image(cornell16):
    scene, camera = cornell16
    renderer = ProgressiveRenderer(scene, camera, CFG)
    film = renderer.run(quiet=True)
    assert film.spp == 2 and film.next_sample == 2
    img = render_image(scene, camera, CFG).numpy()
    np.testing.assert_allclose(film.hdr, img, rtol=1e-6, atol=1e-7)
    assert renderer.rays_traced > 16 * 16 * 2


def test_checkpoint_resume_is_identical(cornell16, tmp_path):
    """A render resumed from a 1-spp checkpoint equals an uninterrupted one."""
    scene, camera = cornell16
    cfg = CFG.replace(spp=3)
    full = ProgressiveRenderer(scene, camera, cfg).run(quiet=True)
    first = ProgressiveRenderer(scene, camera, cfg.replace(spp=1)).run(quiet=True)
    path = str(tmp_path / "ckpt.npz")
    first.save(path)
    resumed = ProgressiveRenderer(scene, camera, cfg, film=Film.load(path)).run(quiet=True)
    assert np.array_equal(resumed.radiance_sum, full.radiance_sum)
    with pytest.raises(ValueError, match="seed"):
        ProgressiveRenderer(scene, camera, cfg.replace(seed=9), film=Film.load(path))


@pytest.mark.parametrize("mode", ["sqrt", "reinhard", "filmic", "none"])
def test_tonemap_matches_jax(mode):
    rs = np.random.RandomState(0)
    hdr = (rs.exponential(0.3, (24, 20, 3)) * (rs.rand(24, 20, 3) > 0.05)).astype(np.float32)
    hdr[0, 0, 0] = np.nan
    ours = tonemap(torch.from_numpy(hdr), mode).numpy()
    theirs = np.asarray(tonemap_jax.tonemap(jnp.asarray(hdr), mode))
    np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=1e-7, equal_nan=True)


def test_png_writer_decodes_like_imageio(tmp_path):
    """The zlib/struct PNG decodes to the same pixels imageio writes."""
    rs = np.random.RandomState(1)
    ldr = rs.rand(13, 17, 3).astype(np.float32)
    ldr[0, :3] = [0.0, 1.0, 1.5]
    ours, theirs = str(tmp_path / "ours.png"), str(tmp_path / "theirs.png")
    write_png(ours, ldr)
    iio.imwrite(theirs, (np.clip(ldr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8))
    a, b = iio.imread(ours), iio.imread(theirs)
    assert a.shape == (13, 17, 3) and a.dtype == np.uint8
    assert np.array_equal(a, b)


def test_hdr_writers_round_trip(tmp_path):
    img = np.random.RandomState(2).rand(33, 9, 3).astype(np.float32)
    for comp in ("zip", "none"):
        path = str(tmp_path / f"x_{comp}.exr")
        write_exr(path, img, compression=comp)
        assert np.array_equal(read_exr(path), img)
    assert write_hdr(str(tmp_path / "y"), img).endswith(".npy")


def test_cli_cpu_end_to_end(cornell_path, tmp_path):
    png, exr = str(tmp_path / "out.png"), str(tmp_path / "out.exr")
    rc = cli.main([cornell_path, "--cpu", "--res", "16", "16", "--spp", "2",
                   "--depth", "4", "--estimator", "reference", "--seed", "3",
                   "--out", png, "--hdr-out", exr, "--quiet"])
    assert rc == 0
    assert iio.imread(png).shape == (16, 16, 3)
    hdr = read_exr(exr)
    assert hdr.shape == (16, 16, 3) and np.isfinite(hdr).all()
    host, camera, _ = load_tungsten(cornell_path, dtype=np.float32)
    scene, cam = to_device(host, camera._replace(resolution=(16, 16)), "cpu")
    np.testing.assert_allclose(hdr, render_image(scene, cam, CFG).numpy(), rtol=1e-6, atol=1e-7)


def test_cli_unported_options_raise(cornell_path, tmp_path, capsys):
    """Every mode and flag of the JAX CLI is ported: the analytic mode
    renders its PNG, --backend matmul and --live render."""
    base = [cornell_path, "--cpu", "--res", "4", "4", "--spp", "1",
            "--out", str(tmp_path / "o.png")]
    assert cli.main(base + ["--estimator", "reference", "--backend", "matmul"]) == 0
    assert "(matmul backend)" in capsys.readouterr().err
    analytic_png = tmp_path / "analytic.png"
    assert cli.main(["analytic", "--cpu", "--res", "6", "4", "--spp", "1", "--depth", "1",
                     "--out", str(analytic_png)]) == 0
    assert iio.imread(analytic_png).shape == (4, 6, 3)
    assert cli.main(base + ["--estimator", "reference", "--live"]) == 0
    assert "\u2580" in capsys.readouterr().err


def test_cli_without_gpu_exits_nonzero(cornell_path, tmp_path, monkeypatch, capsys):
    """Without --cpu the CLI needs a GPU; with none it fails, it does not
    fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "o.png"
    rc = cli.main([cornell_path, "--estimator", "reference", "--res", "4", "4",
                   "--spp", "1", "--out", str(out)])
    assert rc != 0 and not out.exists()
    assert "--cpu" in capsys.readouterr().err
    for argv in (["analytic", "--res", "4", "4", "--spp", "1", "--out", str(out)],
                 [cornell_path, "--res", "4", "4", "--debug-paths", str(tmp_path / "p.html")]):
        assert cli.main(argv) == 2
        assert "--cpu" in capsys.readouterr().err
    assert not out.exists() and not (tmp_path / "p.html").exists()


def _imported_modules(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_never_imports_jax():
    """An AST scan: no module of pyrenderer_tpu_torch (nor chip_smoke.py)
    imports jax, jaxlib or the JAX package."""
    files = [os.path.join(root, f) for root, _, names in os.walk(PACKAGE)
             for f in names if f.endswith(".py")]
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) > 20
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "pyrenderer_tpu"), (path, mod)
