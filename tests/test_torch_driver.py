"""pyrenderer_tpu_torch's driver beyond uniform passes: adaptive sampling,
run_resilient, the terminal live view, the CLI's --live, --resilient and
tonemap mode, utils/checks; held against the JAX
package (pyrenderer_tpu/render/driver.py, render/cli.py, utils/) on the
same seeds."""

import collections
import io
import json
import time
import unittest.mock as mock

import imageio.v3 as iio
import numpy as np
import pytest
import torch

from pyrenderer_tpu.config import RenderConfig as JaxConfig
from pyrenderer_tpu.render import cli as cli_jax
from pyrenderer_tpu.render import driver as drv_jax
from pyrenderer_tpu.scene.tungsten import load_tungsten
from pyrenderer_tpu.utils import checks as checks_jax
from pyrenderer_tpu.utils import termview as termview_jax
from pyrenderer_tpu_torch.config import RenderConfig
from pyrenderer_tpu_torch.core.film import Film
from pyrenderer_tpu_torch.render import cli
from pyrenderer_tpu_torch.render import driver as drv
from pyrenderer_tpu_torch.scene import to_device
from pyrenderer_tpu_torch.utils import checks, termview
from pyrenderer_tpu_torch.utils.exr import write_exr

torch.set_num_threads(2)

# tests/test_render.py::test_adaptive_sampling's configuration
ADAPTIVE = dict(max_bounces=3, spp=12, spp_step=1, seed=4, resolution=(24, 24),
                adaptive=True, adaptive_min_spp=4, adaptive_tolerance=0.05)
# float32 renders of the two packages differ on ~1% of rays (grazing shadow
# rays whose origin rounds differently; ROADMAP C4): pixels whose one
# sample takes such a ray differ
PIXEL_AGREEMENT = 0.98


@pytest.fixture(scope="module")
def cornell(cornell_path):
    """(host scene and camera for the JAX package, the port's CPU scene and
    camera), float32."""
    host, camera, _ = load_tungsten(cornell_path, dtype=np.float32)
    scene, cam = to_device(host, camera, "cpu", torch.float32)
    return host, camera, scene, cam


def _uniform_film(cornell, tmp_path):
    """The JAX renderer after ADAPTIVE's uniform phase, its film saved with
    Film.save; returns (JAX renderer, npz path)."""
    host, camera, _, _ = cornell
    r = drv_jax.ProgressiveRenderer(host, camera, JaxConfig(**ADAPTIVE))
    while r.film.spp < ADAPTIVE["adaptive_min_spp"]:
        r.render_one_pass()
    path = str(tmp_path / "uniform.npz")
    r.film.save(path)
    return r, path


def test_refine_adaptive_picks_jax_pixels_and_ids(cornell, tmp_path):
    """From the same film (the JAX film after its uniform phase, loaded by
    the port's Film.load: the same npz layout), one refine_adaptive of each
    package picks the same pixels with the same per-pixel sample ids,
    compared exactly (JAX pads its chunk to a power of two: its first k
    entries are compared). The radiance each adds is within rtol 1e-5 on
    at least PIXEL_AGREEMENT of the refined pixels."""
    _, _, scene, cam = cornell
    r_jax, path = _uniform_film(cornell, tmp_path)
    r = drv.ProgressiveRenderer(scene, cam, RenderConfig(**ADAPTIVE), film=Film.load(path))
    before = r.film.radiance_sum.copy()
    np.testing.assert_array_equal(before, r_jax.film.radiance_sum)

    calls = collections.defaultdict(list)
    render_ids_jax, render_ids = drv_jax._render_pass_ids, drv._render_pass_ids

    def spy_jax(scene, camera, cfg, ids, px, py, *args):
        calls["jax"].append([np.asarray(x) for x in (ids, px, py)])
        return render_ids_jax(scene, camera, cfg, ids, px, py, *args)

    def spy(scene, camera, cfg, tables, ids, px, py):
        calls["torch"].append([x.numpy() for x in (ids, px, py)])
        return render_ids(scene, camera, cfg, tables, ids, px, py)

    with mock.patch.object(drv_jax, "_render_pass_ids", spy_jax):
        k_jax = r_jax.refine_adaptive(quiet=True)
    with mock.patch.object(drv, "_render_pass_ids", spy):
        k = r.refine_adaptive(quiet=True)
    assert k == k_jax and 0 < k < 24 * 24
    assert len(calls["jax"]) == len(calls["torch"]) == 1
    for ours, theirs in zip(calls["torch"][0], calls["jax"][0]):
        assert ours.shape == (k,)
        np.testing.assert_array_equal(ours, theirs[:k])
    assert calls["torch"][0][0].min() == ADAPTIVE["adaptive_min_spp"]
    np.testing.assert_array_equal(r.film.spp_map, r_jax.film.spp_map)

    refined = r.film.spp_map > ADAPTIVE["adaptive_min_spp"]
    added = (r.film.radiance_sum - before)[refined]
    added_jax = (r_jax.film.radiance_sum - before)[refined]
    agree = np.isclose(added, added_jax, rtol=1e-5, atol=0).all(axis=-1)
    assert agree.mean() >= PIXEL_AGREEMENT, agree.mean()


def test_adaptive_run_matches_jax(cornell):
    """tests/test_render.py::test_adaptive_sampling mirrored (24x24, spp 12,
    min 4, tolerance 0.05): every pixel has at least the minimum and at
    most the cap, some got more, each has err <= tol or is at the cap, the
    image is within 0.05 of a flat 48-spp render; and the spp_map equals
    the JAX package's on at least PIXEL_AGREEMENT of the pixels."""
    host, camera, scene, cam = cornell
    cfg = RenderConfig(**ADAPTIVE)
    film = drv.ProgressiveRenderer(scene, cam, cfg).run(quiet=True)
    spp = film.spp_map
    assert spp.min() >= 4 and spp.max() <= 12 and spp.max() > spp.min()
    err = film.relative_error()
    assert np.all((err <= cfg.adaptive_tolerance) | (spp >= cfg.spp))
    flat = drv.ProgressiveRenderer(scene, cam, cfg.replace(adaptive=False, spp=48)).run(quiet=True)
    assert np.abs(film.hdr - flat.hdr).mean() < 0.05
    film_jax = drv_jax.ProgressiveRenderer(host, camera, JaxConfig(**ADAPTIVE)).run(quiet=True)
    assert (spp == film_jax.spp_map).mean() >= PIXEL_AGREEMENT


@pytest.mark.parametrize("backend, estimator", [
    ("brute", "reference"), ("matmul", "pbrt"), ("cuda", "reference"),
    ("cluster", "reference"), ("cluster", "pbrt")])
def test_per_pixel_sample_ids(cornell, monkeypatch, backend, estimator):
    """render_sample with an (N,) tensor of per-pixel sample ids (the
    adaptive sweeps) gives each pixel, bit for bit, its radiance at its own
    id, on each backend path; "cluster" with its coherence sort, in two
    suspend/resume rounds so that the closest-hit query runs its sorted
    operands on the CPU too."""
    from pyrenderer_tpu_torch.core import integrator as integ
    from pyrenderer_tpu_torch.kernels import cluster as kc

    _, _, scene, cam = cornell
    cam = cam._replace(resolution=(8, 8))
    rounds = {"cluster_rounds": 2, "cluster_budget": 2} if backend == "cluster" else {}
    cfg = RenderConfig(max_bounces=3, spp=4, seed=2, estimator=estimator, cluster_sort=True,
                       **rounds)
    tables = integ.TraceTables(scene, cfg, backend)
    perms = []
    prepare = kc._prepare

    def recording_prepare(*args):
        rays, perm = prepare(*args)
        perms.append(perm)
        return rays, perm

    monkeypatch.setattr(kc, "_prepare", recording_prepare)
    px = torch.arange(64) % 8
    py = torch.arange(64) // 8
    ids = torch.as_tensor(np.random.RandomState(0).randint(0, 4, 64))
    per_id = [integ.render_sample(scene, cam, cfg, cfg.seed, s, px, py, tables=tables)
              for s in range(4)]
    expect = torch.stack(per_id)[ids, torch.arange(64)]
    got = integ.render_sample(scene, cam, cfg, cfg.seed, ids, px, py, tables=tables)
    assert got.abs().sum() > 0
    assert torch.equal(got, expect)
    assert all(p is not None for p in perms) and bool(perms) is (backend == "cluster")


def _small(cornell, **kw):
    _, _, scene, cam = cornell
    cfg = RenderConfig(**dict(dict(spp=4, spp_step=1, max_bounces=2, seed=7,
                                   resolution=(12, 12), estimator="reference"), **kw))
    return lambda: drv.ProgressiveRenderer(scene, cam, cfg)


def test_run_resilient_recovers_bit_identical(cornell):
    """Transient failures (tests/test_render.py's, the 1st and 3rd pass
    raise): the retried render is bit-identical to an uninterrupted one and
    counts the same rays; the failed passes add none."""
    make = _small(cornell)
    clean = make()
    clean.run(quiet=True)
    flaky = make()
    render_one_pass = flaky.render_one_pass
    calls = {"n": 0}

    def sometimes_fails():
        calls["n"] += 1
        if calls["n"] in (1, 3):
            raise RuntimeError("injected transient device failure")
        return render_one_pass()

    flaky.render_one_pass = sometimes_fails
    t0 = time.perf_counter()
    film = flaky.run_resilient(max_retries=3, backoff=0.01, quiet=True)
    assert time.perf_counter() - t0 < 60 and calls["n"] == 6
    assert film.spp == 4
    np.testing.assert_array_equal(film.radiance_sum, clean.film.radiance_sum)
    np.testing.assert_array_equal(film.spp_map, clean.film.spp_map)
    assert flaky.rays_traced == clean.rays_traced > 0


def test_run_resilient_gives_up_after_max_retries(cornell):
    r = _small(cornell, spp=2)()

    def always_fails():
        raise RuntimeError("hard failure")

    r.render_one_pass = always_fails
    with pytest.raises(RuntimeError, match="hard failure"):
        r.run_resilient(max_retries=2, backoff=0.01, quiet=True)
    assert r.film.spp == 0 and r.rays_traced == 0


@pytest.mark.parametrize("adaptive", [False, True])
def test_run_resilient_rejects_nonfinite(cornell, adaptive):
    """A NaN in the first uniform pass (adaptive=False) or the first
    adaptive chunk (adaptive=True) is caught before the film absorbs it and
    retried: the film ends bit-identical to a clean render, with the same
    ray count (the rejected pass or chunk adds none). Without
    run_resilient's guard a plain run absorbs it."""
    make = _small(cornell, **(dict(adaptive=True, adaptive_min_spp=2, adaptive_tolerance=0.05)
                              if adaptive else {}))
    clean = make()
    clean.run(quiet=True)
    name = "_render_pass_ids" if adaptive else "_render_pass"
    original = getattr(drv, name)
    calls = {"n": 0}

    def poisoned(*args):
        out = original(*args)
        calls["n"] += 1
        if calls["n"] == 1:
            out[0][0, 1] = torch.nan
        return out

    r = make()
    with mock.patch.object(drv, name, poisoned):
        film = r.run_resilient(max_retries=2, backoff=0.01, quiet=True)
    assert calls["n"] > 1 and np.isfinite(film.radiance_sum).all()
    np.testing.assert_array_equal(film.radiance_sum, clean.film.radiance_sum)
    np.testing.assert_array_equal(film.spp_map, clean.film.spp_map)
    assert r.rays_traced == clean.rays_traced
    if adaptive:
        assert film.spp_map.max() > film.spp_map.min()

    calls["n"] = 0
    with mock.patch.object(drv, name, poisoned):
        assert not np.isfinite(make().run(quiet=True).radiance_sum).all()


def test_run_resilient_guard_names_the_bad_value(cornell):
    """A pass that stays poisoned fails after max_retries with
    assert_all_finite's message, which names the bad value and the pass,
    and leaves the film and the ray count untouched."""
    original = drv._render_pass

    def poisoned(*args):
        out = original(*args)
        out[1][2, 0] = torch.inf
        return out

    r = _small(cornell, spp=2)()
    with mock.patch.object(drv, "_render_pass", poisoned):
        with pytest.raises(FloatingPointError,
                           match=r"1 non-finite values in \['radiance_sq'\] in the pass at spp 0"):
            r.run_resilient(max_retries=1, backoff=0.01, quiet=True)
    assert r.film.spp == 0 and r.rays_traced == 0 and not r.film.spp_map.any()


@pytest.mark.parametrize("shape, scale, cols, rows", [
    ((8, 6), 1.0, 6, 4), ((37, 23), 1.0, 100, 40), ((40, 64), 255.0, 17, 5),
    ((5, 9), 1.3, 100, 40)])
def test_frame_to_ansi_matches_jax(shape, scale, cols, rows):
    """The same string as the JAX package's for the same image: [0, 1]
    floats, 0-255 values, out-of-range values, downsampled and not."""
    img = np.random.RandomState(sum(shape)).rand(*shape, 3).astype(np.float32) * scale
    art = termview.frame_to_ansi(img, cols, rows)
    assert art == termview_jax.frame_to_ansi(img, cols, rows)
    assert "▀" in art and art.endswith("\x1b[0m")


def test_live_view_redraws_in_place():
    """tests/test_render.py::test_termview_ansi_frame's LiveView half: the
    second frame rewinds the first one's art and status lines."""
    img = np.zeros((8, 6, 3), np.float32)
    img[:4] = [1.0, 0.0, 0.0]
    img[4:] = [0.0, 0.0, 1.0]
    outs = []
    for view_cls in (termview.LiveView, termview_jax.LiveView):
        buf = io.StringIO()
        v = view_cls(max_cols=6, max_rows=4, stream=buf)
        v.update(img, "1/2 spp")
        v.update(img, "2/2 spp")
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert "1/2 spp" in outs[0] and "\x1b[5F\x1b[J" in outs[0]


def _cli_args(cornell_path, out, spp=2):
    return [cornell_path, "--cpu", "--res", "16", "16", "--spp", str(spp), "--depth", "2",
            "--estimator", "reference", "--seed", "5", "--out", out]


def test_cli_live_and_resilient(cornell_path, tmp_path, capsys):
    """--live draws the frame on stderr every PASSES passes and silences the
    progress prints; --live --resilient renders the same HDR, bit for bit,
    as a plain run."""
    plain = _cli_args(cornell_path, str(tmp_path / "a.png"), spp=4) + [
        "--hdr-out", str(tmp_path / "a.npy")]
    assert cli.main(plain) == 0
    err = capsys.readouterr().err
    assert "Mrays/s" in err and "▀" not in err

    live = _cli_args(cornell_path, str(tmp_path / "b.png"), spp=4) + [
        "--hdr-out", str(tmp_path / "b.npy"), "--live", "2", "--resilient"]
    assert cli.main(live) == 0
    err = capsys.readouterr().err
    assert "▀" in err and "2/4 spp" in err and "4/4 spp" in err
    assert "1/4 spp" not in err and "Mrays/s" not in err
    np.testing.assert_array_equal(np.load(tmp_path / "a.npy"), np.load(tmp_path / "b.npy"))

    assert cli.main(_cli_args(cornell_path, str(tmp_path / "c.png")) + ["--resilient", "1"]) == 0


def test_cli_adaptive_scene_matches_jax_cli(cornell_path, tmp_path):
    """A scene file with renderer.adaptive_sampling renders adaptively
    through both CLIs (spp 12, the default minimum of 8 and tolerance of
    0.02): the saved films' spp_maps lie in [8, 12] and agree on at least
    PIXEL_AGREEMENT of the pixels."""
    with open(cornell_path) as fh:
        data = json.load(fh)
    data["renderer"]["adaptive_sampling"] = True
    scene_file = str(tmp_path / "adaptive.json")
    with open(scene_file, "w") as fh:
        json.dump(data, fh)
    films = []
    for main in (cli.main, cli_jax.main):
        ckpt = str(tmp_path / f"film{len(films)}.npz")
        args = _cli_args(scene_file, str(tmp_path / f"{len(films)}.png"), spp=12)
        assert main(args + ["--checkpoint", ckpt, "--checkpoint-interval", "1000", "--quiet"]) == 0
        films.append(Film.load(ckpt))
    spp = films[0].spp_map
    assert spp.min() == 8 and spp.max() == 12
    assert (spp == films[1].spp_map).mean() >= PIXEL_AGREEMENT


@pytest.mark.parametrize("op", ["filmic", None])
def test_cli_tonemap_mode_matches_jax(tmp_path, op):
    """The tonemap mode over an EXR and an NPY input: the PNG equals the JAX
    CLI's tonemap mode's, pixel for pixel, to 1 LSB; without --input it
    exits 2."""
    hdr = np.abs(np.random.RandomState(0).standard_normal((12, 10, 3))).astype(np.float32) * 2
    exr, npy = str(tmp_path / "x.exr"), str(tmp_path / "x.npy")
    write_exr(exr, hdr)
    np.save(npy, hdr)
    flags = ["--tonemap", op] if op else []
    for src in (exr, npy):
        ours, theirs = str(tmp_path / "ours.png"), str(tmp_path / "theirs.png")
        assert cli.main(["tonemap", "--cpu", "--input", src, "--out", ours] + flags) == 0
        assert cli_jax.main(["tonemap", "--input", src, "--out", theirs] + flags) == 0
        a, b = iio.imread(ours).astype(int), iio.imread(theirs).astype(int)
        assert a.shape == (12, 10, 3) and a.max() > 0
        assert np.abs(a - b).max() <= 1
    assert cli.main(["tonemap", "--cpu"]) == 2


def test_cli_tonemap_without_gpu_exits_2(tmp_path, monkeypatch, capsys):
    """Without --cpu the tonemap mode computes on the GPU; with none it
    exits 2 and writes nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    npy = str(tmp_path / "x.npy")
    np.save(npy, np.ones((4, 4, 3), np.float32))
    out = tmp_path / "o.png"
    assert cli.main(["tonemap", "--input", npy, "--out", str(out)]) == 2
    assert not out.exists() and "--cpu" in capsys.readouterr().err


def test_checks_on_the_cpu():
    """assert_all_finite names the bad leaf's path as jax.tree_util.keystr
    does (the JAX package's message on the same structure of arrays);
    finite trees, integer leaves and None pass."""
    Pair = collections.namedtuple("Pair", "a b")
    for bad_path in ("x", "y", "z"):
        tree = {"x": [np.zeros(2, np.float32), np.ones(3, np.int32)],
                "y": Pair(np.zeros(1, np.float32), np.zeros((2, 2), np.float32)),
                "z": np.zeros(4, np.float32)}
        checks.assert_all_finite(tree)
        if bad_path == "x":
            tree["x"][0][1] = np.nan
        elif bad_path == "y":
            tree["y"].b[1, 0] = np.inf
        else:
            tree["z"][:2] = np.nan
        with pytest.raises(FloatingPointError) as theirs:
            checks_jax.assert_all_finite(tree, "at pass 3")
        torch_tree = {k: ([torch.from_numpy(x) for x in v] if isinstance(v, list)
                          else Pair(*map(torch.from_numpy, v)) if isinstance(v, Pair)
                          else torch.from_numpy(v)) for k, v in tree.items()}
        for t in (tree, torch_tree):
            with pytest.raises(FloatingPointError) as ours:
                checks.assert_all_finite(t, "at pass 3")
            assert str(ours.value) == str(theirs.value)
    checks.assert_all_finite([None, torch.ones(2, dtype=torch.int64)])

