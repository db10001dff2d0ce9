"""pyrenderer_tpu_torch/debug/logger.py, the ray-path records: the tests of
tests/test_debug.py on the port, then parity with the JAX package's
log_paths, the .npz layout, the records under the coherence sort and the
CLI's --debug-paths."""

import dataclasses
import json
import re

import numpy as np
import pytest
import torch

from pyrenderer_tpu.config import RenderConfig as JaxConfig
from pyrenderer_tpu.debug.logger import log_paths as log_paths_jax
from pyrenderer_tpu.ref import scalar as ref
from pyrenderer_tpu.scene.tungsten import load_tungsten
from pyrenderer_tpu_torch.config import RenderConfig
from pyrenderer_tpu_torch.core import integrator as integ
from pyrenderer_tpu_torch.core.camera import generate_rays
from pyrenderer_tpu_torch.debug.logger import RayPathLog, log_paths
from pyrenderer_tpu_torch.render import cli
from pyrenderer_tpu_torch.scene import procgen, to_device
from pyrenderer_tpu_torch.scene.tungsten import build_scene

torch.set_num_threads(2)

CFG = RenderConfig(max_bounces=4, seed=3)
MASKS = ("hit", "alive", "tri", "nee_visible")
FLOATS = ("hit_point", "normal", "wi", "t", "beta", "radiance", "light_point")


@pytest.fixture(scope="module")
def cornell64(cornell_path):
    host, camera, _ = load_tungsten(cornell_path)
    camera = camera._replace(resolution=(64, 64))
    scene, cam = to_device(host, camera, "cpu")
    return host, camera, scene, cam


@pytest.fixture(scope="module")
def log(cornell64):
    _, _, scene, cam = cornell64
    xs = np.array([10, 32, 50], np.int32)
    ys = np.array([32, 32, 20], np.int32)
    return log_paths(scene, cam, CFG, xs, ys)


def test_log_shapes(log):
    assert log.hit_point.shape == (4, 3, 3)
    assert log.hit.dtype == bool
    # primary rays all hit something in a closed box
    assert log.hit[0].all()
    # bounce-0 hit distances are camera->wall scale
    assert (log.t[0] > 5).all() and (log.t[0] < 12).all()


def test_segments_and_ply(log, tmp_path):
    segs = log.segments()
    assert len(segs) >= 3
    kinds = {k for _, _, k in segs}
    assert "path" in kinds
    # path segments connect: first segment starts at the camera
    a, b, _ = segs[0]
    np.testing.assert_allclose(a, [0, 1, 6.8], atol=1e-5)
    ply = tmp_path / "paths.ply"
    log.write_ply(str(ply))
    text = ply.read_text()
    assert text.startswith("ply")
    assert "element edge" in text
    npz = tmp_path / "paths.npz"
    log.save(str(npz))
    loaded = np.load(npz)
    assert "hit_point" in loaded


def test_points_inside_box(log):
    """All recorded hit points must lie in the Cornell box volume."""
    pts = log.hit_point[log.hit]
    assert (pts[:, 0] > -1.01).all() and (pts[:, 0] < 1.01).all()
    assert (pts[:, 1] > -0.01).all() and (pts[:, 1] < 2.01).all()
    assert (pts[:, 2] > -1.01).all() and (pts[:, 2] < 1.01).all()


@pytest.mark.parametrize("scene_kind", ["host", "tensors"])
def test_write_html_viewer(log, tmp_path, cornell64, scene_kind):
    """Self-contained interactive viewer: one HTML file, valid embedded
    JSON payload, no external resources (works offline, the headless
    replacement for the reference's open3d windows). The scene may be the
    loader's host arrays or the port's tensors."""
    host, _, scene, _ = cornell64
    out = tmp_path / "paths.html"
    log.write_html(str(out), scene=host if scene_kind == "host" else scene)
    html = out.read_text()
    assert "http://" not in html and "https://" not in html  # no CDN
    m = re.search(r"const DATA = (\{.*?\});\n", html, re.S)
    data = json.loads(m.group(1))
    assert len(data["paths"]) >= 1
    assert all(len(p) >= 2 for p in data["paths"])
    assert len(data["wire"]) > 0 and data["radius"] > 0
    # paths start at the camera
    np.testing.assert_allclose(data["paths"][0][0], [0, 1, 6.8], atol=1e-4)


# --- parity with the JAX package ------------------------------------------


@pytest.fixture(scope="module")
def logs256(cornell64):
    """Both packages' logs of 256 seeded pixels of the 64x64 Cornell frame
    at 4 bounces, and the pixels."""
    host, camera, scene, cam = cornell64
    rs = np.random.RandomState(0)
    px = rs.randint(0, 64, 256).astype(np.int32)
    py = rs.randint(0, 64, 256).astype(np.int32)
    log_j = log_paths_jax(host, camera, JaxConfig(max_bounces=4, seed=3), px, py)
    return log_j, log_paths(scene, cam, CFG, px, py), py.astype(np.int64) * 64 + px


def _mismatched_rays(a, b):
    return int((~np.isclose(a, b, rtol=1e-4, atol=1e-6).all(axis=1)).sum())


def test_records_match_jax(logs256, cornell64):
    """The port's records of 256 Cornell pixels (64x64, 4 bounces) against
    JAX log_paths:
      - hit, alive and tri equal on >= 99% of the (bounce, ray) records
        (XLA:CPU's FMA contraction can move a later bounce's origin across
        an edge); measured: every record;
      - nee_visible flipped on <= 2% (the grazing shadow rays whose origin
        rounds differently); measured: 1 of the 1,024 records;
      - the float records at rtol 1e-4 (atol 1e-6) on every ray whose
        masks and tri agree up to that bounce, but for wi at atol 2e-5: a
        cosine sample near the hemisphere's rim takes z = sqrt(1 - r^2)
        of r^2 within 2e-5 of 1, where one ulp of the two frameworks' sin
        and cos moves z by 1.4e-5 (measured on one ray of the 252);
      - the last bounce's radiance no further from the NumPy oracle
        (pyrenderer_tpu/ref/scalar.py trace_reference) in float32 than
        JAX's is (measured: the port 0 rays apart, JAX 3), and in float64
        each within 2% of the rays (measured: JAX 3, the port 4; in float64
        the oracle parts from both float32 paths on grazing shadow rays)."""
    log_j, log, pixel = logs256
    for k in ("hit", "alive", "tri"):
        assert (getattr(log, k) == getattr(log_j, k)).mean() >= 0.99, k
    assert (log.nee_visible != log_j.nee_visible).mean() <= 0.02
    assert log.hit[0].all() and log.alive[1].any() and log.nee_visible.any()
    agree = np.ones(256, bool)
    for b in range(log.n_bounces):
        for k in MASKS:
            agree &= getattr(log, k)[b] == getattr(log_j, k)[b]
        assert agree.mean() >= 0.95
        for k in FLOATS:
            np.testing.assert_allclose(getattr(log, k)[b][agree], getattr(log_j, k)[b][agree],
                                       rtol=1e-4, atol=2e-5 if k == "wi" else 1e-6,
                                       err_msg=f"{k} at bounce {b}")

    host = cornell64[0]
    for dtype in (np.float32, np.float64):
        oracle = np.array([
            ref.trace_reference(host, CFG, log_j.origin[i].astype(dtype),
                                log_j.first_dir[i].astype(dtype), int(pixel[i]), 0, CFG.seed,
                                dtype)
            for i in range(256)])
        apart, apart_j = (_mismatched_rays(x.radiance[-1], oracle) for x in (log, log_j))
        if dtype is np.float32:
            assert apart <= apart_j
        else:
            assert max(apart, apart_j) <= 0.02 * 256


def test_npz_matches_jax_layout(logs256, tmp_path):
    """The .npz has JAX's keys, dtypes and shapes (float32, int32 tri, bool
    masks), and loads back into a RayPathLog."""
    log_j, log, _ = logs256
    log.save(str(tmp_path / "port.npz"))
    log_j.save(str(tmp_path / "jax.npz"))
    port, jx = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert sorted(port.files) == sorted(jx.files)
    for k in jx.files:
        assert (port[k].dtype, port[k].shape) == (jx[k].dtype, jx[k].shape), k
    assert port["tri"].dtype == np.int32 and port["hit"].dtype == bool
    back = RayPathLog(**{k: port[k] for k in port.files})
    assert len(back.segments()) == len(log.segments())


def test_collect_paths_leaves_radiance_unchanged(cornell64):
    """trace_reference with collect_paths returns the radiance of the same
    call without it, bit for bit, and its last record."""
    _, _, scene, cam = cornell64
    rs = np.random.RandomState(1)
    px, py = (torch.from_numpy(rs.randint(0, 64, 300)) for _ in range(2))
    ro, rd = generate_rays(cam, px, py, 2, CFG.seed)
    pixel = py * 64 + px
    plain = integ.trace_reference(scene, CFG, ro, rd, pixel, 2, CFG.seed)
    rad, records = integ.trace_reference(scene, CFG, ro, rd, pixel, 2, CFG.seed,
                                         collect_paths=True)
    assert torch.equal(rad, plain) and torch.equal(records["radiance"][-1], plain)
    assert sorted(records) == sorted(FLOATS + MASKS)
    assert all(v.shape[:2] == (CFG.max_bounces, 300) for v in records.values())


def test_cluster_records_same_under_the_coherence_sort(monkeypatch):
    """log_paths with backend "cluster" on a procgen terrain (2,060
    triangles): the records with cluster_sort=True (each cluster query
    sorts its rays and scatters the results back) equal those with
    cluster_sort=False, every record bit for bit. Two suspend/resume rounds
    put the closest-hit query through the sorted operands on the CPU too;
    the sort is seen to reorder rays."""
    from pyrenderer_tpu_torch.kernels import cluster as kc

    host, camera, _ = build_scene(procgen.big_scene_data("terrain", res=32))
    scene, cam = to_device(host, camera._replace(resolution=(32, 32)), "cpu")
    ys, xs = np.mgrid[0:32, 0:32]
    cfg = RenderConfig(max_bounces=3, seed=3, cluster_rounds=2, cluster_budget=2)
    perms = []
    prepare = kc._prepare

    def recording_prepare(*args):
        rays, perm = prepare(*args)
        perms.append(perm)
        return rays, perm

    monkeypatch.setattr(kc, "_prepare", recording_prepare)
    logs = {}
    for sort in (False, True):
        perms.clear()
        logs[sort] = dataclasses.asdict(log_paths(
            scene, cam, cfg.replace(cluster_sort=sort), xs.reshape(-1), ys.reshape(-1),
            backend="cluster"))
        assert len(perms) == cfg.max_bounces
        assert all((p is not None) is sort for p in perms)
    assert not torch.equal(perms[0], torch.arange(32 * 32))
    # measured: 40%, 34% and 28% of the rays hit at bounces 0-2
    assert logs[False]["hit"][-1].mean() > 0.2 and logs[False]["nee_visible"][-1].any()
    for k, v in logs[False].items():
        np.testing.assert_array_equal(logs[True][k], v, err_msg=k)


def test_cli_debug_paths(cornell_path, tmp_path, capsys):
    """The CLI's --debug-paths --cpu traces a sqrt-grid of --debug-rays
    pixels and writes the HTML viewer and the PLY beside it."""
    html = tmp_path / "p.html"
    assert cli.main([cornell_path, "--cpu", "--res", "64", "64", "--depth", "4",
                     "--debug-rays", "30", "--debug-paths", str(html)]) == 0
    assert f"wrote {html} and {tmp_path / 'p.ply'} (25 paths)" in capsys.readouterr().err
    data = json.loads(re.search(r"const DATA = (\{.*?\});\n", html.read_text(), re.S).group(1))
    assert len(data["paths"]) == 25 and len(data["wire"]) > 0
    ply = (tmp_path / "p.ply").read_text()
    assert ply.startswith("ply\nformat ascii 1.0\n") and "element edge" in ply
