"""The plain reference on the CPU: the scene loader against the program's,
the reference against the program's plain twins, the reference against
itself across chunkings and across its two intersection layouts, the
comparison failing on the scene cast to and computed in a lower precision
(the control) and on the training faults, and passing a rounding change."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from benchmark import compare, harness
from benchmark.reference import render as R
from benchmark.reference import scene as S
from conftest import ROOT, small_cell

CELLS = ["cornell.render", "terrain100k.render"]


def _config(name):
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["cornell", "terrain100k"])
def test_scene_loader_matches_the_programs(name):
    from pyrenderer_tpu_torch.scene import procgen
    from pyrenderer_tpu_torch.scene.tungsten import build_scene

    arrays, camera = S.load(_config(name)["scene"])
    if name == "cornell":
        data = json.loads((ROOT / "scenes" / "cornell_box.json").read_text())
    else:
        data = procgen.big_scene_data("terrain", res=224)
    host, cam, _ = build_scene(data)
    for field in host._fields:
        ours, theirs = arrays[field], np.asarray(getattr(host, field))
        assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs), field
    assert np.array_equal(camera["iview"], cam.iview)
    assert arrays["faces"].shape[0] == {"cornell": 36, "terrain100k": 100364}[name]


def _pixels(w, h):
    ys, xs = np.mgrid[0:h, 0:w]
    return torch.as_tensor(xs.reshape(-1)), torch.as_tensor(ys.reshape(-1))


@pytest.mark.parametrize("name", CELLS)
def test_reference_equals_the_programs_twins(bench, name):
    """At 16 x 16, one sample: the reference's radiance and the program's
    render_sample through its CPU twins ("brute" for the whole-table
    kernels, the cluster sweep's twins) agree bit for bit."""
    from pyrenderer_tpu_torch.config import RenderConfig
    from pyrenderer_tpu_torch.core.integrator import TraceTables, render_sample
    from pyrenderer_tpu_torch.scene.types import Camera, Scene, to_device

    cell = small_cell(name, bench)
    arrays, camera = S.load(cell.config["scene"])
    camera["resolution"] = tuple(cell.config["resolution"])
    scene, cam = to_device(Scene(**arrays), Camera(**camera), "cpu")
    cfg = RenderConfig(max_bounces=cell.config["max_bounces"], seed=2**31 + 77,
                       estimator="reference", **cell.config["render"])
    tables = TraceTables(scene, cfg, cell.config["backend"])
    px, py = _pixels(*camera["resolution"])
    prog = render_sample(scene, cam, cfg, cfg.seed, 3, px, py, tables=tables)
    ref = R.Reference(arrays, camera, cell.config, "cpu")
    mine = ref.trace(px, py, torch.full_like(px, 3), cfg.seed)
    assert torch.equal(prog, mine)
    assert float(mine.mean()) > 0.01


def test_reference_agrees_with_itself_across_chunkings(bench):
    cell = small_cell("cornell.render", bench, res=8)
    arrays, camera = S.load(cell.config["scene"])
    camera["resolution"] = (8, 8)
    ref = R.Reference(arrays, camera, cell.config, "cpu")
    px, py = _pixels(8, 8)
    sums = [ref.pixel_sums(px, py, 5, 11, lanes=lanes) for lanes in (7, 64, 320, None)]
    for s in sums[1:]:
        assert np.array_equal(s[0], sums[0][0]) and np.array_equal(s[1], sums[0][1])


def test_blocked_triangles_agree_with_every_face():
    """The terrain's reference tests only the blocks a ray's box test keeps;
    the closest face and the occlusion equal testing every face."""
    arrays, _ = S.load(_config("terrain100k")["scene"])
    v = torch.as_tensor(arrays["vertices"])
    f = torch.as_tensor(arrays["faces"].astype(np.int64))
    corners = (v[f[:, 0]], v[f[:, 1]], v[f[:, 2]])
    tris = R.Triangles(*corners, "watertight", "cpu")
    assert tris.blocked
    g = torch.Generator().manual_seed(5)
    n = 48
    ro = torch.rand(n, 3, generator=g) * torch.tensor([1.6, 0.6, 1.6]) - torch.tensor([0.8, 0, 0.8])
    ro[:, 1] += 0.45
    rd = torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=-1)
    rd[:, 1] = -rd[:, 1].abs()
    t1 = torch.full((n,), 99999.9)
    hit, face = tris.closest(ro, rd, 1e-5, t1)
    ok, t = R._watertight(*corners, ro, rd, 1e-5, t1)
    best, every = torch.where(ok, t, torch.inf).min(dim=1)
    assert torch.equal(hit, torch.isfinite(best)) and int(hit.sum()) > n // 2
    assert torch.equal(face[hit], every[hit])
    short = torch.where(hit, best * 0.5, 99999.9)
    expect = (ok & (t < short[:, None])).any(dim=1)
    assert torch.equal(tris.occluded(ro, rd, 1e-5, short), expect)


@pytest.mark.parametrize("name", CELLS + ["cornell.train"])
def test_control_fails(bench, name):
    """The reference with its scene cast to bfloat16 and computed in it
    (the control) against float32: the cell's limits call it not correct."""
    cell = small_cell(name, bench)
    numbers = cell.driver.control_numbers(cell, 9, "cpu", "bfloat16", samples=6)
    correct, checks = compare.judge(numbers, cell.checks["limits"])
    assert not correct, checks


@pytest.mark.parametrize("variant", ["half_batch", "altered"])
def test_training_faults_in_the_reference_fail(bench, variant):
    """The faults planted in the reference put in the program's place."""
    cell = small_cell("cornell.train", bench)
    numbers = cell.driver.control_numbers(cell, 4, "cpu", variant)
    assert not compare.judge(numbers, cell.checks["limits"])[0], numbers


@pytest.mark.parametrize("chunk", [1 << 16, 96])
def test_training_reference_equals_the_programs_steps(bench, monkeypatch, chunk):
    """At 16 x 16 on the CPU, in one chunk and in three, the program's three
    steps and the reference's agree: the losses bit for bit, the parameters
    to 1e-15 (the gradients' sums round apart where a vertex coordinate is
    ~1e-8)."""
    from pyrenderer_tpu_torch.dist import render

    from benchmark.reference import train as ref_train

    monkeypatch.setattr(render, "CHUNK", chunk)
    monkeypatch.setattr(ref_train, "CHUNK", chunk)
    cell = small_cell("cornell.train", bench)
    drv = cell.driver.Driver(cell, 2**31 + 3, "cpu")
    drv.setup()
    ref = cell.driver.reference_steps(cell, 2**31 + 3, "cpu")
    assert drv.losses == ref["losses"]
    for a, b in zip(drv.checked, ref["params"]):
        for x, y in zip(a, b):
            assert np.abs(x - y).max() < 1e-15
    numbers = compare.train_numbers({"losses": drv.losses, "params": drv.checked}, ref, drv.lr)
    assert max(numbers.values()) < 1e-6, numbers


def test_judge_limits():
    ok, checks = compare.judge({"a": 0.0, "b": 0.5}, {"a": 0, "b": 0.5})
    assert ok and checks == {"a": {"value": 0.0, "limit": 0}, "b": {"value": 0.5, "limit": 0.5}}
    assert not compare.judge({"a": None}, {"a": 1})[0]
    assert not compare.judge({"a": float("nan")}, {"a": 1})[0]


def test_a_film_with_a_sample_gap_is_not_compared():
    called = []
    numbers = compare.film_numbers(np.zeros((4, 3)), np.array([[3, 3], [3, 2]]),
                                   lambda: called.append(1), 3)
    assert numbers == {"spp_gap": 1.0, "outlier_share": None, "mean_gap": None} and not called


@pytest.mark.parametrize("name", CELLS)
def test_a_rounding_change_passes(bench, name):
    """The reference in float64 against float32: every rounding moves and
    some paths go elsewhere (at 32 x 32, 24 samples, 9% of the Cornell
    pixels differ by more than 1e-3), as a sound change of the program's
    arithmetic may make them; the comparison calls it correct."""
    cell = small_cell(name, bench, res=24)
    numbers = cell.driver.control_numbers(cell, 5, "cpu", "float64", samples=12)
    assert compare.judge(numbers, cell.checks["limits"])[0], numbers


@pytest.mark.cuda
def test_cell_and_control_on_the_card(bench, cuda_device, monkeypatch):
    """On the card at 64 x 64: a run of the Cornell cell is correct, the
    reference there and on the CPU differ only as roundings do (another
    libm), and the control fails."""
    cell = small_cell("cornell.render", bench, res=64)
    monkeypatch.setattr(harness, "load_cell", lambda *a, **k: cell)
    assert harness.run_cell("cornell.render", 21, 1.0, False, device=cuda_device)["correct"]
    arrays, camera = S.load(cell.config["scene"])
    camera["resolution"] = (64, 64)
    px, py = _pixels(64, 64)
    cpu = R.Reference(arrays, camera, cell.config, "cpu").pixel_sums(px, py, 8, 21)
    gpu = R.Reference(arrays, camera, cell.config, cuda_device).pixel_sums(
        px.to(cuda_device), py.to(cuda_device), 8, 21)
    numbers = compare.film_numbers(gpu[0], np.full((64, 64), 8), lambda: cpu, 8)
    assert compare.judge(numbers, cell.checks["limits"])[0], numbers
    assert not compare.judge(cell.driver.control_numbers(cell, 21, cuda_device, samples=8),
                             cell.checks["limits"])[0]


def test_checks_files_hold_the_cells_limits(bench):
    numbers = {"progressive": {"spp_gap", "outlier_share", "mean_gap"},
               "train": {"loss_gap", "grad_gap", "change_gap"}}
    for w in bench["workloads"]:
        cell = harness.load_cell(w["name"], bench)
        assert set(cell.checks["limits"]) == numbers[cell.traffic["driver"]]
        assert cell.checks["limits"].get("spp_gap", 0) == 0
