"""The benchmark cell cornell.cli on the CPU at 16 x 16: the plain pbrt
reference (benchmark/reference/render_pbrt.py) against the program's
trace_pbrt through its CPU twins, the cell's driver and its comparison
(the program passes, the bfloat16 control fails, a float64 reference
passes), and the program's spans `nee` and `scatter` with the readers of
the cell's per-layer metrics."""

from __future__ import annotations

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import compare, harness
from benchmark.metrics import _spans
from benchmark.reference import render_pbrt
from benchmark.reference import scene as scene_data
from pyrenderer_tpu_torch.config import RenderConfig
from pyrenderer_tpu_torch.core.integrator import TraceTables, render_sample
from pyrenderer_tpu_torch.render.driver import ProgressiveRenderer
from pyrenderer_tpu_torch.scene.types import Camera, Scene, to_device
from pyrenderer_tpu_torch.utils import profiling

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
RES = 16
CHUNK = 64      # 4 chunks of a 16 x 16 pass


@pytest.fixture
def run_cell(monkeypatch):
    """harness.run_cell on the CPU with the cell cut to 16 x 16. The test
    process holds jax (tests/conftest.py imports it for the JAX package's
    tests), so the harness's check for it is left out here; a run of the
    benchmark alone keeps it (benchmark/tests/test_cellbench_imports.py)."""
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])

    def run(seed, seconds, trace):
        cell = _cell()
        monkeypatch.setattr(harness, "load_cell", lambda *a, **k: cell)
        return harness.run_cell("cornell.cli", seed, seconds, trace, device="cpu")

    return run


def _cell(res=RES):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.load_cell("cornell.cli", copy.deepcopy(bench))
    cell.config["resolution"] = [res, res]
    return cell


def _program(cell, seed):
    arrays, camera = scene_data.load(cell.config["scene"])
    camera["resolution"] = tuple(cell.config["resolution"])
    scene, cam = to_device(Scene(**arrays), Camera(**camera), "cpu")
    cfg = RenderConfig(max_bounces=cell.config["max_bounces"], seed=seed,
                       estimator=cell.config["estimator"], **cell.config["render"])
    return arrays, camera, scene, cam, cfg


def _pixels(w, h):
    ys, xs = np.mgrid[0:h, 0:w]
    return torch.as_tensor(xs.reshape(-1)), torch.as_tensor(ys.reshape(-1))


def test_configuration_is_the_clis_default():
    """16 bounces of pbrt with Russian roulette from 4, on cornell.json's
    scene: the scene's own integrator.max_bounces, the CLI's estimator."""
    cell = _cell()
    base = json.loads((ROOT / "benchmark" / "configs" / "cornell.json").read_text())
    assert cell.config["scene"] == base["scene"]
    assert cell.config["max_bounces"] == base["scene"]["integrator"]["max_bounces"] == 16
    assert cell.config["estimator"] == "pbrt" and cell.config["reduced"] == ["spp"]
    rr_start = cell.config["render"]["russian_roulette_start"]
    assert rr_start == RenderConfig().russian_roulette_start == 4
    assert cell.traffic["driver"] == "progressive_pbrt" and cell.entry["chips"] == 1


@pytest.mark.parametrize("seed,sample", [(2**31 + 77, 3), (5, 0)])
def test_pbrt_reference_equals_the_programs_twins(seed, sample):
    """One sample of every pixel, 16 bounces, Russian roulette from 4: the
    reference's radiance and the program's render_sample through its CPU
    twins ("brute" for the whole-table kernels) agree bit for bit, and
    Russian roulette ends lanes (fewer rays traced than with it off)."""
    cell = _cell()
    arrays, camera, scene, cam, cfg = _program(cell, seed)
    tables = TraceTables(scene, cfg, cell.config["backend"])
    assert tables.backend == "brute"
    px, py = _pixels(RES, RES)
    prog, rays = render_sample(scene, cam, cfg, seed, sample, px, py, tables=tables,
                               with_stats=True)
    ref = render_pbrt.PbrtReference(arrays, camera, cell.config, "cpu")
    mine = ref.trace(px, py, torch.full_like(px, sample), seed)
    assert torch.equal(prog, mine)
    assert float(mine.mean()) > 0.01
    cfg_off = cfg.replace(russian_roulette_start=cfg.max_bounces)
    _, rays_off = render_sample(scene, cam, cfg_off, seed, sample, px, py,
                                tables=TraceTables(scene, cfg_off, "brute"), with_stats=True)
    assert float(rays) < float(rays_off)


def test_reference_refuses_metal_and_glass():
    cell = _cell()
    arrays, camera = scene_data.load(cell.config["scene"])
    arrays["mat_type"] = np.where(np.arange(arrays["mat_type"].size) == 0, 2,
                                  arrays["mat_type"]).astype(np.int32)
    with pytest.raises(ValueError, match="lambert and light"):
        render_pbrt.PbrtReference(arrays, camera, cell.config, "cpu")


def test_the_cells_run_is_correct(run_cell):
    """The harness's whole run of the cell, its film judged against the
    pbrt reference: the CPU twins and the reference run the same
    arithmetic, so every compared number is 0."""
    res = run_cell(2**31 + 5, 0.3, False)
    assert res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == {"samples_per_s", "setup_s"}
    assert all(c["value"] == 0.0 for c in res["checks"].values())


@pytest.mark.parametrize("variant,correct", [("bfloat16", False), ("float64", True),
                                             ("rr_off", False)])
def test_control_fails_and_a_rounding_change_passes(variant, correct):
    """The reference computed in bfloat16 (the control, one precision below
    the configuration's float32) is not correct by the cell's limits; in
    float64 every rounding moves and some paths go elsewhere, as a sound
    change of the program's arithmetic may, and it is correct. Russian
    roulette taken out keeps the mean and fails by sq_gap alone (here
    7.6e-4, the float64 reference 1.9e-5, the limit 1.5e-4)."""
    cell = _cell()
    numbers = cell.driver.control_numbers(cell, 9, "cpu", variant, samples=12)
    assert compare.judge(numbers, cell.checks["limits"])[0] is correct, numbers


def test_sq_gap_reads_the_summed_squares():
    """sq_gap is the relative gap of the films' summed squares; a film with
    a sample gap is not compared."""
    driver = _cell().driver
    f = np.array([[1.0, 2.0, 2.0]])
    ref = (np.array([[1.0, 2.0, 2.0]]), np.array([[1.0, 4.0, 5.0]]))
    numbers = driver.film_numbers(f, np.array([[1.0, 4.0, 4.0]]), np.full((2, 2), 1),
                                  lambda: ref, 1)
    assert numbers["sq_gap"] == pytest.approx(0.1)
    numbers = driver.film_numbers(f, f, np.array([[1, 0]]), lambda: ref, 1)
    assert numbers["sq_gap"] is None and not compare.judge(numbers, {"sq_gap": 1})[0]


def test_checks_hold_the_drivers_numbers():
    """The cell's limits name the numbers its driver gives, spp_gap exact."""
    cell = _cell()
    assert set(cell.checks["limits"]) == {"spp_gap", "outlier_share", "mean_gap", "sq_gap"}
    assert cell.checks["limits"]["spp_gap"] == 0


def _render_pass(cell, seed, record):
    arrays, camera, scene, cam, cfg = _program(cell, seed)
    r = ProgressiveRenderer(scene, cam, cfg, backend=cell.config["backend"], chunk=CHUNK)
    if not record:
        r.render_one_pass()
        return r.film, None
    with profiling.recording("cpu") as rec:
        r.render_one_pass()
    return r.film, rec


def test_nee_and_scatter_spans():
    """A pass records `nee` and `scatter` once a bounce of each chunk, each
    directly inside a `bounce`; the film is the same bits with recording on
    and off."""
    cell = _cell()
    film, rec = _render_pass(cell, 2**31 + 9, record=True)
    plain, _ = _render_pass(cell, 2**31 + 9, record=False)
    assert np.array_equal(film.radiance_sum, plain.radiance_sum)
    assert np.array_equal(film.sq_sum, plain.sq_sum)
    chunks = RES * RES // CHUNK
    for name in ("nee", "scatter"):
        spans = [s for s in rec.spans if s.name == name]
        assert len(spans) == cell.config["max_bounces"] * chunks
        assert all(rec.spans[s.parent].name == "bounce" for s in spans)
    assert sum(s.name == "bounce" for s in rec.spans) == cell.config["max_bounces"] * chunks


def test_the_reference_estimator_has_no_new_span():
    cell = _cell()
    cell.config.update(estimator="reference", max_bounces=4)
    _, rec = _render_pass(cell, 3, record=True)
    assert not {"nee", "scatter"} & {s.name for s in rec.spans}


def _ctx(rec, syncs_counted=False):
    counters = {"spans": [(s.name, s.start_ns, s.end_ns, s.parent, s.unit, s.syncs)
                          for s in rec.spans], "syncs_counted": syncs_counted}
    return harness.TraceContext(1, 0.0, [], {}, counters, {})


def test_span_readers_follow_the_recorders_summary():
    """The readers' arithmetic over the handed-over spans gives what
    Recorder.summary gives; without the spans they read nothing."""
    cell = _cell()
    _, rec = _render_pass(cell, 2**31 + 9, record=True)
    summary = rec.summary("pass")["spans"]
    ctx = _ctx(rec)
    for name in ("nee", "scatter"):
        assert _spans.ms_per_unit(ctx, {name}) == pytest.approx(summary[name]["ms"], rel=1e-12)
    shade = summary["camera"]["self_ms"] + summary["bounce"]["self_ms"]
    assert _spans.ms_per_unit(ctx, {"camera", "bounce"}, self_time=True) == pytest.approx(
        shade, rel=1e-12)
    assert _spans.syncs_per_unit(ctx) is None
    assert _spans.syncs_per_unit(_ctx(rec, syncs_counted=True)) == 0
    # a program without the spans (the parent of the cell) reads None
    parent = _ctx(rec)
    parent.counters["spans"] = [s for s in parent.counters["spans"]
                                if s[0] not in ("nee", "scatter")]
    assert _spans.ms_per_unit(parent, {"nee"}) is None
    empty = harness.TraceContext(1, 0.0, [], {}, {}, {})
    assert _spans.ms_per_unit(empty, {"camera", "bounce"}, self_time=True) is None


def test_traced_run_reads_the_span_metrics(run_cell):
    """A --trace 1 run of the cell on the CPU: the passes recorded after
    the window reach the readers (no device here: no device metric, and
    no sync is counted), and the film, recorded passes included, is
    judged correct."""
    res = run_cell(2**31 + 5, 0.2, True)
    assert res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == {"film_ms_per_pass.render", "nee_ms_per_pass.cli",
                                   "scatter_ms_per_pass.cli", "shade_ms_per_pass.cli"}
    assert all(v["value"] > 0 for v in res["metrics"].values())
