"""The benchmark cell spheres.pbrt on the CPU at 16 x 16: the configuration
against scenes/spheres.json and the CLI's defaults, the benchmark's
specular scene loader against the program's, the plain specular pbrt
reference (benchmark/reference/render_pbrt_specular.py) against the
program's trace_pbrt through its CPU twins on lambert, metal and glass
faces with the stratified camera, the cell's run and its comparison (the
program passes, the bfloat16 control and the planted faults as the card
reads them), the program counters closest_rays and shadow_rays, and the
readers of closest_hit_roofline.pbrt and any_hit_roofline.pbrt. On the
card (marked `cuda`): pbrt_hit's two counts against the eager loop's."""

from __future__ import annotations

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import compare, harness
from benchmark.metrics import _lanes
from benchmark.reference import render_pbrt_specular as reference
from benchmark.reference import scene as scene_data
from benchmark.reference import scene_specular
from pyrenderer_tpu_torch.config import RenderConfig
from pyrenderer_tpu_torch.core import integrator_pbrt as ip
from pyrenderer_tpu_torch.core.integrator import (
    AUTO_BRUTE_MAX_TRIS,
    TraceTables,
    render_sample,
)
from pyrenderer_tpu_torch.core.camera import generate_rays
from pyrenderer_tpu_torch.kernels import pbrt as pk
from pyrenderer_tpu_torch.render.driver import ProgressiveRenderer
from pyrenderer_tpu_torch.scene.tungsten import build_scene
from pyrenderer_tpu_torch.scene.types import (
    MAT_DIELECTRIC,
    MAT_LAMBERT,
    MAT_METAL,
    Camera,
    Scene,
    to_device,
)
from pyrenderer_tpu_torch.utils import profiling

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SPHERES = ROOT / "scenes" / "spheres.json"
RES = 16
CELL = "spheres.pbrt"


def _cell(res=RES):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.load_cell(CELL, copy.deepcopy(bench))
    cell.config["resolution"] = [res, res]
    return cell


@pytest.fixture
def run_cell(monkeypatch):
    """harness.run_cell on the CPU with the cell cut to 16 x 16 and 64
    compared pixels (the test process holds jax for the JAX package's
    tests, so the harness's check for it is left out here)."""
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])

    def run(seed, seconds, trace):
        cell = _cell()
        cell.checks["compare_pixels"] = 64
        monkeypatch.setattr(harness, "load_cell", lambda *a, **k: cell)
        return harness.run_cell(CELL, seed, seconds, trace, device="cpu")

    return run


def _program(cell, seed):
    arrays, camera = scene_specular.load(cell.config["scene"])
    camera["resolution"] = tuple(cell.config["resolution"])
    scene, cam = to_device(Scene(**arrays), Camera(**camera), "cpu")
    cfg = RenderConfig(max_bounces=cell.config["max_bounces"], seed=seed,
                       spp=cell.config["scene"]["renderer"]["spp"],
                       stratified=cell.config["stratified"],
                       estimator=cell.config["estimator"], **cell.config["render"])
    return arrays, camera, scene, cam, cfg


def _pixels(w, h):
    ys, xs = np.mgrid[0:h, 0:w]
    return torch.as_tensor(xs.reshape(-1)), torch.as_tensor(ys.reshape(-1))


def test_configuration_is_the_scene_as_the_cli_renders_it():
    """The cell's scene is scenes/spheres.json as it stands; its bounces,
    resolution, strata and spp are the scene file's, its estimator, Russian
    roulette and intervals the CLI's defaults; only spp is cut, and every
    default it relies on is listed under `assumed`."""
    cell = harness.load_cell(CELL)
    data = json.loads(SPHERES.read_text())
    cfg = cell.config
    assert cfg["scene"] == data
    from_scene = RenderConfig.from_tungsten(data)
    assert cfg["max_bounces"] == from_scene.max_bounces == 12
    assert cfg["resolution"] == data["camera"]["resolution"] == [512, 512]
    assert cfg["stratified"] is from_scene.stratified is True and from_scene.spp == 64
    assert reference.strata_of(from_scene.spp) == 8
    defaults = RenderConfig()
    assert cfg["render"] == {k: getattr(defaults, k) for k in
                             ("t_min", "t_max", "shadow_eps", "russian_roulette_start")}
    assert cfg["estimator"] == "pbrt" and cfg["backend"] == "auto"
    assert cfg["reduced"] == ["spp"] and cfg["spp"] is None
    assert set(cfg["assumed"]) == {"estimator", "russian_roulette_start", "stratified",
                                   "backend", "triangle_test", "render"}
    cli = (ROOT / "pyrenderer_tpu_torch" / "render" / "cli.py").read_text()
    assert '"--estimator", choices=["reference", "pbrt"], default="pbrt"' in cli
    arrays, _ = scene_specular.load(cfg["scene"])
    assert arrays["faces"].shape[0] == 3852 <= AUTO_BRUTE_MAX_TRIS
    assert cell.traffic["driver"] == "progressive_specular" and cell.entry["chips"] == 1
    entry = [c for c in json.loads((ROOT / "BENCHMARK.json").read_text())["configs"]
             if c["name"] == "spheres"][0]
    assert entry["reduced"] == cfg["reduced"] and entry["file"] == "benchmark/configs/spheres.json"


@pytest.mark.parametrize("name", ["spheres", "cornell"])
def test_scene_loader_matches_the_programs(name):
    """scene_specular.load gives the program's loader's arrays bit for bit:
    on spheres.json (icospheres, metal and glass, their ior and
    roughness), and on the Cornell box, where it is scene.load's."""
    if name == "spheres":
        data = json.loads(SPHERES.read_text())
    else:
        data = json.loads((ROOT / "benchmark" / "configs" / "cornell.json").read_text())["scene"]
    arrays, camera = scene_specular.load(data)
    host, cam, _ = build_scene(data)
    for field in host._fields:
        ours, theirs = arrays[field], np.asarray(getattr(host, field))
        assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs), field
    assert np.array_equal(camera["iview"], cam.iview)
    if name == "cornell":
        base, _ = scene_data.load(data)
        assert all(np.array_equal(base[k], arrays[k]) for k in base)
    else:
        assert set(arrays["mat_type"].tolist()) == {MAT_LAMBERT, 1, MAT_METAL, MAT_DIELECTRIC}
        metal = arrays["mat_type"] == MAT_METAL
        assert np.allclose(arrays["roughness"][metal], 0.05)
        assert np.allclose(arrays["ior"][arrays["mat_type"] == MAT_DIELECTRIC], 1.5)


@pytest.mark.parametrize("seed,sample", [(2**31 + 77, 3), (5, 70), (2**31 + 77, "lanes")])
def test_reference_equals_the_programs_twins(seed, sample):
    """One sample of every pixel, 12 bounces, Russian roulette from 4, the
    8 x 8 strata: the reference's radiance and the program's render_sample
    through its CPU twins ("brute" for the whole-table kernels) agree bit
    for bit, with an int sample id (one stratum for every pixel; 70 is
    past the grid's 64) and per-pixel ids (every stratum); the first hits
    cover lambert, metal and glass faces."""
    cell = _cell()
    arrays, camera, scene, cam, cfg = _program(cell, seed)
    tables = TraceTables(scene, cfg, cell.config["backend"])
    assert tables.backend == "brute"
    px, py = _pixels(RES, RES)
    ids = (torch.arange(RES * RES) * 7 + 1) % 200 if sample == "lanes" else sample
    prog = render_sample(scene, cam, cfg, seed, ids, px, py, tables=tables)
    ref = reference.SpecularReference(arrays, camera, cell.config, "cpu", strata=8)
    lanes = ids if torch.is_tensor(ids) else torch.full_like(px, ids)
    mine = ref.trace(px, py, lanes, seed)
    assert torch.equal(prog, mine)
    assert float(mine.mean()) > 0.05
    ro, rd = generate_rays(cam, px, py, ids, seed, strata=8)
    _, first = ref.tris.closest(ro, rd, ref.t_min, torch.full((px.shape[0],), ref.t_max))
    assert {MAT_LAMBERT, MAT_METAL, MAT_DIELECTRIC} <= set(ref.mat_type[first].tolist())


def test_the_reference_strata_are_the_cameras():
    """The reference's stratified rays are generate_rays' bit for bit over a
    whole grid of samples and past it, and differ from the unstratified."""
    cell = _cell()
    arrays, camera, scene, cam, cfg = _program(cell, 9)
    ref = reference.SpecularReference(arrays, camera, cell.config, "cpu", strata=8)
    px, py = torch.full((130,), 5), torch.full((130,), 11)
    sample = torch.arange(130)
    want = generate_rays(cam, px, py, sample, 9, strata=8)
    got = reference.camera_rays(ref.cam, px, py, sample, 9, torch.float32, 8)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    plain = reference.camera_rays(ref.cam, px, py, sample, 9, torch.float32, 0)
    assert not torch.equal(plain[1], got[1])


def test_the_cells_run_is_correct(run_cell):
    """The harness's whole run of the cell on the CPU, its film judged
    against the specular reference: the same arithmetic, every compared
    number 0."""
    res = run_cell(2**31 + 5, 0.3, False)
    assert res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == {"samples_per_s", "setup_s"}
    assert all(c["value"] == 0.0 for c in res["checks"].values())


def test_traced_run_reads_the_span_metrics(run_cell):
    """A --trace 1 run on the CPU: the spans of the recorded passes reach
    their readers (no device here: no device metric), the recorded
    passes' lane counts reach the tracer's counters, and the film is
    judged correct."""
    res = run_cell(2**31 + 7, 0.2, True)
    assert res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == {"film_ms_per_pass.render", "nee_ms_per_pass.cli",
                                   "scatter_ms_per_pass.cli", "shade_ms_per_pass.cli"}


# the card's readings (benchmark/checks/spheres.pbrt.json) of each fault
# at the cell's size: whether the cell's limits call it correct
FAULTS = {"bfloat16": False, "float64": True, "glass_reflects": False, "strata_off": False}


@pytest.mark.parametrize("variant", sorted(FAULTS))
def test_control_and_faults_are_judged_as_on_the_card(variant):
    """Over one whole grid of strata (64 samples) at 128 pixels: the
    reference in bfloat16 (the control, one precision below the
    configuration's float32) fails the cell's limits and in float64 (every
    rounding moved) passes; glass that never refracts fails, and so does
    the camera without strata (on the card by sq_gap alone: the same mean
    from other samples), as the card reads them at the cell's size."""
    cell = _cell()
    cell.checks["compare_pixels"] = 128
    numbers = cell.driver.control_numbers(cell, 9, "cpu", variant, samples=64)
    assert compare.judge(numbers, cell.checks["limits"])[0] is FAULTS[variant], numbers


def test_checks_hold_the_drivers_numbers():
    cell = _cell()
    assert set(cell.checks["limits"]) == {"spp_gap", "outlier_share", "mean_gap", "sq_gap"}
    assert cell.checks["limits"]["spp_gap"] == 0
    assert isinstance(cell.checks["readings"], str) and cell.checks["compare_pixels"] > 0


# ------------------------------------------------- the lane counters

def _trace_counts(scene, cfg, ro, rd, pixel, sample, tables):
    with profiling.recording("cpu") as rec:
        with profiling.span("pass"):
            radiance, rays = ip.trace_pbrt(scene, cfg, ro, rd, pixel, sample, cfg.seed,
                                           tables=tables, with_stats=True)
    return radiance, rays, rec


def _spheres_wavefront(seed, res=RES, sample=3):
    host, camera, _ = build_scene(json.loads(SPHERES.read_text()))
    scene, cam = to_device(host, camera._replace(resolution=(res, res)), "cpu")
    px, py = _pixels(res, res)
    ro, rd = generate_rays(cam, px, py, sample, seed, strata=8)
    return scene, py * res + px, ro, rd


def test_lane_counts_relate_to_rays_traced(monkeypatch):
    """closest_rays is the lanes live at each bounce's start, the half of
    the rays traced that the closest query took; shadow_rays the NEE
    candidates, at most the other half (the lanes live after each hit),
    with metal and glass vertices and lights behind the surface between
    them. Counted once a trace, charged to the span open then, read when
    the block closes; nothing is counted or summed outside a block."""
    cfg = RenderConfig(max_bounces=12, seed=2**31 + 3, estimator="pbrt", spp=64,
                       stratified=True)
    scene, pixel, ro, rd = _spheres_wavefront(cfg.seed)
    tables = TraceTables(scene, cfg, "brute")
    want = ip.trace_pbrt(scene, cfg, ro, rd, pixel, 3, cfg.seed, tables=tables)
    radiance, rays, rec = _trace_counts(scene, cfg, ro, rd, pixel, 3, tables)
    assert torch.equal(radiance, want)
    closest, shadow = rec.counters["closest_rays"], rec.counters["shadow_rays"]
    assert isinstance(closest, int) and isinstance(shadow, int)
    assert closest >= ro.shape[0] and 0 < shadow
    assert closest + shadow < float(rays)
    assert rec.summary("pass")["closest_rays"] == closest
    assert rec.spans[0].counts == {"closest_rays": closest, "shadow_rays": shadow}
    # the closest half: count the live lanes at each closest query
    live = []
    real = ip._closest

    def spy(scene_, tables_, cfg_, ro_, rd_, t1):
        live.append(int((t1 > 0).sum()))
        return real(scene_, tables_, cfg_, ro_, rd_, t1)

    monkeypatch.setattr(ip, "_closest", spy)
    _trace_counts(scene, cfg, ro, rd, pixel, 3, tables)
    assert sum(live) == closest


def test_lane_counts_on_the_kernels_path(monkeypatch):
    """On the kernels' path (each launch emulated on the CPU) pbrt_hit's
    two counts equal the eager loop's, and the wavefront's three counts
    share one tensor (one fill a trace, as before)."""
    from tests.test_torch_pbrt_kernel import _to_the_kernels

    cfg = RenderConfig(max_bounces=8, seed=11, estimator="pbrt", spp=64, stratified=True)
    scene, pixel, ro, rd = _spheres_wavefront(cfg.seed, sample=70)
    tables = TraceTables(scene, cfg, "brute")
    _, rays, eager = _trace_counts(scene, cfg, ro, rd, pixel, 70, tables)
    calls = []
    _to_the_kernels(monkeypatch, calls)
    radiance, rays_k, rec = _trace_counts(scene, cfg, ro, rd, pixel, 70, tables)
    assert calls and torch.equal(rays_k, rays)
    assert {k: rec.counters[k] for k in ("closest_rays", "shadow_rays")} == {
        k: eager.counters[k] for k in ("closest_rays", "shadow_rays")}
    wf = pk.Wavefront.start(ro, rd, pixel, 3, cfg.t_max)
    assert wf.closest_rays.untyped_storage().data_ptr() == wf.n_rays.untyped_storage().data_ptr()
    assert float(wf.closest_rays) == float(wf.shadow_rays) == float(wf.n_rays) == 0.0
    # the emulated launches counted in the wrappers: leave no count to a
    # later test of this process
    pk.reset_counters()


def test_tensor_counts_are_read_once_the_block_closes(monkeypatch):
    """count() keeps a tensor as it is: nothing is read inside the block
    (no value, and no copy to the host, which on the card would be a wait);
    the block's close reads every tensor count in one copy a device and
    adds them to the counters and to the spans they were charged to;
    last_recording() is that block's recorder. Outside a block a count
    keeps nothing."""
    reads = []
    real = torch.Tensor.cpu

    def cpu(self, *a, **k):
        reads.append(tuple(self.shape))
        return real(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", cpu)
    profiling.count("closest_rays", torch.tensor(5.0))
    with profiling.recording("cpu") as rec:
        with profiling.span("pass") as s:
            profiling.count("closest_rays", torch.tensor(3.0))
            profiling.count("closest_rays", torch.tensor(4.0))
            profiling.count("shadow_rays", torch.tensor(2.5))
            profiling.count("pbrt_kernel")
        assert "closest_rays" not in rec.counters and not reads
        assert profiling.counting()
    assert not profiling.counting()
    assert reads == [(3,)]
    assert rec.counters == {"closest_rays": 7, "shadow_rays": 2.5, "pbrt_kernel": 1}
    assert s.counts == rec.counters and profiling.last_recording() is rec


def _ctx(n_tris=3852, units=2, counters=None, closest_s=2e-3, anyhit_s=1e-3, launches=4):
    """A trace context of `units` profiled passes with `launches` launches
    of each whole-table kernel, of the given total device seconds."""
    events = []
    for k in range(launches):
        events.append(harness.Event("void (anonymous namespace)::closest_kernel<8>(float)",
                                    k, k + closest_s / launches, True))
        events.append(harness.Event("void (anonymous namespace)::anyhit_kernel<16>(float)",
                                    k + 0.5, k + 0.5 + anyhit_s / launches, True))
    counters = dict({"n_tris": n_tris}, **(counters or {}))
    return harness.TraceContext(units, 1.0, events, {}, counters,
                                {"intersect": {"closest_kernel", "anyhit_kernel"}})


def _reader(name):
    return harness.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py", "test_" + name)


def test_roofline_readers_on_a_synthetic_trace(monkeypatch):
    """Each reader: the least time of its kernel's work (the counted lanes
    a pass times the profiled passes, each against every triangle at
    MT_OPS; a ray read and a hit written a lane, the table once a launch)
    over its kernel's device time, in percent; none without its kernel,
    its count or the triangle count. A context without the counts falls
    back to the program's last recording, and a program without one reads
    nothing."""
    from benchmark.metrics import _peaks

    closest, anyhit = _reader("closest_hit_roofline.pbrt"), _reader("any_hit_roofline.pbrt")
    ctx = _ctx(counters={"closest_rays": 1e5, "shadow_rays": 4e4})
    ops = 2e5 * 3852 * _peaks.MT_OPS
    assert closest.read(ctx) == pytest.approx(100 * ops / _peaks.PEAK_FP32 / 2e-3)
    ops = 8e4 * 3852 * _peaks.MT_OPS
    assert anyhit.read(ctx) == pytest.approx(100 * ops / _peaks.PEAK_FP32 / 1e-3)
    # bytes bound at few triangles
    small = _ctx(n_tris=2, counters={"closest_rays": 1e5, "shadow_rays": 4e4})
    nbytes = 2e5 * _peaks.RAY_BYTES + 4 * 2 * 36
    assert closest.read(small) == pytest.approx(100 * nbytes / _peaks.PEAK_BYTES / 2e-3)
    assert closest.read(_ctx(counters={"closest_rays": 1e5}, launches=0)) is None
    assert closest.read(_ctx(n_tris=None, counters={"closest_rays": 1e5})) is None
    monkeypatch.setattr(profiling, "_last", None)
    assert closest.read(_ctx()) is None and anyhit.read(_ctx()) is None
    with profiling.recording("cpu"):
        with profiling.span("pass"):
            profiling.count("closest_rays", torch.tensor(1e5))
    assert closest.read(_ctx()) == pytest.approx(closest.read(ctx))
    assert anyhit.read(_ctx()) is None
    monkeypatch.delattr(profiling, "last_recording")
    assert _lanes.lanes_per_pass(_ctx(), "closest_rays") is None


def _render_pass(cell, seed):
    arrays, camera, scene, cam, cfg = _program(cell, seed)
    r = ProgressiveRenderer(scene, cam, cfg, backend=cell.config["backend"], chunk=64)
    with profiling.recording("cpu") as rec:
        r.render_one_pass()
    return rec


def test_a_pass_counts_both_queries_lanes():
    """A recorded pass of the cell's renderer: its four chunk traces count
    both counters under their `chunk` spans, and the pass's summary holds
    their sums."""
    rec = _render_pass(_cell(), 2**31 + 9)
    summary = rec.summary("pass")
    chunks = [s for s in rec.spans if s.name == "chunk"]
    assert len(chunks) == RES * RES // 64
    for name in ("closest_rays", "shadow_rays"):
        assert summary[name] == sum(s.counts[name] for s in chunks) > 0


# ---------------------------------------------------------- on the card

@pytest.mark.cuda
@pytest.mark.parametrize("seed", [1, 2**31 + 5])
def test_hit_kernel_counts_equal_the_eager_loops_on_gpu(seed, monkeypatch):
    """On the card, spheres.json at 2^16 lanes (256 x 256, stratified, 12
    bounces): a trace on the kernels' path records both counts with no
    host wait (the block's one read comes after it); and one bounce of the
    kernels from the eager loop's state at bounces 0, 1, 4, 5 and 8 counts
    exactly the eager loop's live lanes as closest_rays and exactly its own
    candidates (the shadow rays it opened) as shadow_rays, which are the
    eager loop's candidates but on at most 1e-3 of the lanes (the bounce
    kernels part from the eager bounce in the last ulp on a few lanes)."""
    from tests.test_torch_pbrt_kernel import _eager_states, _fused_bounce

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    host, camera, _ = build_scene(json.loads(SPHERES.read_text()))
    scene, cam = to_device(host, camera._replace(resolution=(256, 256)), dev)
    cfg = RenderConfig(max_bounces=12, seed=seed, estimator="pbrt", spp=64, stratified=True)
    px, py = (x.to(dev) for x in _pixels(256, 256))
    pixel = py * 256 + px
    ro, rd = generate_rays(cam, px, py, 5, seed, strata=8)
    tables = TraceTables(scene, cfg, "auto")
    pk.reset_counters()
    with profiling.recording(dev) as rec:
        with profiling.span("pass"):
            ip.trace_pbrt(scene, cfg, ro, rd, pixel, 5, seed, tables=tables)
    assert pk.hit.launches == cfg.max_bounces and rec.counters["syncs"] == 0
    assert rec.counters["closest_rays"] >= 256 * 256 and rec.counters["shadow_rays"] > 0
    states, shadows = _eager_states(monkeypatch, scene, cfg, ro, rd, pixel, 5, tables)
    for b in (0, 1, 4, 5, 8):
        wf, shadow = _fused_bounce(scene, cfg, tables, states[b], pixel, 5, b)
        eager_cand = int((shadows[b]["s_t1"] > 0).sum())
        print(seed, b, float(wf.closest_rays), float(wf.shadow_rays), eager_cand)
        assert float(wf.closest_rays) == int(states[b]["alive"].sum())
        assert float(wf.shadow_rays) == int((shadow["s_t1"] > 0).sum())
        assert abs(float(wf.shadow_rays) - eager_cand) <= 1e-3 * 256 * 256
    pk.reset_counters()
