"""The benchmark cell terrain100k.binned on the CPU: the configuration
against terrain100k's, the program through ProgressiveRenderer with
backend "cluster_binned" (the binned kernels' CPU twins) against the plain
reference (benchmark/reference/render.py) on a terrain of res 64 (8,204
triangles, 17 bins) at 16 x 16, with the cell's settings otherwise, also
with every query overflowing into the residual sweep (W = 1); the films
with and without recording(); the binned queries' spans and counters
(binned_rays, binned_pairs, overflow_rays); the cell's run and its
comparison (the program passes, the bfloat16 control and the planted
faults as the card reads them); and the readers of
prepass_roofline.binned, leaf_roofline.binned, overflow_share.binned and
binned_glue_ms_per_pass.binned. On the card (marked `cuda`): the three
counters of a bounce-1 wavefront's queries against the twins'."""

from __future__ import annotations

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import compare, harness
from benchmark.metrics import _binned, _peaks
from benchmark.reference import render as reference
from benchmark.reference import scene as scene_data
from pyrenderer_tpu_torch.config import RenderConfig
from pyrenderer_tpu_torch.core.camera import generate_rays
from pyrenderer_tpu_torch.kernels import binned as kb
from pyrenderer_tpu_torch.kernels import cluster as kc
from pyrenderer_tpu_torch.render import cli
from pyrenderer_tpu_torch.render.driver import ProgressiveRenderer
from pyrenderer_tpu_torch.scene.types import Camera, Scene, to_device
from pyrenderer_tpu_torch.utils import profiling

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CELL = "terrain100k.binned"
RES = 16
TERRAIN_RES = 64
SPANS = {"bin_prepass", "bin_sort", "bin_leaf", "bin_overflow"}
COUNTERS = ("binned_rays", "binned_pairs", "overflow_rays")


def _cell(res=RES, terrain_res=TERRAIN_RES):
    """The cell with its film cut to res x res and its terrain to
    terrain_res (2 terrain_res^2 triangles)."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.load_cell(CELL, copy.deepcopy(bench))
    cell.config["resolution"] = [res, res]
    for prim in cell.config["scene"]["primitives"]:
        if "procgen" in prim:
            prim["procgen"]["res"] = terrain_res
    return cell


def _renderer(cell, seed, chunk=64):
    arrays, camera = scene_data.load(cell.config["scene"])
    camera["resolution"] = tuple(cell.config["resolution"])
    scene, cam = to_device(Scene(**arrays), Camera(**camera), "cpu")
    cfg = RenderConfig(max_bounces=cell.config["max_bounces"], spp_step=1, seed=seed,
                       estimator=cell.config["estimator"], **cell.config["render"])
    r = ProgressiveRenderer(scene, cam, cfg, backend=cell.config["backend"], chunk=chunk)
    return arrays, camera, r


def _reference_sums(cell, arrays, camera, n, seed):
    """The reference's sums of samples 0 .. n - 1 at every pixel, in the
    film's (row from the top, column) order."""
    w, h = camera["resolution"]
    ys, xs = np.mgrid[0:h, 0:w]
    px, py = torch.as_tensor(xs.reshape(-1)), torch.as_tensor(h - 1 - ys.reshape(-1))
    ref = reference.Reference(arrays, camera, cell.config, "cpu")
    s, q = ref.pixel_sums(px, py, n, seed)
    return s.reshape(h, w, 3), q.reshape(h, w, 3)


@pytest.fixture
def run_cell(monkeypatch):
    """harness.run_cell on the CPU with the cell cut (16 x 16, terrain res
    64, 64 compared pixels, one profiled pass; the test process holds jax
    for the JAX package's tests, so the harness's check for it is left
    out here)."""
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])

    def run(seed, seconds, trace):
        cell = _cell()
        cell.checks["compare_pixels"] = 64
        cell.traffic["profile_passes"] = 1
        monkeypatch.setattr(harness, "load_cell", lambda *a, **k: cell)
        return harness.run_cell(CELL, seed, seconds, trace, device="cpu")

    return run


def test_configuration_is_terrain100k_with_the_binned_backend():
    """The cell's configuration is terrain100k's (scene, resolution,
    bounces, estimator, triangle test, render settings) with the backend
    alone changed, to the documented "cluster_binned"; nothing is cut, and
    the backend, W and BIN are stated under `assumed`."""
    base = json.loads((ROOT / "benchmark" / "configs" / "terrain100k.json").read_text())
    cell = harness.load_cell(CELL)
    cfg = cell.config
    changed = {k for k in set(base) | set(cfg) if base.get(k) != cfg.get(k)}
    assert changed == {"backend", "source", "assumed"}
    assert base["backend"] == "auto" and cfg["backend"] == "cluster_binned"
    assert cfg["reduced"] == [] and cfg["resolution"] == [512, 512] and cfg["max_bounces"] == 4
    assert {"backend", "binned_w", "bin"} <= set(cfg["assumed"])
    assert kb._W_DEFAULT == _binned.W == 6 and kb.BIN == _binned.BIN == 4
    assert kb.LANE_TRIS == _binned.LANE_TRIS
    arrays, _ = scene_data.load(cfg["scene"])
    assert arrays["faces"].shape[0] == 100364
    assert cell.traffic["driver"] == "progressive_binned" and cell.entry["chips"] == 1
    assert cell.traffic["recorded_passes"] == cell.traffic["profile_passes"] == 3
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = [c for c in bench["configs"] if c["name"] == "terrain100k_binned"][0]
    assert entry["reduced"] == [] and entry["file"] == "benchmark/configs/terrain100k_binned.json"
    args = cli.build_parser().parse_args(["scene.json", "--backend", cfg["backend"]])
    assert args.backend == "cluster_binned"


@pytest.mark.parametrize("w", [kb._W_DEFAULT, 1])
def test_program_equals_the_reference(w, monkeypatch):
    """Two 1-spp passes through ProgressiveRenderer with "cluster_binned"
    (the binned twins, watertight leaves) give the reference's sums and
    sums of squares at every pixel bit for bit; the residual sweep
    finishes some rays at W = 6, and at W = 1 every ray that crosses two
    bins."""
    monkeypatch.setattr(kb, "W_SLOTS", w)
    cell = _cell()
    arrays, camera, r = _renderer(cell, 2**31 + 13)
    assert r.backend == "cluster_binned" and r.tables.cluster_watertight
    assert arrays["faces"].shape[0] == 8204
    kb.reset_counters()
    with profiling.recording("cpu") as rec:
        for _ in range(2):
            r.render_one_pass()
    assert kb.prepass.twin_calls == kb.leaf.twin_calls > 0
    assert rec.counters["overflow_rays"] > (1000 if w == 1 else 0)
    s, q = _reference_sums(cell, arrays, camera, 2, 2**31 + 13)
    assert np.array_equal(r.film.radiance_sum, s) and np.array_equal(r.film.sq_sum, q)
    assert float(s.mean()) > 0.01
    kb.reset_counters()


def test_films_are_the_same_with_and_without_recording():
    cell = _cell()
    films = []
    for record in (False, True):
        _, _, r = _renderer(cell, 77)
        if record:
            with profiling.recording("cpu"):
                r.render_one_pass()
        else:
            r.render_one_pass()
        films.append((r.film.radiance_sum.copy(), r.film.sq_sum.copy()))
    assert all(np.array_equal(a, b) for a, b in zip(*films))


@pytest.mark.parametrize("w", [kb._W_DEFAULT, 1])
def test_counters_and_spans_of_a_pass(w, monkeypatch):
    """A recorded pass: every query reads the device once (one `_count` a
    query, inside its bin_prepass span, which holds the three counts);
    binned_rays is the live rays of the queries (t1 >= t0), binned_pairs
    at most W of them, overflow_rays at most binned_rays and more than 0
    at W = 1; the four spans sit inside the queries, bin_overflow only
    where some ray overflowed."""
    monkeypatch.setattr(kb, "W_SLOTS", w)
    reads, live = [], []
    real_count, real_prepass = kb._count, kb.prepass

    def spy_count(*a, **k):
        out = real_count(*a, **k)
        reads.append(out)
        return out

    def spy_prepass(cs, rays, t0, w_, *a, **k):
        live.append(int((rays[:, 6] >= t0).sum()))
        return real_prepass(cs, rays, t0, w_, *a, **k)

    # the wrapper counts its calls on the module's `prepass`: here the spy
    spy_prepass.launches = spy_prepass.twin_calls = 0
    monkeypatch.setattr(kb, "_count", spy_count)
    monkeypatch.setattr(kb, "prepass", spy_prepass)
    _, _, r = _renderer(_cell(), 2**31 + 21)
    with profiling.recording("cpu") as rec:
        r.render_one_pass()
    c = rec.counters
    queries = [s for s in rec.spans if s.name == "query"]
    prepass_spans = [s for s in rec.spans if s.name == "bin_prepass"]
    assert len(reads) == len(queries) == len(prepass_spans) == 4 * 4 * 2
    assert all(rec.spans[s.parent].name == "query" for s in rec.spans if s.name in SPANS)
    assert {s.name for s in rec.spans} >= SPANS - {"bin_overflow"}
    assert (c["overflow_rays"] > 0) == any(s.name == "bin_overflow" for s in rec.spans)
    assert all(isinstance(c[k], int) for k in COUNTERS)
    assert c["binned_rays"] == sum(live) and c["binned_pairs"] == sum(p for _, p, _ in reads)
    assert c["overflow_rays"] == sum(o for o, _, _ in reads)
    assert 0 < c["binned_pairs"] <= w * c["binned_rays"]
    assert c["overflow_rays"] <= c["binned_rays"]
    if w == 1:
        assert c["overflow_rays"] > 0
    assert all(set(s.counts) == set(COUNTERS) for s in prepass_spans)
    summary = rec.summary("pass")
    assert all(summary[k] == c[k] for k in COUNTERS)


def test_the_streamed_path_counts_its_rounds(monkeypatch):
    """"cluster_streamed" counts the live rays once a query and the pairs of
    every round, its peels inside bin_prepass spans, and no overflow."""
    monkeypatch.setattr(kb, "W_SLOTS", 1)
    cell = _cell()
    cell.config["backend"] = "cluster_streamed"
    _, _, r = _renderer(cell, 5)
    kb.reset_counters()
    with profiling.recording("cpu") as rec:
        r.render_one_pass()
    c = rec.counters
    n_prepass = sum(s.name == "bin_prepass" for s in rec.spans)
    assert n_prepass == kb.prepass.twin_calls + kb.peel.twin_calls > kb.prepass.twin_calls
    assert "overflow_rays" not in c and c["binned_pairs"] > c["binned_rays"] > 0
    kb.reset_counters()


def test_the_cells_run_is_correct(run_cell):
    """The harness's whole run of the cell on the CPU, its film judged
    against the reference: the same arithmetic, every compared number
    0."""
    res = run_cell(2**31 + 5, 0.3, False)
    assert res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == {"samples_per_s", "setup_s"}
    assert all(c["value"] == 0.0 for c in res["checks"].values())


def test_traced_run_reads_the_span_and_counter_metrics(run_cell):
    """A --trace 1 run on the CPU: the recorded passes' spans and counters
    reach their readers (no device here: no device metric, no sync
    count), and the film is judged correct."""
    res = run_cell(2**31 + 7, 0.2, True)
    assert res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == {"film_ms_per_pass.render", "overflow_share.binned",
                                   "binned_glue_ms_per_pass.binned"}
    assert 0 <= res["metrics"]["overflow_share.binned"]["value"] <= 1
    assert res["metrics"]["binned_glue_ms_per_pass.binned"]["value"] > 0


# the card's readings (benchmark/checks/terrain100k.binned.json) of each
# variant at the cell's size: whether the cell's limits call it correct
# (float64's from terrain100k.render, the same scene and reference)
FAULTS = {"bfloat16": False, "float64": True, "moeller_trumbore": True, "first_blocks": False}


@pytest.mark.parametrize("variant", sorted(FAULTS))
def test_control_and_faults_are_judged_as_on_the_card(variant):
    """At 128 pixels of 16 samples: the reference in bfloat16 (the control,
    one precision below the configuration's float32) fails the cell's
    limits and in float64 (every rounding moved) passes; the planted
    faults read as the card reads them at the cell's size."""
    cell = _cell()
    cell.checks["compare_pixels"] = 128
    numbers = cell.driver.control_numbers(cell, 9, "cpu", variant, samples=16)
    assert compare.judge(numbers, cell.checks["limits"])[0] is FAULTS[variant], numbers


def test_unknown_variant_is_refused():
    with pytest.raises(ValueError):
        _cell().driver.control_numbers(_cell(), 9, "cpu", "nonsense", samples=2)


def test_checks_hold_terrain100ks_limits():
    cell = _cell()
    base = json.loads((ROOT / "benchmark" / "checks" / "terrain100k.render.json").read_text())
    assert cell.checks["limits"] == base["limits"]
    assert cell.checks["compare_pixels"] == base["compare_pixels"] == 8192
    assert "PERF.md" in cell.checks["readings"]


# ------------------------------------------------------- the readers

def _reader(name):
    return harness.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py",
                               "test_" + name.replace(".", "_"))


def _ctx(counters=None, units=3, prepass_s=3e-4, leaf_s=2e-3, launches=32, spans=None):
    """A trace context of `units` profiled passes with `launches` launches
    of the prepass and of the leaf, of the given total device seconds."""
    events = []
    for k in range(launches):
        events.append(harness.Event("void (anonymous namespace)::binned_prepass_kernel(float)",
                                    k, k + prepass_s / launches, True))
        events.append(harness.Event("void (anonymous namespace)::binned_leaf_kernel<4>(float)",
                                    k + 0.5, k + 0.5 + leaf_s / launches, True))
    counters = dict({"n_tris": 100364}, **(counters or {}))
    if spans is not None:
        counters["spans"] = spans
    return harness.TraceContext(units, 1.0, events, {}, counters,
                                {"binned": {"binned_prepass_kernel", "binned_leaf_kernel"}})


def test_real_bins_are_the_cluster_scenes():
    """_binned.bins(triangles) is the number of bins with a real box in the
    program's ClusterScene (terrain res 64: 8,204 triangles, 65 clusters,
    17 bins)."""
    from pyrenderer_tpu_torch.accel.clusters import build_clusters

    arrays, _ = scene_data.load(_cell().config["scene"])
    cs = build_clusters(arrays["vertices"], arrays["faces"])
    real = int(torch.isfinite(cs.bin_box8[:, 0:6]).all(dim=1).sum())
    assert _binned.bins(arrays["faces"].shape[0]) == real == 17
    assert _binned.bins(100364) == 197


def test_roofline_readers_on_a_synthetic_trace():
    """Each roofline: the least time of its kernel's work (the counted rays
    or pairs a pass times the profiled passes; the prepass's slab tests
    against the real bins at SLAB_OPS, the leaf's BIN x 128 watertight
    tests at WT_OPS; bytes as _binned counts them) over the kernel's device
    time, in percent; none without the kernel, the count or the triangle
    count."""
    prepass, leaf = _reader("prepass_roofline.binned"), _reader("leaf_roofline.binned")
    ctx = _ctx({"binned_rays": 1.5e5, "binned_pairs": 3e5})
    ops = 4.5e5 * 197 * 26
    assert prepass.read(ctx) == pytest.approx(100 * ops / _peaks.PEAK_FP32 / 3e-4)
    ops = 9e5 * 4 * 128 * 75
    assert leaf.read(ctx) == pytest.approx(100 * ops / _peaks.PEAK_FP32 / 2e-3)
    # the bytes bound where the work is small against the launches
    few = _ctx({"binned_rays": 10, "binned_pairs": 10}, launches=1000)
    nbytes = 30 * (32 + 6 * 4 + 1) + 1000 * 197 * 32
    assert prepass.read(few) == pytest.approx(100 * nbytes / _peaks.PEAK_BYTES / 3e-4)
    nbytes = 30 * 52 + 1000 * 197 * 4 * 128 * 36
    assert leaf.read(few) == pytest.approx(100 * nbytes / _peaks.PEAK_BYTES / 2e-3)
    assert prepass.read(_ctx()) is None and leaf.read(_ctx()) is None
    assert prepass.read(_ctx({"binned_rays": 1.5e5}, launches=0)) is None
    no_tris = _ctx({"binned_rays": 1.5e5, "binned_pairs": 3e5})
    no_tris.counters.pop("n_tris")
    assert prepass.read(no_tris) is None and leaf.read(no_tris) is None


def test_overflow_share_reader():
    share = _reader("overflow_share.binned")
    assert share.read(_ctx({"binned_rays": 2e5, "overflow_rays": 5e3})) == pytest.approx(0.025)
    assert share.read(_ctx({"binned_rays": 2e5, "overflow_rays": 0})) == 0.0
    assert share.read(_ctx({"binned_rays": 2e5})) is None and share.read(_ctx()) is None


def test_binned_glue_reader_takes_the_spans_self_time():
    """The four spans' time a pass less their launch children, over the
    recorded passes: here two passes, each a query holding a bin_prepass of
    10 ns with a 4 ns launch and a bin_leaf of 6 ns with a 1 ns launch, and
    a bin_overflow of 3 ns in the first."""
    glue = _reader("binned_glue_ms_per_pass.binned")
    spans = []

    def add(name, start, end, parent, unit):
        spans.append((name, start, end, parent, unit, 0))
        return len(spans) - 1

    for p, base in enumerate((0, 1000)):
        top = add("pass", base, base + 100, None, None)
        spans[top] = spans[top][:4] + (top, 0)
        q = add("query", base + 1, base + 50, top, top)
        b = add("bin_prepass", base + 2, base + 12, q, top)
        add("launch", base + 3, base + 7, b, top)
        b = add("bin_leaf", base + 20, base + 26, q, top)
        add("launch", base + 21, base + 22, b, top)
        if p == 0:
            add("bin_overflow", base + 30, base + 33, q, top)
    assert glue.read(_ctx(spans=spans)) == pytest.approx((6 + 5 + 3 + 6 + 5) / 2 / 1e6)
    assert glue.read(_ctx(spans=[s for s in spans if not s[0].startswith("bin_")])) is None
    assert glue.read(_ctx()) is None


# ---------------------------------------------------------- on the card

@pytest.mark.cuda
def test_counters_of_a_bounce1_wavefront_equal_the_twins_on_gpu():
    """On the card, terrain100k at 256 x 256: the binned closest and
    any-hit queries of a bounce-1 wavefront (the camera rays' hits sent on
    in cosine-ish directions, the missed rays dead) count on the kernels
    exactly the twins' binned_rays, binned_pairs and overflow_rays, with
    one host wait a query."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pyrenderer_tpu_torch.accel.clusters import build_clusters

    dev = torch.device("cuda")
    cfg_file = harness.load_cell(CELL).config
    arrays, camera = scene_data.load(cfg_file["scene"])
    camera["resolution"] = (256, 256)
    scene, cam = to_device(Scene(**arrays), Camera(**camera), dev)
    cs = build_clusters(arrays["vertices"], arrays["faces"])
    ys, xs = torch.meshgrid(torch.arange(256), torch.arange(256), indexing="ij")
    px, py = xs.reshape(-1).to(dev), ys.reshape(-1).to(dev)
    ro, rd = generate_rays(cam, px, py, 0, 2**31 + 3)
    t_min, t_max = cfg_file["render"]["t_min"], cfg_file["render"]["t_max"]
    hit, t, _ = kc.closest_hit(cs.to(dev), ro, rd, t_min, t_max, sort=False,
                               watertight=True)
    gen = torch.Generator(device="cpu").manual_seed(3)
    wi = torch.nn.functional.normalize(torch.randn(ro.shape, generator=gen), dim=1).to(dev)
    ro = ro + t[:, None] * rd
    rd = torch.nn.functional.normalize(wi + torch.tensor([0.0, 1.0, 0.0], device=dev), dim=1)
    t1 = torch.where(hit, torch.full_like(t, t_max), 0.0)
    counts = {}
    for where, c in (("card", cs.to(dev)), ("twins", cs)):
        args = [x.to(c.tri.device) for x in (ro, rd, t1)]
        with profiling.recording(c.tri.device) as rec:
            with profiling.span("pass"):
                kb.closest_hit(c, *args[:2], t_min, args[2], watertight=True)
                kb.occluded(c, *args[:2], t_min, 0.5 * args[2], watertight=True)
        counts[where] = {k: rec.counters[k] for k in COUNTERS}
        if where == "card":
            assert rec.counters["syncs"] == 2
    print(counts)
    assert counts["card"] == counts["twins"]
    assert 0 < counts["card"]["binned_pairs"] <= kb._W_DEFAULT * counts["card"]["binned_rays"]
    assert counts["card"]["overflow_rays"] <= counts["card"]["binned_rays"]
    kb.reset_counters()
