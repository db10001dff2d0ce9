"""The program's spans and its sync counter (utils/profiling.py span,
recording, Recorder) on the CPU: the no-op while nothing records, the
spans a pass and a training step record at the layer boundaries, results
bit for bit the same with recording on and off, self time and the per-unit
summary under an injected clock, the spans on torch.profiler's clock,
the sync counter's bookkeeping, and the CLI's --trace-dir."""

import collections
import glob
import json
import threading
import warnings

import pytest
import torch

from pyrenderer_tpu_torch.dist import render as dist_render
from pyrenderer_tpu_torch.render import cli
from pyrenderer_tpu_torch.render.driver import ProgressiveRenderer
from pyrenderer_tpu_torch.scene import load_tungsten, to_device
from pyrenderer_tpu_torch.utils import profiling as prof

torch.set_num_threads(2)

BOUNCES = 4
# 16x16 pixels in chunks of 64: four chunks a pass
RES, CHUNK = (16, 16), 64
N_CHUNKS = RES[0] * RES[1] // CHUNK
# Threefry evaluations a trace with the box's one light: two in the camera;
# a bounce's BSDF pair, light face and light point (reference), and the
# third BSDF draw (pbrt; Russian roulette only from bounce 4 on)
RNG_A_TRACE = {"reference": 2 + 3 * BOUNCES, "pbrt": 2 + 4 * BOUNCES}


@pytest.fixture(scope="module")
def cornell(cornell_path):
    host, camera, cfg = load_tungsten(cornell_path)
    scene, cam = to_device(host, camera, "cpu", torch.float32)
    return scene, cam, cfg.replace(max_bounces=BOUNCES, spp=4, spp_step=1, seed=3,
                                   resolution=RES)


def _renderer(cornell, estimator):
    scene, cam, cfg = cornell
    return ProgressiveRenderer(scene, cam, cfg.replace(estimator=estimator), chunk=CHUNK)


class _Clock:
    """perf_counter_ns that moves only when told."""

    def __init__(self):
        self.now = 0

    def __call__(self):
        return self.now


def test_span_off_is_the_shared_noop():
    """Outside recording() span() hands out NO_SPAN and nothing records."""
    assert prof._recorder is None
    a, b = prof.span("pass"), prof.span("bounce")
    assert a is prof.NO_SPAN and b is prof.NO_SPAN
    with a as inside:
        with prof.span("rng"):
            pass
    assert inside is prof.NO_SPAN
    with prof.recording("cpu") as rec:
        pass
    assert rec.spans == [] and rec.counters == {}
    assert rec.summary("pass") is None
    assert prof.span("pass") is prof.NO_SPAN


def test_recording_does_not_nest():
    with prof.recording("cpu"):
        with pytest.raises(RuntimeError):
            with prof.recording("cpu"):
                pass
    assert prof._recorder is None


@pytest.mark.parametrize("estimator", ["reference", "pbrt"])
def test_pass_spans(cornell, estimator):
    """One pass records one `pass`; four `chunk`s under it, each with one
    `camera` and four `bounce`s; the Threefry evaluations under `camera`
    and `bounce`; two `query`s a bounce; `readback` and `film` under the
    pass. In the pbrt bounce, `nee` holds the light sample's draws and the
    shadow query, `scatter` the BSDF draws. Every span belongs to the
    pass's unit. On the CPU the whole-table twins run, so no `launch`, and
    no sync is counted."""
    r = _renderer(cornell, estimator)
    assert r.backend == "brute"
    with prof.recording("cpu") as rec:
        r.render_one_pass()
    names = collections.Counter(s.name for s in rec.spans)
    n_rng = N_CHUNKS * RNG_A_TRACE[estimator]
    n_bounce = N_CHUNKS * BOUNCES
    pbrt = {"nee": n_bounce, "scatter": n_bounce} if estimator == "pbrt" else {}
    assert names == {"pass": 1, "chunk": N_CHUNKS, "camera": N_CHUNKS,
                     "bounce": n_bounce, "rng": n_rng,
                     "query": n_bounce * 2, "readback": 1, "film": 1, **pbrt}
    parent = collections.Counter(
        (s.name, None if s.parent is None else rec.spans[s.parent].name) for s in rec.spans)
    in_bounce = {("rng", "bounce"): n_rng - 2 * N_CHUNKS, ("query", "bounce"): n_bounce * 2}
    if pbrt:
        # light face and light point under `nee`, the BSDF pair and the
        # third BSDF draw under `scatter` (no roulette before bounce 4)
        in_bounce = {("nee", "bounce"): n_bounce, ("scatter", "bounce"): n_bounce,
                     ("rng", "nee"): 2 * n_bounce, ("rng", "scatter"): 2 * n_bounce,
                     ("query", "bounce"): n_bounce, ("query", "nee"): n_bounce}
    assert parent == {
        ("pass", None): 1, ("chunk", "pass"): N_CHUNKS, ("readback", "pass"): 1,
        ("film", "pass"): 1, ("camera", "chunk"): N_CHUNKS,
        ("bounce", "chunk"): n_bounce, ("rng", "camera"): 2 * N_CHUNKS, **in_bounce}
    root = rec.spans[0]
    assert root.name == "pass" and root.index == root.unit == 0
    assert all(s.unit == 0 and s.end_ns >= s.start_ns for s in rec.spans)
    assert all(rec.spans[s.parent].start_ns <= s.start_ns <= s.end_ns
               <= rec.spans[s.parent].end_ns for s in rec.spans if s.parent is not None)
    summary = rec.summary("pass")
    # the pbrt trace counts the lanes its two queries test (on the CPU too)
    counted = {"closest_rays", "shadow_rays"} if pbrt else set()
    assert set(rec.counters) == counted and "syncs" not in summary
    assert all(rec.counters[k] > 0 and summary[k] == rec.counters[k] for k in counted)
    # the CPU's Threefry is the twin's and its bounce the eager one: no
    # evaluation or bounce went to a kernel
    assert summary["rng_kernel"] == summary["pbrt_kernel"] == summary["reference_kernel"] == 0.0
    assert summary["units"] == 1
    assert {k: v["count"] for k, v in summary["spans"].items()} == names
    # the children cover the pass but for its own Python
    assert 0 <= summary["spans"]["pass"]["self_ms"] < summary["spans"]["pass"]["ms"]


@pytest.mark.parametrize("estimator", ["reference", "pbrt"])
def test_film_bit_identical_with_recording(cornell, estimator):
    plain, traced = _renderer(cornell, estimator), _renderer(cornell, estimator)
    for _ in range(2):
        plain.render_one_pass()
        with prof.recording("cpu"):
            traced.render_one_pass()
    assert plain.film.spp == traced.film.spp == 2
    assert (plain.film.radiance_sum == traced.film.radiance_sum).all()
    assert (plain.film.sq_sum == traced.film.sq_sum).all()
    assert plain.rays_traced == traced.rays_traced


def test_adaptive_sweep_is_a_pass(cornell):
    """refine_adaptive's sweep records as a pass: its chunks, their
    readback and the film update under it."""
    scene, cam, cfg = cornell
    cfg = cfg.replace(estimator="reference", adaptive=True, adaptive_min_spp=2,
                      adaptive_tolerance=0.0, spp=3)
    r = ProgressiveRenderer(scene, cam, cfg, chunk=CHUNK)
    for _ in range(2):
        r.render_one_pass()
    with prof.recording("cpu") as rec:
        refined = r.refine_adaptive(quiet=True)
    chunks = -(-refined // CHUNK)
    assert chunks > 1
    names = collections.Counter(s.name for s in rec.spans)
    assert names["pass"] == 1 and rec.spans[0].name == "pass"
    assert names["chunk"] == names["readback"] == names["film"] == chunks
    assert names["bounce"] == chunks * BOUNCES


def test_train_step_spans_and_bits(cornell, monkeypatch):
    """One `step`; a `forward` and a `backward` under it per chunk of
    pixels; one `sgd`. The new parameters equal the unrecorded step's bit
    for bit."""
    scene, cam, cfg = cornell
    cfg = cfg.replace(estimator="reference", spp=1)
    cam = cam._replace(resolution=RES)
    px, py = dist_render.pixel_grid(cam)
    with torch.no_grad():
        target = dist_render.render_field(scene, cam, cfg, px, py)
    albedo = scene.albedo.clone()
    albedo[0] = 0.5
    params = (scene.vertices, albedo, scene.emission)
    lr = (1e-3, 1.0, 1.0)
    monkeypatch.setattr(dist_render, "CHUNK", CHUNK)
    loss0, new0 = dist_render.train_step(params, scene, cam, cfg, target, px, py, lr)
    with prof.recording("cpu") as rec:
        loss1, new1 = dist_render.train_step(params, scene, cam, cfg, target, px, py, lr)
    assert torch.equal(loss0, loss1)
    assert all(torch.equal(a, b) for a, b in zip(new0, new1))
    names = collections.Counter(s.name for s in rec.spans)
    assert (names["step"], names["forward"], names["backward"], names["sgd"]) == (
        1, N_CHUNKS, N_CHUNKS, 1)
    assert names["bounce"] == N_CHUNKS * BOUNCES and "pass" not in names
    step = rec.spans[0]
    assert step.name == "step" and step.parent is None
    for s in rec.spans:
        if s.name in ("forward", "backward", "sgd"):
            assert s.parent == step.index
        if s.name in ("bounce", "camera"):
            assert rec.spans[s.parent].name == "forward"
    steps = rec.summary("step")["spans"]
    assert steps["forward"]["ms"] > 0 and steps["backward"]["ms"] > 0
    assert rec.summary("pass") is None


def test_self_time_and_per_unit_exact():
    """Self time is the duration less the union of the children's
    intervals; summary sums each name's spans in the named units and
    divides by their number; syncs land on the innermost open span."""
    clock = _Clock()
    rec = prof.Recorder(clock, count_syncs=True)

    def at(t):
        clock.now = int(t * 1e6)  # ms -> ns

    for offset in (0.0, 100.0):
        at(offset)
        with prof.Span(rec, "pass"):
            at(offset + 1)
            with prof.Span(rec, "chunk"):
                at(offset + 2)
                with prof.Span(rec, "bounce"):
                    at(offset + 3)
                    with prof.Span(rec, "rng"):
                        at(offset + 7)
                    rec._sync()
                    at(offset + 8)
                    with prof.Span(rec, "query"):
                        at(offset + 9)
                        with prof.Span(rec, "launch"):
                            rec._sync()
                            at(offset + 9.5)
                        at(offset + 12)
                    at(offset + 20)
                at(offset + 21)
            rec._sync()
            at(offset + 30)
    at(500)
    with prof.Span(rec, "step"):
        at(510)
    by = {(s.unit, s.name): s for s in rec.spans}
    kids = rec.children()
    ns = 1e6
    assert rec.self_ns(by[(0, "bounce")], kids) == (18 - 4 - 4) * ns
    assert rec.self_ns(by[(0, "query")]) == 3.5 * ns
    assert rec.self_ns(by[(0, "chunk")], kids) == 2 * ns
    assert rec.self_ns(by[(0, "pass")], kids) == 10 * ns
    assert rec.self_ns(by[(0, "rng")], kids) == 4 * ns
    passes, steps = rec.summary("pass"), rec.summary("step")
    assert passes["units"] == 2 and steps["units"] == 1
    assert passes["spans"]["rng"] == {"count": 1.0, "ms": 4.0, "self_ms": 4.0}
    assert passes["spans"]["bounce"]["self_ms"] == 10.0
    assert passes["spans"]["query"]["self_ms"] == 3.5
    assert passes["spans"]["pass"] == {"count": 1.0, "ms": 30.0, "self_ms": 10.0}
    assert steps["spans"] == {"step": {"count": 1.0, "ms": 10.0, "self_ms": 10.0}}
    assert rec.summary("train") is None
    assert rec.summary("pass", skip=1)["units"] == 1 and rec.summary("step", skip=1) is None
    assert by[(0, "bounce")].syncs == 1 and by[(0, "launch")].syncs == 1
    assert by[(0, "pass")].syncs == 1
    assert passes["syncs"] == 3.0 and steps["syncs"] == 0.0
    assert rec.counters == {"syncs": 6}
    assert [s.unit for s in rec.spans] == [0] * 6 + [6] * 6 + [12]


def test_count_charges_the_innermost_span():
    """count() does nothing outside recording(); inside, it adds to the
    recorder's counters and to the innermost open span of its thread (or
    to no span where none is open), and summary reports each counter per
    unit, with COUNTERS at 0 where nothing was counted."""
    prof.count("rng_kernel", 5)
    assert prof._recorder is None
    with prof.recording("cpu") as rec:
        prof.count("rng_kernel")
        for _ in range(2):
            with prof.span("pass"):
                with prof.span("bounce"):
                    with prof.span("rng"):
                        prof.count("rng_kernel")
                    prof.count("rng_kernel", 2)
                prof.count("other")
        with prof.span("step"):
            pass
    assert rec.counters == {"rng_kernel": 7, "other": 2}
    by_name = collections.defaultdict(list)
    for s in rec.spans:
        by_name[s.name].append(s.counts)
    assert by_name["rng"] == [{"rng_kernel": 1}] * 2
    assert by_name["bounce"] == [{"rng_kernel": 2}] * 2
    assert by_name["pass"] == [{"other": 1}] * 2 and by_name["step"] == [{}]
    passes = rec.summary("pass")
    assert passes["rng_kernel"] == 3.0 and passes["other"] == 1.0
    assert rec.summary("step")["rng_kernel"] == 0.0 and rec.summary("step")["other"] == 0.0
    with prof.recording("cpu") as rec:
        with prof.span("pass"):
            pass
    assert rec.counters == {} and rec.summary("pass")["rng_kernel"] == 0.0
    assert set(prof.COUNTERS) == {"rng_kernel", "pbrt_kernel", "reference_kernel",
                                  "film_kernel"}
    assert (rec.summary("pass")["pbrt_kernel"] == rec.summary("pass")["reference_kernel"]
            == rec.summary("pass")["film_kernel"] == 0.0)


def test_threads_keep_their_own_stacks():
    """A span opened on another thread while a unit is open belongs to that
    unit but has no parent from the caller's stack; the caller's stack is
    untouched, and a sync on that thread is charged to that thread's
    span."""
    rec = prof.Recorder(count_syncs=True)
    seen = threading.Event()
    go = threading.Event()

    def worker():
        with prof.Span(rec, "launch"):
            rec._sync()
            seen.set()
            go.wait(10)

    with prof.Span(rec, "step"):
        with prof.Span(rec, "backward") as back:
            t = threading.Thread(target=worker)
            t.start()
            assert seen.wait(10)
            with prof.Span(rec, "sgd") as inner:
                pass
            go.set()
            t.join(10)
    assert not t.is_alive()
    launch = next(s for s in rec.spans if s.name == "launch")
    assert launch.parent is None and launch.unit == 0 and launch.syncs == 1
    assert inner.parent == back.index and back.syncs == 0


def test_sync_warnings_are_counted_and_restored():
    """Under the sync counter each torch sync warning counts into the
    innermost span, also when repeated from one line; other warnings are
    shown as before, and the filters and showwarning come back."""
    rec = prof.Recorder(count_syncs=True)
    with warnings.catch_warnings(record=True) as other:
        warnings.simplefilter("always")
        filters, shown = list(warnings.filters), warnings.showwarning
        with prof._counting_sync_warnings(rec):
            with prof.Span(rec, "pass"):
                for _ in range(3):
                    warnings.warn(prof.SYNC_WARNING + " (Triggered internally)", UserWarning)
                with prof.Span(rec, "readback"):
                    warnings.warn(prof.SYNC_WARNING, UserWarning)
                warnings.warn("something else", UserWarning)
        assert warnings.filters == filters and warnings.showwarning is shown
        warnings.warn(prof.SYNC_WARNING, UserWarning)
    assert [str(w.message) for w in other] == ["something else", prof.SYNC_WARNING]
    assert [s.syncs for s in rec.spans] == [3, 1]
    assert rec.counters == {"syncs": 4} and rec.summary("pass")["syncs"] == 4.0


def test_spans_on_the_profiler_clock(cornell):
    """Under a CPU torch.profiler session every span has its
    record_function event, with the same nesting. On the profiler's clock
    (start_ns + offset_ns) each event lies inside its span, give or take
    1 ms, and the events start a median of under 1 ms after their spans
    (a busy host may preempt one between the span's stamp and its event)."""
    r = _renderer(cornell, "reference")
    # a warm-up pass, profiled: the first record_function of a process under
    # the profiler spends ~1.5 ms setting up, some of it before its stamp
    for _ in range(2):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as p:
            with prof.recording("cpu") as rec:
                r.render_one_pass()
    events = sorted((e for e in p.profiler.kineto_results.events()
                     if e.name().startswith(prof.SPAN_PREFIX)), key=lambda e: e.start_ns())
    spans = sorted(rec.spans, key=lambda s: s.start_ns)
    assert [e.name() for e in events] == [prof.SPAN_PREFIX + s.name for s in spans]
    ms = 1_000_000
    for e, s in zip(events, spans):
        assert s.start_ns + rec.offset_ns - ms <= e.start_ns()
        assert e.start_ns() + e.duration_ns() <= s.end_ns + rec.offset_ns + ms
    gaps = sorted(e.start_ns() - (s.start_ns + rec.offset_ns) for e, s in zip(events, spans))
    assert abs(gaps[len(gaps) // 2]) < ms
    # the nesting: each span's event lies inside its parent's event
    ev_of = {s.index: e for s, e in zip(spans, events)}
    for s in spans:
        if s.parent is not None:
            e, pe = ev_of[s.index], ev_of[s.parent]
            assert pe.start_ns() <= e.start_ns()
            assert e.start_ns() + e.duration_ns() <= pe.start_ns() + pe.duration_ns()


def test_cli_trace_dir(cornell_path, tmp_path):
    """--trace-dir profiles the first TRACE_PASSES passes and no more: one
    Chrome trace holding their spans, and the spans' summary a pass
    beside it (no sync count off CUDA); the render runs on to its spp."""
    out = tmp_path / "t.png"
    passes = cli.TRACE_PASSES + 2
    rc = cli.main([cornell_path, "--cpu", "--res", "8", "8", "--spp", str(passes),
                   "--spp-step", "1", "--depth", "2", "--estimator", "reference", "--quiet",
                   "--out", str(out), "--hdr-out", str(tmp_path / "t.npy"),
                   "--trace-dir", str(tmp_path / "trace")])
    assert rc == 0 and out.exists()
    assert prof._recorder is None and not torch._C._autograd._profiler_enabled()
    (path,) = glob.glob(str(tmp_path / "trace" / "trace_*.json"))
    with open(path) as f:
        names = collections.Counter(e.get("name") for e in json.load(f)["traceEvents"])
    assert names[prof.SPAN_PREFIX + "pass"] == cli.TRACE_PASSES
    assert names[prof.SPAN_PREFIX + "bounce"] == 2 * cli.TRACE_PASSES
    (path,) = glob.glob(str(tmp_path / "trace" / "spans_*.json"))
    with open(path) as f:
        summary = json.load(f)
    assert summary["device"] == "cpu"
    assert summary["passes_after_first"]["units"] == cli.TRACE_PASSES - 1
    summary = summary["passes"]
    assert summary["units"] == cli.TRACE_PASSES and "syncs" not in summary
    counts = {k: v["count"] for k, v in summary["spans"].items()}
    assert counts == {"pass": 1, "chunk": 1, "camera": 1, "bounce": 2, "rng": 2 + 3 * 2,
                      "query": 2 * 2, "readback": 1, "film": 1}
    assert all(0 <= v["self_ms"] <= v["ms"] for v in summary["spans"].values())
    assert summary["spans"]["pass"]["ms"] > summary["spans"]["bounce"]["ms"] > 0
