"""The reference estimator's bounce kernels (csrc/reference.cu,
kernels/reference.py) and the path that trace_reference takes to them.

On the CPU: the gate (a CPU tensor, a float64 wavefront, an input that
requires grad under grad mode, or the debug records run the eager loop and
never load the kernel library); the wrapper's operands on an emulated
launch, a stand-in that runs the kernels' contract with the eager bounce's
own functions on the memory the wrapper points it at, so that
trace_reference through it equals the eager loop bit for bit; the counter
reference_kernel and the spans; the wrapper's refusals. On the card
(marked `cuda`, run with `python -m pytest
tests/test_torch_reference_kernel.py -m cuda`): one bounce of the kernels
against one of the eager loop from the same state, lane by lane, behind
the whole-table and the cluster queries; a whole film against the cell
cornell.render's plain reference; and the lane-by-lane comparison failing
on kernels built with the NEE term dropped or the bounce-0 emission weight
at every bounce."""

from __future__ import annotations

import copy
import ctypes
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pyrenderer_tpu_torch import rng
from pyrenderer_tpu_torch.config import RenderConfig
from pyrenderer_tpu_torch.core import integrator as integ
from pyrenderer_tpu_torch.core import sampling
from pyrenderer_tpu_torch.core.integrator import render_image
from pyrenderer_tpu_torch.core.sampling import INV_PI
from pyrenderer_tpu_torch.kernels import build
from pyrenderer_tpu_torch.kernels import pbrt as pk
from pyrenderer_tpu_torch.kernels import reference as rk
from pyrenderer_tpu_torch.scene import procgen, to_device
from pyrenderer_tpu_torch.scene.tungsten import build_scene
from pyrenderer_tpu_torch.utils import profiling
from tests.test_torch_pbrt_kernel import (
    CORNELL,
    _bools,
    _Counter,
    _cuda,
    _custom_tables,
    _dot,
    _f32,
    _face_rows,
    _ints,
    _mem,
    _ulps,
    _wavefront,
)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


def _cornell(two_lights=False):
    """The Cornell box; with two_lights a small emissive cube (12 faces)
    beside the ceiling quad (2), so that the light prim is drawn."""
    data = json.loads(CORNELL.read_text())
    if two_lights:
        data["primitives"].append(
            {"type": "cube", "bsdf": "Light", "emission": [3, 3, 3],
             "transform": {"position": [-0.6, 1.2, 0.3], "scale": [0.2, 0.2, 0.2],
                           "rotation": [0, 0, 0]}})
    host, camera, _ = build_scene(data)
    return host, camera


# ------------------------------------------------- the emulated launch

def _emulated_hit(n, bounce, k0, rounds, pixel, pixel_stride, sample, sample_stride,
                  sample_const, wide, ro, rd, hit, tri, rows, row_stride, gather, light_data,
                  light_stride, light_nfaces, n_lights, f_max, light_color, shadow_scale, t_max,
                  beta, radiance, alive, t1, s_ro, s_rd, s_t1, nee_out, flags, n_rays):
    """reference_hit_kernel's contract, in the eager bounce's arithmetic."""
    ctr = _Counter(n, bounce, k0, rounds, pixel, pixel_stride, sample, sample_stride,
                   sample_const, wide)
    ro, rd, beta, radiance = (_f32(p, n, 3) for p in (ro, rd, beta, radiance))
    alive, hit = _bools(alive, n), _bools(hit, n)
    live = alive.clone()
    row = _face_rows(ctr, tri, rows, row_stride, gather)
    emissive = row[:, 13] > 0.5
    now = live & hit & ~emissive
    _f32(n_rays, 1)[0] += live.sum(dtype=torch.float32)
    _f32(n_rays, 1)[0] += now.sum(dtype=torch.float32)
    _, p, _, nrm = integ._hit_geometry(row, ro, rd)

    d1 = _dot(-rd, nrm)
    weight = torch.ones_like(d1) if bounce == 0 else d1
    add_light = (live & hit & emissive & (d1 > 0))[:, None]
    radiance[:] = radiance + torch.where(add_light, _f32(light_color, 3) * beta * weight[:, None],
                                         0.0)

    u1, u2 = ctr.uniform2(rng.U_BSDF_0)
    wi = sampling.rotate_z_to(nrm, sampling.cosine_sample_hemisphere(u1, u2))
    cos_wi = _dot(nrm, wi)
    pdf = cos_wi.abs() * INV_PI
    safe_pdf = torch.where(pdf == 0, 1.0, pdf)
    scale = torch.clamp(cos_wi, min=0.0) / safe_pdf * INV_PI
    new_beta = torch.where((cos_wi != 0)[:, None], row[:, 9:12] * scale[:, None], 0.0)
    beta[:] = torch.where(now[:, None], beta * new_beta, beta)

    light_nfaces = _ints(light_nfaces, 1, wide & 8, n_lights)
    li = torch.zeros(n, dtype=torch.int64)
    if n_lights > 1:
        li = torch.clamp((ctr.uniform(rng.U_LIGHT_PRIM) * n_lights).to(torch.int64), 0,
                         n_lights - 1)
    nfaces = light_nfaces[li]
    fi = torch.minimum(torch.clamp((ctr.uniform(rng.U_LIGHT_FACE) * nfaces.to(torch.float32))
                                   .to(torch.int64), min=0), nfaces - 1)
    lrow = _f32(light_data, n_lights * f_max, light_stride).index_select(0, li * f_max + fi)
    u, v = ctr.uniform2(rng.U_LIGHT_U)
    p2 = sampling.sample_triangle_point(lrow[:, 0:3], lrow[:, 3:6], lrow[:, 6:9], u, v)
    n2 = lrow[:, 12][:, None] * sampling.safe_normalize(
        torch.linalg.cross(lrow[:, 3:6] - lrow[:, 0:3], lrow[:, 6:9] - lrow[:, 0:3], dim=-1))
    to_light = p2 - p
    dist_sq = sampling.maximum(_dot(to_light, to_light), 1e-12)
    dist = torch.sqrt(dist_sq)
    w = to_light / dist[:, None]
    dot1, dot2 = _dot(nrm, w), _dot(n2, -w)
    cand = now & (dot1 > 0) & (dot2 > 0)
    contrib = lrow[:, 9:12] * (dot1 * dot2 / dist_sq)[:, None]

    _f32(s_ro, n, 3)[:] = torch.where(now[:, None], p, ro)
    _f32(s_rd, n, 3)[:] = torch.where(now[:, None], w, rd)
    _f32(s_t1, n)[:] = torch.where(now, dist * shadow_scale, 0.0)
    _f32(nee_out, n, 3)[cand] = (beta * contrib)[cand]
    _mem(ctypes.c_uint8, np.uint8, flags, n)[:] = cand.to(torch.uint8)
    ro[:] = torch.where(now[:, None], p, ro)
    rd[:] = torch.where(now[:, None], wi, rd)
    alive[:] = now
    _f32(t1, n)[:] = torch.where(now, t_max, 0.0)


def _emulated_nee(n, flags, occ, nee, radiance):
    """reference_nee_kernel's contract."""
    clear = (_mem(ctypes.c_uint8, np.uint8, flags, n) & 1).bool() & ~_bools(occ, n)
    radiance = _f32(radiance, n, 3)
    radiance[clear] = radiance[clear] + _f32(nee, n, 3)[clear]


def _emulated_launch(calls):
    """A stand-in for build.launch that runs the two C entry points'
    contracts on the host memory the wrapper points them at; records each
    call's name."""
    fns = {"pr_reference_hit": _emulated_hit, "pr_reference_nee": _emulated_nee}

    def launch(fn_name, device, *args):
        assert device.type == "cpu" and args[0] > 0
        fns[fn_name](*args)
        calls.append(fn_name)

    return launch


def _to_the_kernels(monkeypatch, calls):
    """trace_reference takes the kernels' path on the CPU, each launch
    emulated; the RNG and the queries keep their CPU twins."""
    on_cuda = build.on_cuda
    monkeypatch.setattr(build, "on_cuda",
                        lambda x, name: name == "reference" or on_cuda(x, name))
    monkeypatch.setattr(build, "launch", _emulated_launch(calls))


CASES = [
    # (name, two_lights, backend, sample)
    ("cornell", False, "brute", 3),
    ("cornell_lane_samples", False, "brute", "lanes"),
    ("two_lights", True, "brute", 2**20 - 1),
    ("two_lights_lane_samples", True, "brute", "lanes"),
    ("fetch_face_fn", True, "custom", 5),
    ("cluster_sorted", False, "cluster", 6),
    ("cluster_sorted_lane_samples", True, "cluster", "lanes"),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_kernel_operands_on_an_emulated_launch(case, monkeypatch):
    """The wrapper's operands, run through a stand-in of the kernels'
    contract written with the eager bounce's functions: trace_reference on
    the kernels' path equals the eager loop bit for bit (radiance and rays
    traced) on one light and on two (the light prim drawn), int and
    per-lane sample ids, the face table gathered by the hit ids or a fetch
    function's rows, and the cluster backend with its per-query coherence
    sort (two suspend/resume rounds, so that the closest-hit query runs its
    sorted operands on the CPU too); two launches a bounce, each counted by
    its wrapper and as one reference_kernel, no Threefry draw in a bounce,
    and the spans `bounce` with both queries under it."""
    _, two_lights, backend, sample = case
    monkeypatch.setenv("PYRENDERER_TF_ROUNDS", "13")
    rounds = {"cluster_rounds": 2, "cluster_budget": 2} if backend == "cluster" else {}
    cfg = RenderConfig(max_bounces=6, seed=2**31 + 9, estimator="reference",
                       cluster_sort=True, **rounds)
    scene, pixel, sample, ro, rd = _wavefront(*_cornell(two_lights), 12, "cpu", sample,
                                              cfg.seed)
    assert scene.light_faces.shape[0] == (2 if two_lights else 1)
    tables = (_custom_tables(scene, cfg) if backend == "custom"
              else integ.TraceTables(scene, cfg, backend))
    if backend == "cluster":
        assert tables.cluster_sort
    want, want_rays = integ.trace_reference(scene, cfg, ro, rd, pixel, sample, cfg.seed,
                                            tables=tables, with_stats=True)
    calls = []
    _to_the_kernels(monkeypatch, calls)
    rk.reset_counters()
    with profiling.recording("cpu") as rec:
        with profiling.span("pass"):
            got, rays = integ.trace_reference(scene, cfg, ro, rd, pixel, sample, cfg.seed,
                                              tables=tables, with_stats=True)
    assert torch.equal(got, want) and torch.equal(rays, want_rays)
    assert float(want.sum()) > 0 and rays.dtype == torch.float32
    assert calls == ["pr_reference_hit", "pr_reference_nee"] * cfg.max_bounces
    assert rk.hit.launches == rk.nee.launches == cfg.max_bounces
    summary = rec.summary("pass")
    assert summary["reference_kernel"] == 2 * cfg.max_bounces
    assert summary["rng_kernel"] == summary["pbrt_kernel"] == 0
    spans = {name: s["count"] for name, s in summary["spans"].items()}
    assert spans.get("bounce") == cfg.max_bounces and "rng" not in spans
    parents = {(s.name, rec.spans[s.parent].name) for s in rec.spans if s.parent is not None
               and s.name == "query"}
    if backend != "custom":
        assert parents == {("query", "bounce")} and spans["query"] == 2 * cfg.max_bounces
    rk.reset_counters()


def test_render_image_on_an_emulated_launch(monkeypatch):
    """render_image (the per-sample traces of render_block) on the kernels'
    path gives the eager loop's image bit for bit."""
    host, camera = _cornell()
    scene, cam = to_device(host, camera._replace(resolution=(10, 8)), "cpu")
    cfg = RenderConfig(max_bounces=4, spp=3, seed=17, estimator="reference")
    want = render_image(scene, cam, cfg, chunk=32)
    calls = []
    _to_the_kernels(monkeypatch, calls)
    got = render_image(scene, cam, cfg, chunk=32)
    assert torch.equal(got, want) and float(want.sum()) > 0
    assert len(calls) == 2 * cfg.max_bounces * cfg.spp * 3


@pytest.mark.parametrize("why", ["cpu", "float64", "grad_rays", "grad_table", "grad_color",
                                 "collect_paths"])
def test_the_eager_loop_runs_off_the_kernels_path(why, monkeypatch):
    """A CPU tensor, a float64 wavefront, rays, a face table or the light
    color that require grad under grad mode, and the debug records run the
    eager loop: with the kernel library and every launch refused,
    trace_reference gives the eager radiance and launches nothing (all but
    the first with the device test passed as CUDA's)."""
    cfg = RenderConfig(max_bounces=5, seed=11, estimator="reference")
    dtype = torch.float64 if why == "float64" else torch.float32
    scene, pixel, sample, ro, rd = _wavefront(*_cornell(True), 8, "cpu", 4, cfg.seed, dtype)
    tables = integ.TraceTables(scene, cfg, "brute")
    want = integ.trace_reference(scene, cfg, ro, rd, pixel, sample, cfg.seed, tables=tables)

    def refuse(*args):
        raise AssertionError("the kernels' path was taken")

    monkeypatch.setattr(build, "library", refuse)
    monkeypatch.setattr(build, "launch", refuse)
    if why != "cpu":
        on_cuda = build.on_cuda
        monkeypatch.setattr(build, "on_cuda",
                            lambda x, name: name == "reference" or on_cuda(x, name))
    if why == "grad_rays":
        ro = ro.clone().requires_grad_()
    if why == "grad_table":
        tables.face_data = tables.face_data.clone().requires_grad_()
    if why == "grad_color":
        tables.light_color = tables.light_color.clone().requires_grad_()
    rk.reset_counters()
    with profiling.recording("cpu") as rec:
        with profiling.span("pass"):
            got = integ.trace_reference(scene, cfg, ro, rd, pixel, sample, cfg.seed,
                                        tables=tables, collect_paths=why == "collect_paths")
    if why == "collect_paths":
        got, records = got
        assert records["hit"].shape == (cfg.max_bounces, ro.shape[0])
    assert torch.equal(got.detach(), want)
    assert got.requires_grad is why.startswith("grad")
    assert rec.summary("pass")["reference_kernel"] == 0 and rk.hit.launches == 0
    if why.startswith("grad"):
        with torch.no_grad():
            monkeypatch.setattr(build, "launch", _emulated_launch([]))
            got = integ.trace_reference(scene, cfg, ro, rd, pixel, sample, cfg.seed,
                                        tables=tables)
        assert torch.equal(got, want) and rk.hit.launches == cfg.max_bounces
    rk.reset_counters()


def _operands(n=10, device="cpu"):
    wf = pk.Wavefront.start(torch.rand(n, 3, device=device), torch.rand(n, 3, device=device),
                            torch.arange(n, device=device), 3, 1e4, pbrt=False)
    return wf, dict(hit_mask=torch.ones(n, dtype=torch.bool, device=device),
                    tri=torch.zeros(n, dtype=torch.int32, device=device),
                    rows=torch.rand(4, 16, device=device), gather=True,
                    light_data=torch.rand(2, 16, device=device),
                    light_nfaces=torch.full((1,), 2, device=device), f_max=2,
                    light_color=torch.rand(3, device=device), shadow_scale=0.999, t_max=1e4)


@pytest.mark.parametrize("fault", ["device", "dtype", "layout", "rows", "tri", "nfaces",
                                   "color", "occ"])
def test_wrapper_refuses_what_the_kernels_cannot_take(fault, monkeypatch):
    """An operand on another device, of another dtype or shape, or not
    contiguous is refused before any launch, as are face rows too narrow,
    hit ids of another width, light counts that do not match the light
    table, a light color of another length and an occlusion mask of another
    dtype; a wavefront started without the pbrt fields is refused by the
    pbrt kernels."""
    monkeypatch.setattr(build, "launch", lambda *a: pytest.fail("launched"))
    wf, kw = _operands()
    occ = torch.zeros(10, dtype=torch.bool)
    if fault == "device":
        kw["hit_mask"] = kw["hit_mask"].to("meta")
    elif fault == "dtype":
        wf.beta = wf.beta.double()
    elif fault == "layout":
        wf.radiance = torch.zeros(3, 10).T
    elif fault == "rows":
        kw["rows"] = kw["rows"][:, :14]
    elif fault == "tri":
        kw["tri"] = kw["tri"].to(torch.int16)
    elif fault == "nfaces":
        kw["f_max"] = 3
    elif fault == "color":
        kw["light_color"] = torch.rand(4)
    else:
        occ = occ.to(torch.uint8)
    if fault != "occ":
        with pytest.raises(ValueError, match="reference"):
            rk.hit(wf, 1, 0, 20, **kw)
    if fault in ("layout", "occ"):
        with pytest.raises(ValueError, match="reference"):
            rk.nee(wf, occ)
    if fault == "dtype":
        with pytest.raises(ValueError, match="pbrt: the wavefront has no prev_pdf"):
            pk.hit(pk.Wavefront.start(torch.rand(10, 3), torch.rand(10, 3), torch.arange(10),
                                      3, 1e4, pbrt=False), 1, 0, 20, kw["hit_mask"], kw["tri"],
                   torch.rand(4, 24), True, kw["light_data"], kw["light_nfaces"], 2, 0.999)


def test_wavefront_without_the_pbrt_fields():
    """Wavefront.start(pbrt=False) leaves prev_pdf, prev_spec and nrm out
    and lays out the rest as the pbrt wavefront; its counter operands are
    the pbrt wavefront's."""
    n = 6
    ro = torch.rand(3, n).T
    wf = pk.Wavefront.start(ro, ro, torch.arange(n), torch.arange(n), 1e4, pbrt=False)
    full = pk.Wavefront.start(ro, ro, torch.arange(n), torch.arange(n), 1e4)
    assert wf.prev_pdf is None and wf.prev_spec is None and wf.nrm is None
    assert full.prev_pdf is not None and full.nrm is not None
    assert torch.equal(wf.ro, ro) and wf.ro.is_contiguous() and torch.equal(wf.t1, full.t1)
    args, wide = wf._operands(5, 2, 13, "reference")
    args_full, wide_full = full._operands(5, 2, 13)
    assert wide == wide_full and [a for k, a in enumerate(args) if k not in (4, 6)] == [
        a for k, a in enumerate(args_full) if k not in (4, 6)]


# ---------------------------------------------------------- on the card

def _eager_states(monkeypatch, scene, cfg, ro, rd, pixel, sample, tables):
    """Run the eager loop on the card and keep what it holds at each
    bounce: the state at each closest query (the state after the bounce
    before) and the shadow ray and live lanes at each any-hit query, read
    from trace_reference's frame."""
    states, shadows = [], []
    closest, any_hit = integ._closest, integ._any_hit

    def spy_closest(*args, **kw):
        f = sys._getframe(1).f_locals
        states.append({k: f[k].clone() for k in ("ro", "rd", "beta", "radiance", "alive")})
        return closest(*args, **kw)

    def spy_any_hit(scene_, tables_, cfg_, p, w, t1):
        f = sys._getframe(1).f_locals
        shadows.append({"s_ro": p.clone(), "s_rd": w.clone(), "s_t1": t1.clone(),
                        "alive": f["alive"].clone()})
        return any_hit(scene_, tables_, cfg_, p, w, t1)

    with monkeypatch.context() as m:
        m.setattr(integ, "use_bounce_kernels", lambda *a: False)
        m.setattr(integ, "_closest", spy_closest)
        m.setattr(integ, "_any_hit", spy_any_hit)
        integ.trace_reference(scene, cfg, ro, rd, pixel, sample, cfg.seed, tables=tables)
    return states, shadows


def _kernel_bounce(scene, cfg, tables, state, pixel, sample, bounce):
    """One bounce of the kernels from an eager state: the wavefront after
    it (its shadow ray the bounce's)."""
    wf = pk.Wavefront.start(state["ro"], state["rd"], pixel, sample, cfg.t_max, pbrt=False)
    for k in ("beta", "radiance", "alive"):
        getattr(wf, k).copy_(state[k])
    wf.t1.copy_(torch.where(wf.alive, cfg.t_max, 0.0))
    integ._kernel_bounce(scene, tables, cfg, wf, bounce, cfg.seed)
    return wf


def _lane_gaps(wf, eager, shadow, t_max):
    """{output: (share of lanes not bit-equal, largest ulp gap)} over the
    lanes where each output is read: radiance, beta, ro, rd, the next
    interval and the shadow interval on every lane; the shadow ray's origin
    and direction where its interval is open; alive on every lane."""
    out = {}
    open_ = shadow["s_t1"] > 0
    t1 = torch.where(eager["alive"], t_max, 0.0)
    pairs = [(k, getattr(wf, k), eager[k], None) for k in ("radiance", "beta", "ro", "rd")]
    pairs += [("t1", wf.t1, t1, None), ("s_t1", wf.s_t1, shadow["s_t1"], None),
              ("s_ro", wf.s_ro, shadow["s_ro"], open_), ("s_rd", wf.s_rd, shadow["s_rd"], open_)]
    for name, a, b, mask in pairs:
        gap = _ulps(a, b)
        gap = gap.reshape(gap.shape[0], -1).amax(dim=1)
        if mask is not None:
            gap = gap[mask]
        out[name] = (float((gap > 0).float().mean()) if gap.numel() else 0.0,
                     int(gap.max()) if gap.numel() else 0)
    diff = wf.alive != eager["alive"]
    out["alive"] = (float(diff.float().mean()), int(diff.any()))
    return out


def _check_gaps(gaps):
    """Every output bit-equal on >= 99.9% of its lanes, the rest within 4
    ulp, and alive equal on every lane."""
    assert gaps["alive"] == (0.0, 0), gaps
    for name, (share, worst) in gaps.items():
        assert share <= 1e-3 and worst <= 4, (name, gaps)


def _terrain():
    """terrain8k (procgen terrain res 64, 8,204 triangles) in the Cornell
    walls."""
    host, camera, _ = build_scene(procgen.big_scene_data("terrain", res=64))
    return host, camera


SCENES = {"cornell": (_cornell, "cuda"), "terrain": (_terrain, "cluster")}


def _one_bounce_gaps(monkeypatch, scene_name, seed, sample, bounces=(0, 1, 2, 3)):
    """For each bounce in `bounces`: the lane gaps of one bounce of the
    kernels against the eager loop's from the same state, and whether the
    rays traced were bit-equal. 2^16 lanes (256 x 256); the Cornell box
    behind the whole-table queries (B1/B2), terrain8k behind the cluster
    queries (B3/B4)."""
    dev = _cuda()
    make, backend = SCENES[scene_name]
    cfg = RenderConfig(max_bounces=max(bounces) + 2, seed=seed, estimator="reference")
    scene, pixel, sample, ro, rd = _wavefront(*make(), 256, dev, sample, seed)
    tables = integ.TraceTables(scene, cfg, backend)
    states, shadows = _eager_states(monkeypatch, scene, cfg, ro, rd, pixel, sample, tables)
    out = {}
    for b in bounces:
        wf = _kernel_bounce(scene, cfg, tables, states[b], pixel, sample, b)
        rays = (torch.zeros((), device=dev) + states[b]["alive"].sum(dtype=torch.float32)
                + shadows[b]["alive"].sum(dtype=torch.float32))
        out[b] = (_lane_gaps(wf, states[b + 1], shadows[b], cfg.t_max),
                  torch.equal(wf.n_rays, rays))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("sample", [7, "lanes"])
@pytest.mark.parametrize("seed", [1, 2**31 + 5, 3_000_000_019])
@pytest.mark.parametrize("scene_name", ["cornell", "terrain"])
def test_one_bounce_against_the_eager_loop_on_gpu(scene_name, seed, sample, monkeypatch):
    """On the card: one bounce of the kernels (the closest query,
    reference_hit, the any-hit query, reference_nee) from the eager loop's
    state at bounces 0-3 against the eager loop's next state, at 2^16
    lanes: the Cornell box through B1/B2 and terrain8k through B3/B4, three
    seeds, an int and a per-lane sample id. Each output bit-equal on >=
    99.9% of the lanes where it is read, the rest within 4 ulp (printed:
    the share of lanes that part, sinf and cosf's last ulp), alive on every
    lane, and the rays traced bit-equal."""
    for bounce, (gaps, rays_equal) in _one_bounce_gaps(
            monkeypatch, scene_name, seed, sample).items():
        print(scene_name, seed, sample, bounce, gaps)
        _check_gaps(gaps)
        assert rays_equal, bounce


@pytest.mark.cuda
def test_film_against_the_plain_reference_on_gpu(monkeypatch):
    """On the card: the harness's run of cornell.render cut to 256 x 256,
    its films rendered by trace_reference on the kernels' path and judged
    against the plain reference (benchmark/reference/render.py) by the
    cell's own limits, with the kernels launched in every bounce."""
    from benchmark import harness

    _cuda()
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.load_cell("cornell.render", copy.deepcopy(bench))
    cell.config["resolution"] = [256, 256]
    monkeypatch.setattr(harness, "load_cell", lambda *a, **k: cell)
    rk.reset_counters()
    res = harness.run_cell("cornell.render", 2**31 + 123, 2.0, False, device="cuda")
    assert res["correct"] is True, res["checks"]
    assert rk.hit.launches > 0 and rk.hit.launches == rk.nee.launches
    rk.reset_counters()


@pytest.mark.cuda
@pytest.mark.parametrize("fault,old,new", [
    ("nee_off", "store3(radiance + 3 * i, add(load3(radiance + 3 * i), load3(nee + 3 * i)));",
     ";"),
    ("bounce0_weight", "const float w = ctr.bounce == 0 ? 1.0f : d1;", "const float w = 1.0f;"),
])
def test_the_comparison_sees_nee_and_the_emission_weight_on_gpu(fault, old, new, monkeypatch,
                                                                 tmp_path):
    """On the card: kernels built from a copy of csrc/ with the NEE term
    never added, or with the emission's bounce-0 weight (1) at every
    bounce, fail the one-bounce comparison at bounce 1 on the Cornell
    box."""
    _cuda()
    src = tmp_path / "csrc"
    shutil.copytree(build.CSRC, src)
    text = (src / "reference.cu").read_text()
    assert text.count(old) == 1
    (src / "reference.cu").write_text(text.replace(old, new))
    monkeypatch.setattr(build, "CSRC", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "_lib", None)
    gaps, _ = _one_bounce_gaps(monkeypatch, "cornell", 2**31 + 5, 7, bounces=(1,))[1]
    print(fault, gaps)
    with pytest.raises(AssertionError):
        _check_gaps(gaps)
    assert gaps["radiance"][0] > 1e-3
