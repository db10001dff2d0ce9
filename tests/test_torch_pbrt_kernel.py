"""The pbrt bounce's CUDA kernels (csrc/pbrt.cu, kernels/pbrt.py) and the
path that trace_pbrt takes to them.

On the CPU: the gate (a CPU tensor, a float64 wavefront or an input that
requires grad under grad mode runs the eager loop and never loads the
kernel library); the wrapper's operands on an emulated launch, a stand-in
that runs the kernels' contract with the eager bounce's own functions on
the memory the wrapper points it at, so that trace_pbrt through it equals
the eager loop bit for bit; the counter pbrt_kernel and the spans; the
wrapper's refusals. On the card (marked `cuda`, run with `python -m pytest
tests/test_torch_pbrt_kernel.py -m cuda`): one bounce of the kernels
against one of the eager loop from the same state, lane by lane; a whole
film against the cell cornell.cli's plain reference; and the lane-by-lane
comparison failing on kernels built with MIS or NEE taken out."""

from __future__ import annotations

import copy
import ctypes
import json
import os
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pyrenderer_tpu_torch import rng
from pyrenderer_tpu_torch.config import RenderConfig
from pyrenderer_tpu_torch.core import bsdf, sampling
from pyrenderer_tpu_torch.core import integrator as integ
from pyrenderer_tpu_torch.core import integrator_pbrt as ip
from pyrenderer_tpu_torch.core.camera import generate_rays
from pyrenderer_tpu_torch.core.sampling import INV_PI
from pyrenderer_tpu_torch.kernels import build
from pyrenderer_tpu_torch.kernels import pbrt as pk
from pyrenderer_tpu_torch.scene import to_device
from pyrenderer_tpu_torch.scene.tungsten import build_scene, load_tungsten
from pyrenderer_tpu_torch.scene.types import MAT_LAMBERT, MAT_METAL
from pyrenderer_tpu_torch.utils import profiling

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CORNELL = ROOT / "tests" / "data" / "cornell_box.json"
SPHERES = ROOT / "scenes" / "spheres.json"
_U32 = 0xFFFFFFFF


def _cornell(metal_glass=False):
    """The Cornell box; with metal_glass the tall box is metal (roughness
    0.1) and the short box glass (ior 1.5), as tests/test_torch_pbrt.py
    makes it."""
    data = json.loads(CORNELL.read_text())
    if metal_glass:
        for b in data["bsdfs"]:
            if b["name"] == "TallBox":
                b.update(type="metal", roughness=0.1)
            if b["name"] == "ShortBox":
                b.update(type="dielectric", ior=1.5)
    host, camera, _ = build_scene(data)
    return host, camera


def _wavefront(host, camera, res, device, sample, seed, dtype=torch.float32):
    """The scene and camera on `device` and one sample of a res x res block
    of pixels: (scene, pixel ids, sample ids, ro, rd). `sample` is an int,
    or "lanes" for an (N,) tensor of per-pixel ids."""
    scene, cam = to_device(host, camera._replace(resolution=(res, res)), device, dtype)
    ys, xs = np.mgrid[0:res, 0:res]
    px = torch.as_tensor(xs.reshape(-1), device=device)
    py = torch.as_tensor(ys.reshape(-1), device=device)
    if sample == "lanes":
        sample = (torch.arange(res * res, device=device) * 7919 + 3) % 1000
    ro, rd = generate_rays(cam, px, py, sample, seed)
    return scene, py * res + px, sample, ro, rd


# ------------------------------------------------- the emulated launch

def _mem(ctype, dt, ptr, n):
    """n values of C type `ctype` at address `ptr`, as a tensor sharing the
    memory (writes land where the wrapper pointed)."""
    return torch.from_numpy(np.frombuffer((ctype * n).from_address(ptr), dt))


def _f32(ptr, n, cols=None):
    x = _mem(ctypes.c_float, np.float32, ptr, n * (cols or 1))
    return x if cols is None else x.view(n, cols)


def _bools(ptr, n):
    return _mem(ctypes.c_bool, np.bool_, ptr, n)


def _ints(ptr, stride, wide, n):
    """n lanes of an int32 or int64 operand read through its stride (0: one
    value broadcast), as int64."""
    ctype, dt = (ctypes.c_int64, np.int64) if wide else (ctypes.c_int32, np.int32)
    buf = np.frombuffer((ctype * ((n - 1) * stride + 1)).from_address(ptr), dt)
    return torch.from_numpy((buf[::stride] if stride else np.repeat(buf, n)).astype(np.int64))


class _Counter:
    """The counter operands of one launch, drawn as the kernel draws them:
    Threefry under (k0, rng._KEY_TAG) at the launch's rounds, the uniforms
    rng._to_unit's."""

    def __init__(self, n, bounce, k0, rounds, pixel, pixel_stride, sample, sample_stride,
                 sample_const, wide):
        self.n, self.bounce, self.k0, self.rounds = n, bounce, k0, rounds
        self.pixel = _ints(pixel, pixel_stride, wide & 1, n) & _U32
        self.c1 = sample_const | bounce << 4
        if sample:
            self.c1 = self.c1 | (_ints(sample, sample_stride, wide & 2, n) << 12) & _U32
        self.wide = wide

    def uniform2(self, use):
        x0, x1 = rng.threefry2x32(self.k0, rng._KEY_TAG, self.pixel, self.c1 | use, self.rounds)
        return rng._to_unit(x0, torch.float32), rng._to_unit(x1, torch.float32)

    def uniform(self, use):
        return self.uniform2(use)[0]


def _face_rows(ctr, tri, rows, row_stride, gather):
    """Each lane's face row, as the kernels read it."""
    n = ctr.n
    tri = _ints(tri, 1, ctr.wide & 4, n).clamp(min=0)
    if not gather:
        return _f32(rows, n, row_stride)
    table = _f32(rows, int(tri.max()) + 1, row_stride)
    return table.index_select(0, tri)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _emulated_hit(n, bounce, k0, rounds, pixel, pixel_stride, sample, sample_stride,
                  sample_const, wide, ro, rd, hit, tri, rows, row_stride, gather, light_data,
                  light_stride, light_nfaces, n_lights, f_max, beta, radiance, alive, prev_pdf,
                  prev_spec, shadow_scale, s_ro, s_rd, s_t1, nrm_out, nee_out, flags, n_rays,
                  closest_rays, shadow_rays):
    """pbrt_hit_kernel's contract, in the eager bounce's arithmetic."""
    ctr = _Counter(n, bounce, k0, rounds, pixel, pixel_stride, sample, sample_stride,
                   sample_const, wide)
    ro, rd, beta, radiance = (_f32(p, n, 3) for p in (ro, rd, beta, radiance))
    alive, hit, prev_spec = _bools(alive, n), _bools(hit, n), _bools(prev_spec, n)
    prev_pdf = _f32(prev_pdf, n)
    live = alive.clone()
    _f32(n_rays, 1)[0] += live.sum(dtype=torch.float32)
    _f32(closest_rays, 1)[0] += live.sum(dtype=torch.float32)
    row = _face_rows(ctr, tri, rows, row_stride, gather)
    v0, e1, e2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
    albedo, sign = row[:, 9:12], row[:, 12]
    emissive, sided = row[:, 13] > 0.5, row[:, 14] > 0.5
    mat_type = row[:, 15].to(torch.int64)
    det = _dot(torch.linalg.cross(e1, rd, dim=-1), e2)
    safe_det = torch.where(det == 0, 1.0, det)
    t = -_dot(torch.linalg.cross(ro - v0, e2, dim=-1), e1) / safe_det
    p = ro + t[:, None] * rd
    n_geo = sign[:, None] * sampling.safe_normalize(torch.linalg.cross(e1, e2, dim=-1))
    flip = (~sided) & (_dot(n_geo, -rd) < 0)
    nrm = torch.where(flip[:, None], -n_geo, n_geo)
    cos_l = _dot(-rd, nrm)
    pdf_light_sa = row[:, 21] * sampling.maximum(t * t, 1e-12) / sampling.maximum(cos_l, 1e-6)
    w_mis = torch.ones_like(cos_l)
    if bounce:
        w_mis = torch.where(prev_spec, 1.0, bsdf.power_heuristic(prev_pdf, pdf_light_sa))
    add_em = (live & hit & emissive & (cos_l > 0))[:, None]
    radiance[:] = radiance + torch.where(add_em, row[:, 16:19] * beta * w_mis[:, None], 0.0)
    now = live & hit & (~emissive)
    alive[:] = now
    lambert = now & (mat_type == MAT_LAMBERT)

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
    wl = to_light / dist[:, None]
    cos_surf, cos_light = _dot(nrm, wl), _dot(n2, -wl)
    cand = lambert & (cos_surf > 0) & (cos_light > 0)
    pdf_nee_sa = lrow[:, 13] * dist_sq / sampling.maximum(cos_light, 1e-6)
    w_nee = bsdf.power_heuristic(pdf_nee_sa, bsdf.lambert_pdf(nrm, wl))
    contrib = albedo * INV_PI * lrow[:, 9:12] * (
        w_nee * cos_surf / sampling.maximum(pdf_nee_sa, 1e-12))[:, None]

    _f32(s_ro, n, 3)[:] = torch.where(now[:, None], p, ro)
    _f32(s_rd, n, 3)[:] = torch.where(lambert[:, None], wl, rd)
    _f32(s_t1, n)[:] = torch.where(cand, dist * shadow_scale, 0.0)
    _f32(shadow_rays, 1)[0] += cand.sum(dtype=torch.float32)
    _f32(nrm_out, n, 3)[now] = nrm[now]
    _f32(nee_out, n, 3)[cand] = (beta * contrib)[cand]
    _mem(ctypes.c_uint8, np.uint8, flags, n)[:] = torch.where(
        now, cand.to(torch.uint8) | flip.to(torch.uint8) << 1, 0)


def _emulated_scatter(n, bounce, k0, rounds, pixel, pixel_stride, sample, sample_stride,
                      sample_const, wide, tri, rows, row_stride, gather, occ, s_ro, nrm, nee,
                      flags, ro, rd, beta, radiance, alive, prev_pdf, prev_spec, t1, roulette,
                      t_max, n_rays):
    """pbrt_scatter_kernel's contract, in the eager bounce's arithmetic."""
    ctr = _Counter(n, bounce, k0, rounds, pixel, pixel_stride, sample, sample_stride,
                   sample_const, wide)
    ro, rd, beta, radiance = (_f32(x, n, 3) for x in (ro, rd, beta, radiance))
    alive = _bools(alive, n)
    live = alive.clone()
    _f32(n_rays, 1)[0] += live.sum(dtype=torch.float32)
    f = _mem(ctypes.c_uint8, np.uint8, flags, n)
    clear = live & (f & 1).bool() & ~_bools(occ, n)
    radiance[:] = radiance + torch.where(clear[:, None], _f32(nee, n, 3), 0.0)
    row = _face_rows(ctr, tri, rows, row_stride, gather)
    albedo, mat_type = row[:, 9:12], row[:, 15].to(torch.int64)
    nrm = _f32(nrm, n, 3)
    n_geo = torch.where((f & 2).bool()[:, None], -nrm, nrm)
    u1, u2 = ctr.uniform2(rng.U_BSDF_0)
    u3 = ctr.uniform(rng.U_BSDF_2)
    is_lambert, is_metal = mat_type == MAT_LAMBERT, mat_type == MAT_METAL
    wi_l, pdf_l = bsdf.lambert_sample(nrm, u1, u2)
    wi_m, metal_ok = bsdf.metal_sample(rd, nrm, row[:, 20], u1, u2, u3)
    wi_d = bsdf.dielectric_sample(rd, n_geo, row[:, 19], u3)
    wi = torch.where(is_lambert[:, None], wi_l, torch.where(is_metal[:, None], wi_m, wi_d))
    scale = torch.where(is_lambert[:, None], albedo,
                        torch.where(is_metal[:, None], albedo * metal_ok[:, None].to(torch.float32),
                                    torch.ones_like(albedo)))
    b = torch.where(live[:, None], beta * scale, beta)
    now = live & torch.where(is_metal, metal_ok, True)
    _f32(prev_pdf, n)[live] = torch.where(is_lambert, pdf_l, 1.0)[live]
    _bools(prev_spec, n)[live] = ~is_lambert[live]
    if roulette:
        p_cont = sampling.minimum(sampling.maximum(torch.amax(b, dim=-1), 0.05), 1.0)
        survive = ctr.uniform(rng.U_RR) < p_cont
        b = torch.where((now & survive)[:, None], b * (1.0 / p_cont)[:, None], b)
        now = now & survive
    beta[:] = b
    alive[:] = now
    ro[:] = torch.where(now[:, None], _f32(s_ro, n, 3), ro)
    rd[:] = torch.where(now[:, None], wi, rd)
    _f32(t1, n)[:] = torch.where(now, t_max, 0.0)


def _emulated_launch(calls):
    """A stand-in for build.launch that runs the two C entry points'
    contracts on the host memory the wrapper points them at; records each
    call's name."""
    fns = {"pr_pbrt_hit": _emulated_hit, "pr_pbrt_scatter": _emulated_scatter}

    def launch(fn_name, device, *args):
        assert device.type == "cpu" and args[0] > 0
        fns[fn_name](*args)
        calls.append(fn_name)

    return launch


def _to_the_kernels(monkeypatch, calls):
    """trace_pbrt takes the kernels' path on the CPU, each launch emulated;
    the RNG and the queries keep their CPU twins."""
    on_cuda = build.on_cuda
    monkeypatch.setattr(build, "on_cuda", lambda x, name: name == "pbrt" or on_cuda(x, name))
    monkeypatch.setattr(build, "launch", _emulated_launch(calls))


def _custom_tables(scene, cfg):
    """The brute tables' queries behind TraceTables.custom, with a face
    fetch function: the path of a rank's shard (dist/geometry.py)."""
    brute = integ.TraceTables(scene, cfg, "brute")
    return integ.TraceTables.custom(
        brute.face_data, brute.light_data,
        lambda ro, rd, t1: integ._closest(scene, brute, cfg, ro, rd, t1),
        lambda ro, rd, t1: integ._any_hit(scene, brute, cfg, ro, rd, t1),
        fetch_face_fn=lambda tri: brute.face_data.index_select(0, tri))


CASES = [
    # (name, metal_glass, backend, sample)
    ("cornell", False, "brute", 3),
    ("cornell_lane_samples", False, "brute", "lanes"),
    ("metal_glass", True, "brute", 2**20 - 1),
    ("metal_glass_lane_samples", True, "brute", "lanes"),
    ("fetch_face_fn", True, "custom", 5),
    ("cluster_sorted", True, "cluster", 6),
    ("cluster_sorted_lane_samples", False, "cluster", "lanes"),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_kernel_operands_on_an_emulated_launch(case, monkeypatch):
    """The wrapper's operands, run through a stand-in of the kernels'
    contract written with the eager bounce's functions: trace_pbrt on the
    kernels' path equals the eager loop bit for bit (radiance and rays
    traced) on lambert, metal and glass, int and per-lane sample ids, the
    face table gathered by the hit ids or a fetch function's rows, and the
    cluster backend with its per-query coherence sort (two suspend/resume
    rounds, so that the closest-hit query runs its sorted operands on the
    CPU too); two launches a bounce, each counted by its wrapper and as one
    pbrt_kernel, and the spans `bounce`, `nee` and `scatter` with the
    queries under the first two."""
    from pyrenderer_tpu_torch.kernels import cluster as kc

    _, metal_glass, backend, sample = case
    monkeypatch.setenv("PYRENDERER_TF_ROUNDS", "13")
    rounds = {"cluster_rounds": 2, "cluster_budget": 2} if backend == "cluster" else {}
    cfg = RenderConfig(max_bounces=7, seed=2**31 + 9, estimator="pbrt",
                       russian_roulette_start=3, cluster_sort=True, **rounds)
    scene, pixel, sample, ro, rd = _wavefront(*_cornell(metal_glass), 12, "cpu", sample, cfg.seed)
    tables = (_custom_tables(scene, cfg) if backend == "custom"
              else integ.TraceTables(scene, cfg, backend))
    perms = []
    prepare = kc._prepare

    def recording_prepare(*args):
        rays, perm = prepare(*args)
        perms.append(perm)
        return rays, perm

    monkeypatch.setattr(kc, "_prepare", recording_prepare)
    want, want_rays = ip.trace_pbrt(scene, cfg, ro, rd, pixel, sample, cfg.seed,
                                    tables=tables, with_stats=True)
    if backend == "cluster":
        assert tables.cluster_sort and perms and all(p is not None for p in perms)
    calls = []
    _to_the_kernels(monkeypatch, calls)
    pk.reset_counters()
    with profiling.recording("cpu") as rec:
        with profiling.span("pass"):
            got, rays = ip.trace_pbrt(scene, cfg, ro, rd, pixel, sample, cfg.seed,
                                      tables=tables, with_stats=True)
    assert torch.equal(got, want) and torch.equal(rays, want_rays)
    assert float(want.sum()) > 0 and rays.dtype == torch.float32
    assert calls == ["pr_pbrt_hit", "pr_pbrt_scatter"] * cfg.max_bounces
    assert pk.hit.launches == pk.scatter.launches == cfg.max_bounces
    summary = rec.summary("pass")
    assert summary["pbrt_kernel"] == 2 * cfg.max_bounces and summary["rng_kernel"] == 0
    spans = {name: s["count"] for name, s in summary["spans"].items()}
    assert {k: spans.get(k) for k in ("bounce", "nee", "scatter")} == dict.fromkeys(
        ("bounce", "nee", "scatter"), cfg.max_bounces)
    parents = {(s.name, rec.spans[s.parent].name) for s in rec.spans if s.parent is not None
               and s.name in ("nee", "scatter", "query")}
    if backend != "custom":
        assert parents == {("nee", "bounce"), ("scatter", "bounce"), ("query", "bounce"),
                           ("query", "nee")}
    pk.reset_counters()


@pytest.mark.parametrize("why", ["cpu", "float64", "grad_rays", "grad_table"])
def test_the_eager_loop_runs_off_the_kernels_path(why, monkeypatch):
    """A CPU tensor, a float64 wavefront, or rays or a face table that
    require grad under grad mode run the eager loop: with the kernel
    library and every launch refused, trace_pbrt gives the eager radiance
    and launches nothing (the last three with the device test passed as
    CUDA's)."""
    cfg = RenderConfig(max_bounces=5, seed=11, estimator="pbrt", russian_roulette_start=3)
    dtype = torch.float64 if why == "float64" else torch.float32
    scene, pixel, sample, ro, rd = _wavefront(*_cornell(True), 8, "cpu", 4, cfg.seed, dtype)
    tables = integ.TraceTables(scene, cfg, "brute")
    want = ip.trace_pbrt(scene, cfg, ro, rd, pixel, sample, cfg.seed, tables=tables)

    def refuse(*args):
        raise AssertionError("the kernels' path was taken")

    monkeypatch.setattr(build, "library", refuse)
    monkeypatch.setattr(build, "launch", refuse)
    if why != "cpu":
        on_cuda = build.on_cuda
        monkeypatch.setattr(build, "on_cuda", lambda x, name: name == "pbrt" or on_cuda(x, name))
    if why == "grad_rays":
        ro = ro.clone().requires_grad_()
    if why == "grad_table":
        tables.face_data = tables.face_data.clone().requires_grad_()
    pk.reset_counters()
    with profiling.recording("cpu") as rec:
        with profiling.span("pass"):
            got = ip.trace_pbrt(scene, cfg, ro, rd, pixel, sample, cfg.seed, tables=tables)
    assert torch.equal(got.detach(), want)
    assert got.requires_grad is why.startswith("grad")
    assert rec.summary("pass")["pbrt_kernel"] == 0 and pk.hit.launches == 0
    if why.startswith("grad"):
        with torch.no_grad():
            monkeypatch.setattr(build, "launch", _emulated_launch([]))
            got = ip.trace_pbrt(scene, cfg, ro, rd, pixel, sample, cfg.seed, tables=tables)
        assert torch.equal(got, want) and pk.hit.launches == cfg.max_bounces
    pk.reset_counters()


def _operands(n=10, device="cpu"):
    wf = pk.Wavefront.start(torch.rand(n, 3, device=device), torch.rand(n, 3, device=device),
                            torch.arange(n, device=device), 3, 1e4)
    tables = torch.rand(4, 24, device=device)
    return wf, dict(hit_mask=torch.ones(n, dtype=torch.bool, device=device),
                    tri=torch.zeros(n, dtype=torch.int32, device=device), rows=tables,
                    gather=True, light_data=torch.rand(2, 16, device=device),
                    light_nfaces=torch.full((1,), 2, device=device), f_max=2,
                    shadow_scale=0.999)


def test_wavefront_operands(monkeypatch):
    """Wavefront.start copies the rays contiguous and lays out the state
    the kernels take: an int sample folds into the counter's constant, a
    CPU scalar too, a per-lane or one-value tensor is read through its
    stride; the counter's arguments carry the seed, bounce and rounds."""
    n = 6
    ro = torch.rand(3, n).T
    wf = pk.Wavefront.start(ro, ro, torch.arange(n, dtype=torch.int32), 2**20 - 1, 1e4)
    assert wf.ro.is_contiguous() and torch.equal(wf.ro, ro) and wf.ro.data_ptr() != ro.data_ptr()
    assert wf.sample is None and wf.sample_const == 2**20 - 1
    assert torch.equal(wf.alive, torch.ones(n, dtype=torch.bool)) and torch.equal(
        wf.t1, torch.full((n,), 1e4)) and wf.n_rays.shape == ()
    args, wide = wf._operands(2**32 + 7, 3, 13)
    assert args[:4] == [n, 3, 7, 13] and args[5] == 1 and args[6] is None
    assert args[8] == ((2**20 - 1) << 12) & _U32 and wide == 0
    # one pixel for every lane; a 0-d sample on the rays' device
    wf = pk.Wavefront.start(ro, ro, torch.tensor(5).expand(n), torch.tensor(9), 1e4)
    args, wide = wf._operands(1, 0, 20)
    assert args[5] == 0 and args[7] == 0 and args[8] == 0 and wide == 3
    assert wf.sample.data_ptr() == args[6] and int(wf.sample[0]) == 9
    for sample, stride, wide_s in ((torch.arange(n), 1, 1),
                                   (torch.arange(n, dtype=torch.int32), 1, 0),
                                   (torch.arange(2 * n)[::2], 2, 1)):
        wf = pk.Wavefront.start(ro, ro, torch.arange(n), sample, 1e4)
        args, wide = wf._operands(1, 0, 20)
        assert args[6] == wf.sample.data_ptr() and args[7] == stride and args[8] == 0
        assert wide == 1 | wide_s << 1


@pytest.mark.parametrize("fault", ["device", "dtype", "layout", "rows", "tri", "nfaces"])
def test_wrapper_refuses_what_the_kernels_cannot_take(fault, monkeypatch):
    """An operand on another device, of another dtype, or not contiguous is
    refused before any launch, as are face rows too narrow, hit ids of
    another width, and light counts that do not match the light table."""
    monkeypatch.setattr(build, "launch", lambda *a: pytest.fail("launched"))
    wf, kw = _operands()
    if fault == "device":
        kw["hit_mask"] = kw["hit_mask"].to("meta")
    elif fault == "dtype":
        wf.beta = wf.beta.double()
    elif fault == "layout":
        wf.radiance = torch.zeros(3, 10).T
    elif fault == "rows":
        kw["rows"] = kw["rows"][:, :16]
    elif fault == "tri":
        kw["tri"] = kw["tri"].to(torch.int16)
    else:
        kw["f_max"] = 3
    with pytest.raises(ValueError, match="pbrt"):
        pk.hit(wf, 1, 0, 20, **kw)
    if fault not in ("dtype", "layout"):
        return
    kw["occ"] = kw.pop("hit_mask")
    for k in ("light_data", "light_nfaces", "f_max", "shadow_scale"):
        kw.pop(k)
    with pytest.raises(ValueError, match="pbrt"):
        pk.scatter(wf, 1, 0, 20, roulette=True, t_max=1e4, **kw)


# ---------------------------------------------------------- on the card

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _eager_states(monkeypatch, scene, cfg, ro, rd, pixel, sample, tables):
    """Run the eager loop on the card and keep what it holds at each
    bounce: the state at each closest query (the state after the bounce
    before) and the shadow ray and live lanes at each any-hit query, read
    from trace_pbrt's frame."""
    states, shadows = [], []
    closest, any_hit = ip._closest, ip._any_hit

    def spy_closest(*args, **kw):
        f = sys._getframe(1).f_locals
        states.append({k: f[k].clone() for k in ("ro", "rd", "beta", "radiance", "alive",
                                                  "prev_pdf", "prev_spec")})
        return closest(*args, **kw)

    def spy_any_hit(scene_, tables_, cfg_, p, wl, t1):
        f = sys._getframe(1).f_locals
        shadows.append({"s_ro": p.clone(), "s_rd": wl.clone(), "s_t1": t1.clone(),
                        "alive": f["alive"].clone()})
        return any_hit(scene_, tables_, cfg_, p, wl, t1)

    with monkeypatch.context() as m:
        m.setattr(ip, "use_bounce_kernels", lambda *a: False)
        m.setattr(ip, "_closest", spy_closest)
        m.setattr(ip, "_any_hit", spy_any_hit)
        ip.trace_pbrt(scene, cfg, ro, rd, pixel, sample, cfg.seed, tables=tables)
    return states, shadows


def _fused_bounce(scene, cfg, tables, state, pixel, sample, bounce):
    """One bounce of the kernels from an eager state: (the wavefront after
    it, its shadow ray)."""
    wf = pk.Wavefront.start(state["ro"], state["rd"], pixel, sample, cfg.t_max)
    for k in ("beta", "radiance", "alive", "prev_pdf", "prev_spec"):
        getattr(wf, k).copy_(state[k])
    wf.t1.copy_(torch.where(wf.alive, cfg.t_max, 0.0))
    faces = ip._bounce_hit(scene, tables, cfg, wf, bounce, cfg.seed)
    shadow = {"s_ro": wf.s_ro.clone(), "s_rd": wf.s_rd.clone(), "s_t1": wf.s_t1.clone()}
    occ = ip._any_hit(scene, tables, cfg, wf.s_ro, wf.s_rd, wf.s_t1)
    pk.scatter(wf, cfg.seed, bounce, rng._default_rounds(), *faces, occ,
               bounce >= cfg.russian_roulette_start, cfg.t_max)
    return wf, shadow


def _ulps(a, b):
    """Each element's distance in float32 ulps (the bit patterns' ordered
    integers; equal NaNs 0)."""
    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    d = (ordered(a) - ordered(b)).abs()
    return torch.where(torch.isnan(a) & torch.isnan(b), 0, d)


def _lane_gaps(fused, eager, shadow_f, shadow_e, mask_after_hit):
    """{output: (share of lanes not bit-equal, largest ulp gap)} over the
    lanes where each output is read: radiance, beta, ro, rd, alive and the
    shadow interval on every lane; prev_pdf and prev_spec on the lanes the
    scatter ran on (alive after the hit); the shadow ray's origin and
    direction where its interval is open."""
    out = {}
    open_ = shadow_e["s_t1"] > 0
    pairs = [(k, getattr(fused, k), eager[k], None) for k in ("radiance", "beta", "ro", "rd")]
    pairs += [("prev_pdf", fused.prev_pdf, eager["prev_pdf"], mask_after_hit),
              ("s_t1", shadow_f["s_t1"], shadow_e["s_t1"], None),
              ("s_ro", shadow_f["s_ro"], shadow_e["s_ro"], open_),
              ("s_rd", shadow_f["s_rd"], shadow_e["s_rd"], open_)]
    for name, a, b, mask in pairs:
        gap = _ulps(a, b)
        gap = gap.reshape(gap.shape[0], -1).amax(dim=1)
        if mask is not None:
            gap = gap[mask]
        out[name] = (float((gap > 0).float().mean()) if gap.numel() else 0.0,
                     int(gap.max()) if gap.numel() else 0)
    for name, a, b, mask in (("alive", fused.alive, eager["alive"], None),
                             ("prev_spec", fused.prev_spec, eager["prev_spec"], mask_after_hit)):
        diff = a != b
        if mask is not None:
            diff = diff[mask]
        out[name] = (float(diff.float().mean()), int(diff.any()))
    return out


def _check_gaps(gaps):
    """Every output bit-equal on >= 99.9% of its lanes, the rest within 4
    ulp, and alive equal on every lane."""
    assert gaps["alive"] == (0.0, 0), gaps
    for name, (share, worst) in gaps.items():
        assert share <= 1e-3 and worst <= 4, (name, gaps)


SCENES = {"cornell": lambda: _cornell(False),
          "spheres": lambda: load_tungsten(str(SPHERES))[:2]}


def _one_bounce_gaps(monkeypatch, scene_name, seed, sample, bounces=(0, 1, 4, 5)):
    """For each bounce in `bounces`: the lane gaps of one bounce of the
    kernels against the eager loop's from the same state, and whether the
    rays traced were bit-equal. 2^16 lanes (256 x 256), Russian roulette
    from bounce 4."""
    dev = _cuda()
    cfg = RenderConfig(max_bounces=max(bounces) + 2, seed=seed, estimator="pbrt",
                       russian_roulette_start=4)
    host, camera = SCENES[scene_name]()
    scene, pixel, sample, ro, rd = _wavefront(host, camera, 256, dev, sample, seed)
    tables = integ.TraceTables(scene, cfg, "cuda")
    states, shadows = _eager_states(monkeypatch, scene, cfg, ro, rd, pixel, sample, tables)
    out = {}
    for b in bounces:
        wf, shadow = _fused_bounce(scene, cfg, tables, states[b], pixel, sample, b)
        after_hit = shadows[b]["alive"]
        rays = (torch.zeros((), device=dev) + states[b]["alive"].sum(dtype=torch.float32)
                + after_hit.sum(dtype=torch.float32))
        out[b] = (_lane_gaps(wf, states[b + 1], shadow, shadows[b], after_hit),
                  torch.equal(wf.n_rays, rays))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("sample", [7, "lanes"])
@pytest.mark.parametrize("seed", [1, 2**31 + 5, 3_000_000_019])
@pytest.mark.parametrize("scene_name", ["cornell", "spheres"])
def test_one_bounce_against_the_eager_loop_on_gpu(scene_name, seed, sample, monkeypatch):
    """On the card: one bounce of the kernels (the closest query, pbrt_hit,
    the any-hit query, pbrt_scatter) from the eager loop's state at bounces
    0, 1, 4 and 5 (Russian roulette from 4) against the eager loop's next
    state, at 2^16 lanes: the Cornell box (lambert) and spheres.json (metal
    and glass), three seeds, an int and a per-lane sample id. Each output
    bit-equal on >= 99.9% of the lanes where it is read, the rest within 4
    ulp, alive on every lane, and the rays traced bit-equal."""
    for bounce, (gaps, rays_equal) in _one_bounce_gaps(
            monkeypatch, scene_name, seed, sample).items():
        print(scene_name, seed, sample, bounce, gaps)
        _check_gaps(gaps)
        assert rays_equal, bounce


@pytest.mark.cuda
def test_film_against_the_plain_reference_on_gpu(monkeypatch):
    """On the card: the harness's run of cornell.cli cut to 256 x 256, its
    films rendered by trace_pbrt on the kernels' path and judged against
    the plain pbrt reference (benchmark/reference/render_pbrt.py) by the
    cell's own limits, with the kernels launched in every bounce."""
    from benchmark import harness

    _cuda()
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.load_cell("cornell.cli", copy.deepcopy(bench))
    cell.config["resolution"] = [256, 256]
    monkeypatch.setattr(harness, "load_cell", lambda *a, **k: cell)
    pk.reset_counters()
    res = harness.run_cell("cornell.cli", 2**31 + 123, 2.0, False, device="cuda")
    assert res["correct"] is True, res["checks"]
    assert pk.hit.launches > 0 and pk.hit.launches == pk.scatter.launches
    pk.reset_counters()


@pytest.mark.cuda
@pytest.mark.parametrize("fault,old,new", [
    ("mis_off", "if (ctr.bounce != 0 && !prev_spec[i]) {", "if (false) {"),
    ("nee_off", "store3(radiance + 3 * i, add(load3(radiance + 3 * i), load3(nee + 3 * i)));",
     ";"),
])
def test_the_comparison_sees_mis_and_nee_on_gpu(fault, old, new, monkeypatch, tmp_path):
    """On the card: kernels built from a copy of csrc/ with the emission's
    MIS weight fixed at 1, or with the NEE term never added, fail the
    one-bounce comparison at bounce 1 on the Cornell box (the cell's film
    check cannot see MIS: PERF.md section 7)."""
    _cuda()
    src = tmp_path / "csrc"
    shutil.copytree(build.CSRC, src)
    text = (src / "pbrt.cu").read_text()
    assert text.count(old) == 1
    (src / "pbrt.cu").write_text(text.replace(old, new))
    monkeypatch.setattr(build, "CSRC", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "_lib", None)
    gaps, _ = _one_bounce_gaps(monkeypatch, "cornell", 2**31 + 5, 7, bounces=(1,))[1]
    print(fault, gaps)
    with pytest.raises(AssertionError):
        _check_gaps(gaps)
    assert gaps["radiance"][0] > 1e-3
