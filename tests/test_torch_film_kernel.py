"""The pass's film order (csrc/film.cu, kernels/film.py) and the one
readback of render/driver.py's uniform pass.

On the CPU: films after three passes bit for bit those built with the
expression the driver used before the film kernel (each Morton chunk's
sums unpermuted and flipped on the host), at a resolution neither square
nor a power of two with a ragged last chunk, spp_step 1 and 2, both
estimators, float32 and float64; the same through an emulated launch, a
stand-in that runs the kernel's contract in NumPy on the memory the
wrapper points it at, which counts one launch and one film_kernel a chunk
(none on the twin); the twin's contract; the wrapper's refusals;
run_resilient's guard. On the card (marked `cuda`, run with `python -m
pytest tests/test_torch_film_kernel.py -m cuda`): the kernel against its
twin bit for bit on every 2^16-lane Morton chunk of a 1024² film, in
float32 and float64; a pixel outside the film failing the launch; a
pass's one host wait and its film_kernel count."""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import textwrap
import unittest.mock as mock

import numpy as np
import pytest
import torch

from pyrenderer_tpu_torch import kernels
from pyrenderer_tpu_torch.config import RenderConfig
from pyrenderer_tpu_torch.core.camera import morton_pixel_order
from pyrenderer_tpu_torch.core.film import Film
from pyrenderer_tpu_torch.core.integrator import TraceTables, render_sample
from pyrenderer_tpu_torch.kernels import build
from pyrenderer_tpu_torch.kernels import film as fk
from pyrenderer_tpu_torch.render import driver as drv
from pyrenderer_tpu_torch.scene import load_tungsten, to_device
from pyrenderer_tpu_torch.utils import profiling

torch.set_num_threads(2)

PASSES = 3


@pytest.fixture(scope="module")
def cornell_host(cornell_path):
    host, camera, _ = load_tungsten(cornell_path)
    return host, camera


def _renderer(cornell_host, res, chunk, spp_step, estimator, device="cpu",
              dtype=torch.float32):
    host, camera = cornell_host
    scene, cam = to_device(host, camera._replace(resolution=res), device, dtype=dtype)
    cfg = RenderConfig(max_bounces=3, spp=PASSES * spp_step, spp_step=spp_step,
                       seed=2**31 + 3, estimator=estimator)
    # the whole-table kernels take float32 alone: a float64 scene on the
    # card takes the plain brute-force query
    backend = "brute" if dtype == torch.float64 and device != "cpu" else "auto"
    return drv.ProgressiveRenderer(scene, cam, cfg, backend=backend, chunk=chunk)


def _unpermuted_film(r):
    """The film of PASSES passes as the driver built it before the film
    kernel: each Morton chunk's sums (0.0 + r0 + r1 ...) and squares,
    concatenated, unpermuted and flipped on the host."""
    scene, cam, cfg = r.scene, r.camera, r.cfg
    w, h = cam.resolution
    tables = TraceTables(scene, cfg, r.backend)
    perm, inv_perm = morton_pixel_order(w, h)
    ys, xs = np.mgrid[0:h, 0:w]
    px = torch.as_tensor(xs.reshape(-1)[perm], device=r.device)
    py = torch.as_tensor(ys.reshape(-1)[perm], device=r.device)
    film = Film.blank(w, h, cfg.seed)
    for _ in range(PASSES):
        sums, sqs = [], []
        for start in range(0, w * h, r.chunk):
            total = sq = 0.0
            for s in range(cfg.spp_step):
                x = render_sample(scene, cam, cfg, cfg.seed, film.next_sample + s,
                                  px[start:start + r.chunk], py[start:start + r.chunk],
                                  tables=tables)
                total = total + x
                sq = sq + x * x
            sums.append(total)
            sqs.append(sq)
        img = np.asarray(torch.cat(sums).cpu())[inv_perm].reshape(h, w, 3)[::-1]
        sq = np.asarray(torch.cat(sqs).cpu())[inv_perm].reshape(h, w, 3)[::-1]
        film.add_pass(img, sq, cfg.spp_step)
    return film


def _assert_films_equal(got, want):
    np.testing.assert_array_equal(got.radiance_sum, want.radiance_sum)
    np.testing.assert_array_equal(got.sq_sum, want.sq_sum)
    np.testing.assert_array_equal(got.spp_map, want.spp_map)
    assert got.next_sample == want.next_sample
    assert float(want.radiance_sum.sum()) > 0


CASES = [
    # (resolution, chunk, spp_step, estimator, dtype)
    ((40, 24), 200, 1, "reference", torch.float32),
    ((40, 24), 200, 2, "reference", torch.float32),
    ((40, 24), 200, 1, "pbrt", torch.float32),
    ((40, 24), 200, 2, "pbrt", torch.float32),
    ((16, 16), 64, 1, "reference", torch.float32),
    ((7, 13), 1 << 16, 2, "pbrt", torch.float32),
    ((40, 24), 200, 2, "reference", torch.float64),
]


def _case_id(case):
    (w, h), chunk, step, est, dtype = case
    return f"{w}x{h}-chunk{chunk}-step{step}-{est}-{str(dtype)[6:]}"


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_pass_film_equals_the_unpermuted_sums(case, cornell_host):
    """After three passes on the twin, the film's sums, squares and sample
    counts are the host-unpermuted film's bit for bit; the twin served one
    call a chunk and no film_kernel is counted."""
    res, chunk, spp_step, estimator, dtype = case
    r = _renderer(cornell_host, res, chunk, spp_step, estimator, dtype=dtype)
    kernels.reset_counters()
    with profiling.recording("cpu") as rec:
        for _ in range(PASSES):
            r.render_one_pass()
    launches, twins = kernels.counts()
    kernels.reset_counters()
    assert "film" not in launches and twins["film"] == -(-res[0] * res[1] // chunk) * PASSES
    _assert_films_equal(r.film, _unpermuted_film(r))
    summary = rec.summary("pass")
    assert summary["film_kernel"] == 0 and summary["units"] == PASSES


# ------------------------------------------------- the emulated launch

_TYPES = {0: (ctypes.c_float, np.float32), 1: (ctypes.c_double, np.float64)}


def _mem(ctype, dt, ptr, n):
    """n values of C type `ctype` at address `ptr`, as an array sharing the
    memory (writes land where the wrapper pointed)."""
    return np.frombuffer((ctype * n).from_address(ptr), dt)


def _emulated_film(n, sums, sqs, px, py, w, h, f64, out):
    """film_kernel's contract in NumPy, lane by lane in one vectorised step
    (the lanes are distinct pixels inside the film)."""
    ct, dt = _TYPES[f64]
    s = _mem(ct, dt, sums, 3 * n).reshape(n, 3)
    q = _mem(ct, dt, sqs, 3 * n).reshape(n, 3)
    x = _mem(ctypes.c_int64, np.int64, px, n)
    y = _mem(ctypes.c_int64, np.int64, py, n)
    assert ((x >= 0) & (x < w) & (y >= 0) & (y < h)).all()
    film = _mem(ct, dt, out, 2 * h * w * 3).reshape(2, h * w, 3)
    at = (h - 1 - y) * w + x
    film[0, at] = dt(0) + s
    film[1, at] = dt(0) + q


def _to_the_kernel(monkeypatch, calls):
    """The film wrapper takes the kernel's path on the CPU, each launch
    emulated; every other wrapper keeps its twin."""
    on_cuda = build.on_cuda
    monkeypatch.setattr(build, "on_cuda", lambda x, name: name == "film" or on_cuda(x, name))

    def launch(fn_name, device, *args):
        assert fn_name == "pr_film" and device.type == "cpu" and args[0] > 0
        _emulated_film(*args)
        calls.append(args[7])

    monkeypatch.setattr(build, "launch", launch)


@pytest.mark.parametrize("case", [c for c in CASES if c[0] == (40, 24)], ids=_case_id)
def test_pass_film_on_an_emulated_launch(case, cornell_host, monkeypatch):
    """The wrapper's operands, run through the kernel's contract: the film
    after three passes is the host-unpermuted film's bit for bit; one
    launch a chunk, whatever spp_step, in the pass's precision, each
    counted in the wrapper and as one film_kernel under the pass's chunk."""
    res, chunk, spp_step, estimator, dtype = case
    r = _renderer(cornell_host, res, chunk, spp_step, estimator, dtype=dtype)
    want = _unpermuted_film(r)
    calls = []
    _to_the_kernel(monkeypatch, calls)
    kernels.reset_counters()
    with profiling.recording("cpu") as rec:
        for _ in range(PASSES):
            r.render_one_pass()
    launches, twins = kernels.counts()
    kernels.reset_counters()
    _assert_films_equal(r.film, want)
    chunks = -(-res[0] * res[1] // chunk)
    assert calls == [int(dtype == torch.float64)] * chunks * PASSES
    assert launches["film"] == chunks * PASSES and "film" not in twins
    assert rec.summary("pass")["film_kernel"] == chunks
    assert all(s.counts.get("film_kernel", 0) == 1 for s in rec.spans if s.name == "chunk")


def _operands(dtype, g):
    """A 5 x 7 film's staging tensor of noise and four lanes' sums and
    squares (a -0 among the sums) at distinct pixels."""
    h, w = 5, 7
    px = torch.tensor([0, 6, 3, 2])
    py = torch.tensor([0, 4, 2, 0])
    sums = (torch.randn(4, 3, generator=g) * 1e3).to(dtype)
    sums[0] = -0.0
    sqs = sums * sums
    out = torch.randn(2, h, w, 3, generator=g).to(dtype)
    return out, sums, sqs, px, py


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_twin_contract(dtype):
    """The twin writes 0 + sum and 0 + square (a -0 turns +0) at (H - 1 -
    y) * W + x of each plane and leaves the other pixels; the emulated
    kernel does the same bits."""
    start, sums, sqs, px, py = _operands(dtype, torch.Generator().manual_seed(3))
    _, h, w, _ = start.shape
    out = start.clone()
    fk.write_ref(out, sums, sqs, px, py)
    want = start.clone()
    for i in range(4):
        y, x = h - 1 - int(py[i]), int(px[i])
        want[0, y, x] = 0.0 + sums[i]
        want[1, y, x] = 0.0 + sqs[i]
    bits = torch.int32 if dtype == torch.float32 else torch.int64
    assert torch.equal(out.view(bits), want.view(bits))
    assert (out[0, h - 1, 0].view(bits) == 0).all()
    emulated = start.clone()
    _emulated_film(4, sums.data_ptr(), sqs.data_ptr(), px.data_ptr(), py.data_ptr(), w, h,
                   int(dtype == torch.float64), emulated.data_ptr())
    assert torch.equal(emulated.view(bits), out.view(bits))


@pytest.mark.parametrize("where", ["x_negative", "x_past_the_width", "y_negative",
                                   "y_past_the_height"])
def test_a_pixel_outside_the_film_raises(where):
    """A lane whose pixel lies outside the film raises in the wrapper's twin
    path before anything is written (the kernel stops with a trap there)."""
    out, sums, sqs, px, py = _operands(torch.float32, torch.Generator().manual_seed(5))
    _, h, w, _ = out.shape
    axis, value = {"x_negative": (px, -1), "x_past_the_width": (px, w),
                   "y_negative": (py, -1), "y_past_the_height": (py, h)}[where]
    axis[2] = value
    keep = out.clone()
    with pytest.raises(ValueError, match="outside the 7 x 5 film"):
        fk.write(out, sums, sqs, px, py)
    assert torch.equal(out, keep)


@pytest.mark.parametrize("bad", ["out_shape", "out_dtype", "out_half", "pixels_shape",
                                 "pixels_int32", "sums_shape", "sums_dtype",
                                 "out_not_contiguous"])
def test_wrapper_refuses(bad):
    """Operands the pass cannot take raise before anything is written."""
    out = torch.zeros(2, 4, 4, 3)
    sums, px, py = torch.ones(3, 3), torch.tensor([0, 1, 2]), torch.tensor([0, 1, 2])
    sqs = sums.clone()
    if bad == "out_shape":
        out = torch.zeros(4, 4, 3)
    elif bad == "out_dtype":
        out = out.double()
    elif bad == "out_half":
        out, sums, sqs = out.half(), sums.half(), sqs.half()
    elif bad == "pixels_shape":
        px = px[:2]
    elif bad == "pixels_int32":
        py = py.int()
    elif bad == "sums_shape":
        sums = torch.ones(3, 4)
    elif bad == "sums_dtype":
        sqs = sqs.double()
    else:
        out = torch.zeros(2, 4, 3, 4).transpose(2, 3)
    keep = out.clone()
    with pytest.raises(ValueError, match="film: "):
        fk.write(out, sums, sqs, px, py)
    assert torch.equal(out, keep)


def test_run_resilient_rejects_a_nonfinite_pass_before_the_film(cornell_host):
    """A NaN radiance in one lane of the second pass's first chunk reaches
    the staging tensor through the film path; run_resilient's guard rejects
    that pass before the film absorbs it, the retry renders it again, and
    the film ends bit-identical to a clean render's."""
    clean = _renderer(cornell_host, (40, 24), 200, 1, "reference")
    clean.run(quiet=True)
    r = _renderer(cornell_host, (40, 24), 200, 1, "reference")
    calls = {"n": 0}
    chunks = -(-40 * 24 // 200)

    def poisoned(*args, **kw):
        x, n = render_sample(*args, **kw)
        calls["n"] += 1
        if calls["n"] == chunks + 1:
            x = x.clone()
            x[5, 2] = torch.nan
        return x, n

    absorbed = []
    add_pass = r.film.add_pass

    def spy(img, sq, n_samples):
        absorbed.append(bool(np.isfinite(img).all() and np.isfinite(sq).all()))
        add_pass(img, sq, n_samples)

    r.film.add_pass = spy
    with mock.patch.object(drv, "render_sample", poisoned):
        film = r.run_resilient(max_retries=2, backoff=0.01, quiet=True)
    assert calls["n"] == chunks * (PASSES + 1) and absorbed == [True] * PASSES
    _assert_films_equal(film, clean.film)
    assert r.rays_traced == clean.rays_traced


# ---------------------------------------------------------- on the card

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_equals_twin_on_gpu(dtype):
    """Every 2^16-lane Morton chunk of a 1024² film, written by the kernel
    and by its twin from the same sums and squares (random values over
    many magnitudes, negative zeros, zeros, infinities and a NaN): the
    staging tensors' bits are equal after each launch, NaNs at the same
    places; each launch counts once in the wrapper and as one film_kernel."""
    dev = _cuda()
    w = h = 1024
    perm, _ = morton_pixel_order(w, h)
    ys, xs = np.mgrid[0:h, 0:w]
    px = torch.as_tensor(xs.reshape(-1)[perm], device=dev)
    py = torch.as_tensor(ys.reshape(-1)[perm], device=dev)
    g = torch.Generator(device=dev).manual_seed(11)
    got = torch.full((2, h, w, 3), 7.0, device=dev, dtype=dtype)
    want = got.clone()
    bits = torch.int32 if dtype == torch.float32 else torch.int64
    chunk = 1 << 16
    kernels.reset_counters()
    for start in range(0, w * h, chunk):
        n = min(chunk, w * h - start)
        scale = torch.exp2(torch.randint(-40, 40, (n, 1), device=dev, generator=g).to(dtype))
        sums = torch.randn(n, 3, device=dev, generator=g, dtype=dtype) * scale
        sums[:64] = -0.0
        sums[64:128] = 0.0
        sums[128, 0], sums[129, 1], sums[130, 2] = torch.inf, -torch.inf, torch.nan
        sqs = sums * sums
        with profiling.recording(dev) as rec:
            fk.write(got, sums, sqs, px[start:start + n], py[start:start + n])
        assert rec.counters.get("film_kernel") == 1
        fk.write_ref(want, sums, sqs, px[start:start + n], py[start:start + n])
        torch.cuda.synchronize()
        # a NaN's payload is the adder's: compare where it is, then bits
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan), start
        assert torch.equal(got.view(bits)[~nan], want.view(bits)[~nan]), start
    assert kernels.counts() == ({"film": w * h // chunk}, {})
    kernels.reset_counters()


@pytest.mark.cuda
def test_kernel_traps_on_a_pixel_outside_the_film():
    """A lane outside the film stops the kernel: in a process of its own
    (the failed launch spoils the process's CUDA context), the launch or
    the next wait for the device raises."""
    _cuda()
    code = textwrap.dedent("""
        import torch
        from pyrenderer_tpu_torch.kernels import film
        dev = torch.device("cuda")
        out = torch.zeros(2, 4, 4, 3, device=dev)
        try:
            film.write(out, torch.ones(3, 3, device=dev), torch.ones(3, 3, device=dev),
                       torch.tensor([0, 1, 4], device=dev), torch.tensor([0, 1, 1], device=dev))
            torch.cuda.synchronize()
        except RuntimeError as e:
            print("raised:", str(e).splitlines()[0])
            raise SystemExit(3)
        print("no error")
    """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=root, env=dict(os.environ, PYTHONPATH=root))
    assert res.returncode == 3 and "raised:" in res.stdout, (res.stdout, res.stderr[-2000:])


@pytest.mark.cuda
@pytest.mark.parametrize("estimator, spp_step, dtype", [
    ("reference", 1, torch.float32), ("pbrt", 2, torch.float32),
    ("reference", 1, torch.float64)])
def test_pass_on_gpu_waits_once(estimator, spp_step, dtype, cornell_host):
    """A recorded pass on the card at 256² in 2^14-lane chunks: one film
    launch a chunk in float32 and float64, none served by the twin, and
    one host wait under `readback` (the copy into pinned memory); in
    float32, where the bounce runs as kernels, the pass's only one. After
    three passes the film is the host-unpermuted film's bit for bit."""
    dev = _cuda()
    r = _renderer(cornell_host, (256, 256), 1 << 14, spp_step, estimator, device=dev,
                  dtype=dtype)
    assert r._host.is_pinned()
    r.render_one_pass()
    kernels.reset_counters()
    with profiling.recording(dev) as rec:
        r.render_one_pass()
    launches, twins = kernels.counts()
    kernels.reset_counters()
    summary = rec.summary("pass")
    assert summary["film_kernel"] == 4
    assert launches["film"] == 4 and "film" not in twins
    assert [s.syncs for s in rec.spans if s.name == "readback"] == [1]
    if dtype == torch.float32:
        assert summary["syncs"] == 1
        assert [s.name for s in rec.spans if s.syncs] == ["readback"]
    r.render_one_pass()
    _assert_films_equal(r.film, _unpermuted_film(r))
