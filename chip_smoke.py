"""Smoke run of pyrenderer_tpu_torch on one NVIDIA GPU: build, check, render, time.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

0. Environment: requires a CUDA device; prints the card's name and power
   limit (nvidia-smi), the torch and CUDA versions.
1. Build: compiles csrc/*.cu with nvcc for sm_90a (kernels/build.py) and
   prints the build time and ptxas's register/shared-memory report.
2. Each kernel against its plain PyTorch twin on the card, at the main
   path's shapes (65,536 rays against the 36 Cornell triangles): random
   rays, real camera rays, rays with dead lanes (t1 = 0), and a ragged
   N = 100, with scalar and per-ray t1.
3. The main path through the CLI entry point: the Cornell box, reference
   estimator, 1024x1024, 4 bounces, 16 spp on cuda:0. Checks the PNG and
   EXR, a finite HDR, exactly 16 passes x 16 chunks x 4 bounces launches of
   each kernel, and no call of a plain twin.
4. GPU against CPU: render_image at 64x64 (2 spp, 4 bounces, seed 3) on the
   card and with the CPU twins; then the mean radiance at 160x160
   (32 spp, 8 bounces, seed 1) against the JAX package's CPU value.
5. Timings: each kernel and its twin on the card (median of CUDA-event
   timings), and the phase-3 frame in Mrays/s, counted as bench.py counts.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. No result is printed when a
phase fails or when no CUDA device is present.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SCENE = os.path.join(ROOT, "scenes", "cornell_box.json")
N_RAYS = 1 << 16
T0 = 1e-5
T_MAX = 99999.9

# Mean radiance of the Cornell box at 160x160, 32 spp, 8 bounces, seed 1,
# "reference" estimator, float32: pyrenderer_tpu.core.integrator.render_image
# on the CPU (JAX 0.9.0).
JAX_MEAN_RADIANCE_160 = 0.10746552795171738
MEAN_TOL = 1e-3

KERNEL_SOURCE = "pyrenderer_tpu_torch/csrc/intersect.cu"
REPLACES = {
    "closest_hit": "pyrenderer_tpu/kernels/pallas_intersect.py:80",
    "occluded": "pyrenderer_tpu/kernels/pallas_intersect.py:111",
}


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of fn() over `reps` CUDA-event-timed calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def random_rays(n, seed, dev):
    """Rays inside the Cornell box, as tests/test_pallas.py makes them."""
    rs = np.random.RandomState(seed)
    ro = rs.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    ro[:, 1] += 1.0
    rd = rs.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return torch.as_tensor(ro, device=dev), torch.as_tensor(rd, device=dev)


def compare_kernels(ki, table, ro, rd, t1, label):
    """Kernel against twin on the card; returns the max absolute differences
    (closest-hit t, occluded flag) over all rays."""
    hit, t, tri = ki.closest_hit(table, ro, rd, T0, t1)
    occ = ki.occluded(table, ro, rd, T0, t1)
    torch.cuda.synchronize()
    hit_r, t_r, tri_r = ki.closest_hit_ref(table, ro, rd, T0, t1)
    occ_r = ki.occluded_ref(table, ro, rd, T0, t1)
    check(torch.equal(hit, hit_r), f"{label}: hit masks differ")
    check(bool((tri[~hit] == -1).all()) and bool((t[~hit] == 0).all()),
          f"{label}: miss contract (tri=-1, t=0) broken")
    n_hit = int(hit.sum())
    same = (tri == tri_r) & hit
    n_same = int(same.sum())
    frac = n_same / max(n_hit, 1)
    check(frac >= 0.995, f"{label}: faces equal on {n_same}/{n_hit} hits")
    torch.testing.assert_close(t[same], t_r[same], rtol=1e-5, atol=0.0)
    check(torch.equal(occ, occ_r), f"{label}: occluded differs")
    err_t = float((t - t_r).abs().max())
    err_occ = float((occ.float() - occ_r.float()).abs().max())
    print(f"{label}: n={ro.shape[0]} hits={n_hit} faces equal {n_same}/{n_hit} "
          f"max|dt|={err_t:.3g} occluded={int(occ.sum())} (equal)", flush=True)
    return np.array([err_t, err_occ])


def main() -> int:
    phase("0 environment")
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = card_line()
    print(card)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}", flush=True)
    dev = torch.device("cuda:0")

    from pyrenderer_tpu_torch.kernels import build
    from pyrenderer_tpu_torch.kernels import intersect as ki

    phase("1 build")
    t = time.perf_counter()
    lib = build.build()
    build.library()
    print(f"built {os.path.relpath(lib, ROOT)} in {time.perf_counter() - t:.2f} s "
          f"(nvcc {' '.join(build.NVCC_FLAGS)})")
    print(build.build_log().strip(), flush=True)

    from pyrenderer_tpu_torch.config import RenderConfig
    from pyrenderer_tpu_torch.core.camera import generate_rays, morton_pixel_order
    from pyrenderer_tpu_torch.core.integrator import render_image
    from pyrenderer_tpu_torch.render import cli
    from pyrenderer_tpu_torch.scene import load_tungsten, to_device
    from pyrenderer_tpu_torch.utils.exr import read_exr

    host_scene, host_camera, _ = load_tungsten(SCENE)
    scene, camera = to_device(host_scene, host_camera, dev)
    table = ki.pack_triangles(scene.vertices, scene.faces)
    n_tris = table.shape[1]

    phase(f"2 kernels against twins on the card ({N_RAYS} rays x {n_tris} triangles)")
    err = np.zeros(2)
    ro, rd = random_rays(N_RAYS, 0, dev)
    err = np.maximum(err, compare_kernels(ki, table, ro, rd, T_MAX, "random, scalar t1"))
    lanes = torch.arange(N_RAYS, device=dev)
    t1_dead = torch.where(lanes % 3 == 0, 0.0, T_MAX).float().contiguous()
    err = np.maximum(err, compare_kernels(ki, table, ro, rd, t1_dead, "random, dead lanes t1=0"))
    hit_dead, _, _ = ki.closest_hit(table, ro, rd, T0, t1_dead)
    check(not bool(hit_dead[lanes % 3 == 0].any()), "a dead lane (t1=0) hit")
    w, h = host_camera.resolution
    perm, _ = morton_pixel_order(w, h)
    ys, xs = np.mgrid[0:h, 0:w]
    px = torch.as_tensor(xs.reshape(-1)[perm][:N_RAYS], device=dev)
    py = torch.as_tensor(ys.reshape(-1)[perm][:N_RAYS], device=dev)
    cro, crd = generate_rays(camera, px, py, 0, 0)
    err = np.maximum(err, compare_kernels(ki, table, cro.contiguous(), crd.contiguous(),
                                   T_MAX, "camera rays, scalar t1"))
    t1_half = torch.full((N_RAYS,), 0.5, device=dev)
    err = np.maximum(err, compare_kernels(ki, table, ro, rd, t1_half, "random, per-ray t1=0.5"))
    rro, rrd = random_rays(100, 4, dev)
    err = np.maximum(err, compare_kernels(ki, table, rro, rrd, T_MAX, "ragged N=100, scalar t1"))
    err = np.maximum(err, compare_kernels(ki, table, rro, rrd, t1_half[:100].contiguous(),
                                   "ragged N=100, per-ray t1"))
    max_abs_err = {"closest_hit": float(err[0]), "occluded": float(err[1])}

    phase("3 main path: CLI, cornell_box.json, reference, 1024x1024, 4 bounces, 16 spp")
    spp, depth, res, chunk = 16, 4, 1024, 1 << 16
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "cornell.png")
        exr = os.path.join(tmp, "cornell.exr")
        argv = [SCENE, "--estimator", "reference", "--depth", str(depth),
                "--spp", str(spp), "--res", str(res), str(res),
                "--out", png, "--hdr-out", exr]
        torch.cuda.synchronize()
        ki.reset_counters()
        rc, log = run_cli(cli, argv)
        launches = {"closest_hit": ki.closest_hit.launches,
                    "occluded": ki.occluded.launches}
        twins = ki.closest_hit.twin_calls + ki.occluded.twin_calls
        check(rc == 0, f"cli.main returned {rc}")
        check(os.path.getsize(png) > 0 and os.path.getsize(exr) > 0, "outputs missing")
        hdr = read_exr(exr)
    check(hdr.shape == (res, res, 3), f"HDR shape {hdr.shape}")
    check(bool(np.isfinite(hdr).all()), "HDR has non-finite values")
    expect = spp * ((res * res + chunk - 1) // chunk) * depth
    print(f"launches {launches} (expected {expect} each), twin calls {twins}, "
          f"HDR mean {float(hdr.mean()):.6f}", flush=True)
    for name, n in launches.items():
        check(n == expect, f"{name} launched {n} times, expected {expect}")
    check(twins == 0, f"{twins} twin calls during the GPU render")
    m = re.search(r"(\d+) rays in ([0-9.]+) s = ([0-9.]+) Mrays/s", log)
    check(m is not None, "the CLI printed no ray count")
    rays, secs = int(m.group(1)), float(m.group(2))

    phase("4 GPU against CPU")
    cfg = RenderConfig(max_bounces=4, spp=2, seed=3, estimator="reference")
    cam64 = host_camera._replace(resolution=(64, 64))
    s_gpu, c_gpu = to_device(host_scene, cam64, dev)
    s_cpu, c_cpu = to_device(host_scene, cam64, "cpu")
    img_gpu = render_image(s_gpu, c_gpu, cfg).cpu().numpy()
    img_cpu = render_image(s_cpu, c_cpu, cfg).numpy()
    close = float(np.isclose(img_gpu, img_cpu, rtol=1e-3, atol=1e-4).mean())
    med = float(np.median(np.abs(img_gpu - img_cpu)))
    print(f"64x64: close fraction {close:.6f} (> 0.95), median |diff| {med:.3g} (< 1e-5)")
    check(close > 0.95 and med < 1e-5, "GPU and CPU images disagree")
    cfg160 = RenderConfig(max_bounces=8, spp=32, seed=1, estimator="reference")
    s160, c160 = to_device(host_scene, host_camera._replace(resolution=(160, 160)), dev)
    mean = float(render_image(s160, c160, cfg160).mean())
    print(f"160x160 mean radiance {mean!r}, JAX CPU {JAX_MEAN_RADIANCE_160!r}, "
          f"|diff| {abs(mean - JAX_MEAN_RADIANCE_160):.3g} (<= {MEAN_TOL})", flush=True)
    check(abs(mean - JAX_MEAN_RADIANCE_160) <= MEAN_TOL, "mean radiance off")

    phase(f"5 timings on {card}")
    ms = {
        "closest_hit": cuda_ms(lambda: ki.closest_hit(table, ro, rd, T0, t1_dead)),
        "occluded": cuda_ms(lambda: ki.occluded(table, ro, rd, T0, t1_dead)),
    }
    plain_ms = {
        "closest_hit": cuda_ms(lambda: ki.closest_hit_ref(table, ro, rd, T0, t1_dead)),
        "occluded": cuda_ms(lambda: ki.occluded_ref(table, ro, rd, T0, t1_dead)),
    }
    for name in ms:
        print(f"{name}: kernel {ms[name]:.4f} ms, plain {plain_ms[name]:.4f} ms "
              f"({N_RAYS} rays x {n_tris} tris, {card})")
    print(f"frame: {rays} rays in {secs:.3f} s = {rays / secs / 1e6:.3f} Mrays/s "
          f"(1024x1024, 16 spp, 4 bounces, {card})", flush=True)

    print(card)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": max_abs_err[name], "ms": ms[name], "plain_ms": plain_ms[name]}
        for name in ("closest_hit", "occluded")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run_cli(cli, argv):
    """cli.main(argv) in-process; returns (exit code, its stderr), echoing it."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stderr(buf):
        rc = cli.main(argv)
    sys.stderr.write(buf.getvalue())
    return rc, buf.getvalue()


if __name__ == "__main__":
    sys.exit(main())
