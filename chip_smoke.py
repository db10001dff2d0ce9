"""Smoke run of pyrenderer_tpu_torch on one NVIDIA GPU: build, check, render, time.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

0. Environment: requires a CUDA device; prints the card's name and power
   limit (nvidia-smi), the torch and CUDA versions.
1. Build: compiles csrc/*.cu with nvcc for sm_90a (kernels/build.py, one
   nvcc per source, in parallel) and prints the build time and ptxas's
   register/shared-memory report.
2. Each whole-table kernel against its plain PyTorch twin on the card, at
   the Cornell path's shapes (65,536 rays against the 36 triangles):
   random rays, real camera rays, rays with dead lanes (t1 = 0), and a
   ragged N = 100, with scalar and per-ray t1.
3. The Cornell path through the CLI entry point: reference estimator,
   1024x1024, 4 bounces, 16 spp on cuda:0. Checks the PNG and EXR, a finite
   HDR, exactly 16 passes x 16 chunks x 4 bounces launches of each
   whole-table kernel, and no call of a plain twin.
4. GPU against CPU: render_image at 64x64 (2 spp, 4 bounces, seed 3) on the
   card and with the CPU twins; then the mean radiance at 160x160
   (32 spp, 8 bounces, seed 1) against the JAX package's CPU value.
5. Timings: each whole-table kernel and its twin on the card (median of
   CUDA-event timings), and the phase-3 frame in Mrays/s, counted as
   bench.py counts.
6. Each cluster-sweep kernel against its twin on the card, at the
   terrain100k tables (100,364 triangles, 785 clusters padded to 800):
   65,536 random rays, camera rays, the integrator's real bounce-1
   wavefront and its NEE shadow rays, dead lanes, per-ray t1 and a ragged
   N = 100, each with Moeller-Trumbore and watertight leaves, sort off and
   on; then the shared-edge leak hunt (4,096 rays) through the watertight
   kernels.
7. The large-scene path through ProgressiveRenderer: terrain100k,
   reference estimator, 512x512, 4 spp, 4 bounces, chunks of 2^16,
   cluster_sort and cluster_watertight on "auto" (both resolve to on).
   Checks a finite HDR, exactly 4 passes x 4 chunks x 4 bounces launches of
   each cluster kernel, no twin call and no whole-table launch; prints
   Mrays/s.
8. GPU against references: the terrain8k image (32x32, 2 spp) on the card
   and with the CPU twins, with MT and with watertight leaves; the
   terrain100k mean radiance (32x32, 2 spp, 4 bounces, seed 0) against the
   JAX package's CPU value.
9. Timings: each cluster kernel and its twin on the bounce-1 wavefront at
   terrain100k (median of CUDA-event timings).
10. The four binned kernels against their twins on the card at terrain100k
   (200 bins of 512 triangles, 224 box rows), on phase 6's ray sets, with
   W at its default and at 1 (overflow and peel rounds), MT and watertight
   leaves: prepass and peel bit for bit, each leaf's per-pair (t, slot) key
   bit for bit; then the public binned closest_hit / occluded, resident and
   streamed, against phase 6's sweep-twin results (equal hit masks and
   occlusion, faces >= 0.999); the leak hunt through the binned watertight
   path.
11. The binned path through ProgressiveRenderer: phase 7's frame with
   backend "cluster_binned" and with "cluster_streamed". Checks a finite
   HDR, at least 4 passes x 4 chunks x 4 bounces x 2 queries launches of
   the prepass and of the path's leaf kernel, at least one launch of its
   overflow stage (the sweep, or the peel), no twin call and no
   whole-table launch, and the HDR against phase 7's "cluster" frame (close
   > 0.999 at rtol 1e-3, median |diff| 0); prints the three frames' Mrays/s.
   Then one CLI render with --backend cluster_binned (Cornell, 64x64).
12. Timings on the bounce-1 wavefront: each binned kernel alone and its
   twin, and the binned wrappers (glue included) against the sweep's.

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

# Mean radiance of the terrain100k scene (scene/procgen.py
# big_scene_data("terrain", res=224)) at 32x32, 2 spp, 4 bounces, seed 0,
# "reference" estimator, float32, watertight leaves (cluster_watertight
# "auto"): pyrenderer_tpu.core.integrator.render_image(..., backend="cluster")
# on the CPU (JAX 0.9.0), i.e.
#   scene, camera, _ = build_scene(big_scene_data("terrain", res=224))
#   render_image(jax.tree.map(jnp.asarray, scene),
#                camera._replace(resolution=(32, 32)),
#                RenderConfig(max_bounces=4, spp=2, seed=0,
#                             estimator="reference"), backend="cluster").mean()
JAX_MEAN_RADIANCE_TERRAIN100K = 0.044580455869436264

# name -> (source, TPU kernel it replaces)
KERNELS = {
    "closest_hit": ("pyrenderer_tpu_torch/csrc/intersect.cu",
                    "pyrenderer_tpu/kernels/pallas_intersect.py:80"),
    "occluded": ("pyrenderer_tpu_torch/csrc/intersect.cu",
                 "pyrenderer_tpu/kernels/pallas_intersect.py:111"),
    "cluster_closest_hit": ("pyrenderer_tpu_torch/csrc/cluster.cu",
                            "pyrenderer_tpu/kernels/pallas_cluster.py:449"),
    "cluster_occluded": ("pyrenderer_tpu_torch/csrc/cluster.cu",
                         "pyrenderer_tpu/kernels/pallas_cluster.py:577"),
    "binned_prepass": ("pyrenderer_tpu_torch/csrc/binned.cu",
                       "pyrenderer_tpu/kernels/pallas_binned.py:167"),
    "binned_peel": ("pyrenderer_tpu_torch/csrc/binned.cu",
                    "pyrenderer_tpu/kernels/pallas_binned.py:216"),
    "binned_leaf": ("pyrenderer_tpu_torch/csrc/binned.cu",
                    "pyrenderer_tpu/kernels/pallas_binned.py:236"),
    "binned_leaf_streamed": ("pyrenderer_tpu_torch/csrc/binned.cu",
                             "pyrenderer_tpu/kernels/pallas_binned.py:439"),
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


def cuda_ms_pair(kernel_fn, twin_fn, reps=20, twin_reps=3):
    """(kernel ms, twin ms): medians of CUDA-event timings, in turns
    twin, kernel, kernel, twin so that drift of the card shows in neither
    alone."""
    twin_a = cuda_ms(twin_fn, reps=twin_reps, warmup=1)
    kern_a = cuda_ms(kernel_fn, reps=reps)
    kern_b = cuda_ms(kernel_fn, reps=reps)
    twin_b = cuda_ms(twin_fn, reps=twin_reps, warmup=1)
    return float(np.median([kern_a, kern_b])), float(np.median([twin_a, twin_b]))


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
    from pyrenderer_tpu_torch.kernels import cluster as kc
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
        kc.reset_counters()
        rc, log = run_cli(cli, argv)
        launches = {"closest_hit": ki.closest_hit.launches,
                    "occluded": ki.occluded.launches}
        twins = ki.closest_hit.twin_calls + ki.occluded.twin_calls
        cluster_calls = (kc.closest_hit.launches + kc.occluded.launches
                         + kc.closest_hit.twin_calls + kc.occluded.twin_calls)
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
    check(cluster_calls == 0, "the Cornell path reached the cluster sweep")
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

    large, ctx = large_scene_phases(dev, card)
    binned = binned_phases(dev, card, ctx)
    for entries in (large, binned):
        launches.update(entries["launches"])
        max_abs_err.update(entries["max_abs_err"])
        ms.update(entries["ms"])
        plain_ms.update(entries["plain_ms"])

    print(card)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[name], "max_abs_err": max_abs_err[name],
         "ms": ms[name], "plain_ms": plain_ms[name]}
        for name, (source, replaces) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def compare_cluster(kc, cl, cs, ro, rd, t1, label, refs):
    """Both cluster kernels against their twins on one ray set, with MT and
    watertight leaves, sort off and on; returns the max absolute
    differences (closest-hit t, occluded flag) over all of them. The ray
    set and the twin's results go into refs[label] for phase 10."""
    err = np.zeros(2)
    refs[label] = {"rays": (ro, rd, t1)}
    for wt in (False, True):
        hit_r, t_r, slot_r = cl.closest_hit_ref(cs, ro, rd, T0, t1, watertight=wt)
        refs[label][wt] = (hit_r, t_r, slot_r)
        face_r = cl.slot_to_face(cs, slot_r).to(torch.int32)
        occ_r = cl.occluded_ref(cs, ro, rd, T0, t1, watertight=wt)
        for sort in (False, True):
            tag = f"{label}, {'watertight' if wt else 'MT'}, sort {'on' if sort else 'off'}"
            hit, t, face = kc.closest_hit(cs, ro, rd, T0, t1, sort=sort,
                                          watertight=wt, exact_t=False)
            occ = kc.occluded(cs, ro, rd, T0, t1, sort=sort, watertight=wt)
            torch.cuda.synchronize()
            check(torch.equal(hit, hit_r), f"{tag}: hit masks differ")
            n_hit = int(hit.sum())
            same = (face == face_r) & hit
            n_same = int(same.sum())
            check(n_same >= 0.999 * n_hit, f"{tag}: faces equal on {n_same}/{n_hit} hits")
            torch.testing.assert_close(t[same], t_r[same], rtol=1e-5, atol=0.0)
            check(torch.equal(occ, occ_r), f"{tag}: occluded differs")
            err_t = float((t - t_r).abs().max()) if t.numel() else 0.0
            err = np.maximum(err, [err_t, float((occ != occ_r).any())])
            print(f"{tag}: n={ro.shape[0]} hits={n_hit} faces equal {n_same}/{n_hit} "
                  f"max|dt|={err_t:.3g} occluded={int(occ.sum())} (equal)", flush=True)
    return err


def integrator_wavefronts(scene, camera, tables, cfg, px, py):
    """The integrator's real bounce-1 wavefront: the (ro, rd, t1) of the
    second closest-hit query and of the second shadow query that
    render_sample makes, recorded on their way to the kernel wrappers."""
    import types

    from pyrenderer_tpu_torch.core import integrator

    kc = integrator.cluster_kernels
    calls = {"closest_hit": [], "occluded": []}

    def recorder(name):
        def record(cs, ro, rd, t0, t1, **kw):
            calls[name].append((ro, rd, t1))
            return getattr(kc, name)(cs, ro, rd, t0, t1, **kw)
        return record

    integrator.cluster_kernels = types.SimpleNamespace(
        **{name: recorder(name) for name in calls})
    try:
        integrator.render_sample(scene, camera, cfg.replace(max_bounces=2),
                                 cfg.seed, 0, px, py, tables=tables)
    finally:
        integrator.cluster_kernels = kc
    return calls["closest_hit"][1], calls["occluded"][1]


def large_scene_phases(dev, card):
    """Phases 6-9 (the terrain100k cluster path); returns the kernel-line
    entries of the two cluster kernels, and what the binned phases reuse:
    the scene, the ray sets with their sweep-twin results, and phase 7's
    frame."""
    from pyrenderer_tpu_torch.accel import clusters as cl
    from pyrenderer_tpu_torch.config import RenderConfig
    from pyrenderer_tpu_torch.core.camera import generate_rays, morton_pixel_order
    from pyrenderer_tpu_torch.core.integrator import TraceTables, render_image
    from pyrenderer_tpu_torch.kernels import cluster as kc
    from pyrenderer_tpu_torch.kernels import intersect as ki
    from pyrenderer_tpu_torch.render.driver import ProgressiveRenderer
    from pyrenderer_tpu_torch.scene import procgen, to_device
    from pyrenderer_tpu_torch.scene.tungsten import build_scene

    host, host_cam, _ = build_scene(procgen.big_scene_data("terrain", res=224))
    cam512 = host_cam._replace(resolution=(512, 512))
    scene, camera = to_device(host, cam512, dev)
    t = time.perf_counter()
    cs = cl.build_clusters(host.vertices, host.faces).to(dev)
    print(f"terrain100k: {host.faces.shape[0]} triangles, {cs.n_clusters} clusters, "
          f"{cs.n_superclusters} superclusters, built in {time.perf_counter() - t:.3f} s",
          flush=True)
    cfg = RenderConfig(max_bounces=4, spp=4, seed=0, estimator="reference")

    phase(f"6 cluster kernels against twins on the card ({N_RAYS} rays, terrain100k)")
    err = np.zeros(2)
    refs = {}
    ro, rd = random_rays(N_RAYS, 0, dev)
    err = np.maximum(err, compare_cluster(kc, cl, cs, ro, rd, T_MAX, "random, scalar t1",
                                          refs))
    perm, _ = morton_pixel_order(512, 512)
    ys, xs = np.mgrid[0:512, 0:512]
    px = torch.as_tensor(xs.reshape(-1)[perm][:N_RAYS], device=dev)
    py = torch.as_tensor(ys.reshape(-1)[perm][:N_RAYS], device=dev)
    cro, crd = generate_rays(camera, px, py, 0, 0)
    err = np.maximum(err, compare_cluster(kc, cl, cs, cro.contiguous(), crd.contiguous(),
                                          T_MAX, "camera rays, scalar t1", refs))
    tables = TraceTables(scene, cfg, accel=cs)
    bounce1, shadow1 = integrator_wavefronts(scene, camera, tables, cfg, px, py)
    err = np.maximum(err, compare_cluster(kc, cl, cs, *bounce1, "bounce-1 wavefront", refs))
    err = np.maximum(err, compare_cluster(kc, cl, cs, *shadow1, "bounce-1 shadow rays", refs))
    lanes = torch.arange(N_RAYS, device=dev)
    t1_dead = torch.where(lanes % 3 == 0, 0.0, T_MAX).float()
    err = np.maximum(err, compare_cluster(kc, cl, cs, ro, rd, t1_dead,
                                          "random, dead lanes t1=0", refs))
    hit_dead, _, _ = kc.closest_hit(cs, ro, rd, T0, t1_dead, sort=True)
    occ_dead = kc.occluded(cs, ro, rd, T0, t1_dead, sort=True)
    check(not bool((hit_dead | occ_dead)[lanes % 3 == 0].any()), "a dead lane (t1=0) hit")
    t1_var = torch.as_tensor(np.random.RandomState(1).uniform(0.1, 3.0, N_RAYS),
                             dtype=torch.float32, device=dev)
    err = np.maximum(err, compare_cluster(kc, cl, cs, ro, rd, t1_var, "random, per-ray t1",
                                          refs))
    rro, rrd = random_rays(100, 4, dev)
    err = np.maximum(err, compare_cluster(kc, cl, cs, rro, rrd, T_MAX, "ragged N=100", refs))
    max_abs_err = {"cluster_closest_hit": float(err[0]), "cluster_occluded": float(err[1])}

    # shared-edge leak hunt (tests/test_watertight.py:168-205) on the kernels
    quad = cl.build_clusters(np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32),
                             np.array([[0, 1, 2], [0, 2, 3]], np.int32)).to(dev)
    ts = np.linspace(1e-4, 1.0 - 1e-4, 4096).astype(np.float32)
    edge_ro = torch.as_tensor(np.stack([ts, ts, np.ones_like(ts)], axis=1), device=dev)
    edge_rd = torch.tensor([[0.0, 0.0, -1.0]], device=dev).expand(4096, 3).contiguous()
    for sort in (False, True):
        hit, t, _ = kc.closest_hit(quad, edge_ro, edge_rd, T0, 10.0, sort=sort, watertight=True)
        occ = kc.occluded(quad, edge_ro, edge_rd, T0, 10.0, sort=sort, watertight=True)
        mt_hit, _, _ = kc.closest_hit(quad, edge_ro, edge_rd, T0, 10.0, sort=sort)
        leaked, leaked_occ = int((~hit).sum()), int((~occ).sum())
        print(f"leak hunt, sort {'on' if sort else 'off'}: watertight kernels leaked "
              f"{leaked} (closest) and {leaked_occ} (occluded) of 4096 shared-edge rays; "
              f"MT leaves leak {int((~mt_hit).sum())}", flush=True)
        check(leaked == 0 and leaked_occ == 0, "the watertight kernels leak")
        torch.testing.assert_close(t, torch.ones_like(t), rtol=1e-4, atol=0.0)

    phase("7 large-scene path: ProgressiveRenderer, terrain100k, 512x512, 4 spp, 4 bounces")
    renderer = ProgressiveRenderer(scene, camera, cfg, chunk=1 << 16)
    check(renderer.backend == "cluster" and renderer.tables.cluster_sort
          and renderer.tables.cluster_watertight,
          f"auto resolved to {renderer.backend}, sort/watertight not both on")
    torch.cuda.synchronize()
    kc.reset_counters()
    ki.reset_counters()
    film = renderer.run(quiet=True)
    launches = {"cluster_closest_hit": kc.closest_hit.launches,
                "cluster_occluded": kc.occluded.launches}
    twins = (kc.closest_hit.twin_calls + kc.occluded.twin_calls
             + ki.closest_hit.twin_calls + ki.occluded.twin_calls)
    whole_table = ki.closest_hit.launches + ki.occluded.launches
    hdr = film.hdr
    check(hdr.shape == (512, 512, 3) and bool(np.isfinite(hdr).all()), "HDR not finite")
    expect = 4 * 4 * 4
    print(f"launches {launches} (expected {expect} each), twin calls {twins}, "
          f"whole-table launches {whole_table}, HDR mean {float(hdr.mean()):.6f}", flush=True)
    for name, n in launches.items():
        check(n == expect, f"{name} launched {n} times, expected {expect}")
    check(twins == 0 and whole_table == 0, "the large-scene path left the cluster kernels")
    rays, secs = renderer.rays_traced, renderer.render_seconds
    print(f"frame: {rays:.0f} rays in {secs:.3f} s = {rays / secs / 1e6:.3f} Mrays/s "
          f"(terrain100k, 512x512, 4 spp, 4 bounces, {card})", flush=True)

    phase("8 GPU against references (terrain8k images, terrain100k mean radiance)")
    host8, cam8, _ = build_scene(procgen.big_scene_data("terrain", res=64))
    cam32 = cam8._replace(resolution=(32, 32))
    s_gpu, c_gpu = to_device(host8, cam32, dev)
    s_cpu, c_cpu = to_device(host8, cam32, "cpu")
    for wt in (False, True):
        cfg8 = RenderConfig(max_bounces=4, spp=2, seed=3, estimator="reference",
                            cluster_watertight=wt)
        img_gpu = render_image(s_gpu, c_gpu, cfg8).cpu().numpy()
        img_cpu = render_image(s_cpu, c_cpu, cfg8).numpy()
        close = float(np.isclose(img_gpu, img_cpu, rtol=1e-3, atol=1e-4).mean())
        med = float(np.median(np.abs(img_gpu - img_cpu)))
        print(f"terrain8k 32x32, {'watertight' if wt else 'MT'} leaves: close fraction "
              f"{close:.6f} (> 0.95), median |diff| {med:.3g} (< 1e-5)", flush=True)
        check(close > 0.95 and med < 1e-5, "terrain8k GPU and CPU images disagree")
    s32, c32 = to_device(host, host_cam._replace(resolution=(32, 32)), dev)
    cfg32 = RenderConfig(max_bounces=4, spp=2, seed=0, estimator="reference")
    mean = float(render_image(s32, c32, cfg32).mean())
    ref = JAX_MEAN_RADIANCE_TERRAIN100K
    print(f"terrain100k 32x32 mean radiance {mean!r}, JAX CPU {ref!r}, "
          f"|diff| {abs(mean - ref):.3g} (<= {MEAN_TOL})", flush=True)
    check(abs(mean - ref) <= MEAN_TOL, "terrain100k mean radiance off")

    phase(f"9 cluster timings on {card}")
    b_ro, b_rd, b_t1 = bounce1
    s_ro, s_rd, s_t1 = shadow1
    ms, plain_ms = {}, {}
    ms["cluster_closest_hit"], plain_ms["cluster_closest_hit"] = cuda_ms_pair(
        lambda: kc.closest_hit(cs, b_ro, b_rd, T0, b_t1, sort=True, watertight=True,
                               exact_t=False),
        lambda: cl.closest_hit_ref(cs, b_ro, b_rd, T0, b_t1, watertight=True))
    ms["cluster_occluded"], plain_ms["cluster_occluded"] = cuda_ms_pair(
        lambda: kc.occluded(cs, s_ro, s_rd, T0, s_t1, sort=True, watertight=True),
        lambda: cl.occluded_ref(cs, s_ro, s_rd, T0, s_t1, watertight=True))
    for name in ms:
        print(f"{name}: kernel {ms[name]:.4f} ms, plain {plain_ms[name]:.4f} ms "
              f"(bounce-1 wavefront of {N_RAYS} rays, terrain100k, watertight, sorted, "
              f"{card})", flush=True)
    ctx = {"host": host, "cs": cs, "scene": scene, "camera": camera, "cfg": cfg,
           "refs": refs, "quad": quad, "edge": (edge_ro, edge_rd), "hdr_cluster": hdr,
           "mrays_cluster": rays / secs / 1e6}
    return {"launches": launches, "max_abs_err": max_abs_err, "ms": ms,
            "plain_ms": plain_ms}, ctx


def compare_binned_kernels(kb, cs, rays, w, label):
    """The four binned kernels against their twins on one ray set at one W:
    prepass (with and without the words) and peel bit for bit, each leaf's
    keys bit for bit, MT and watertight; returns the max absolute
    differences (prepass, peel, leaf t, streamed leaf t)."""
    ids, ovf, words = kb.prepass(cs, rays, T0, w, emit_words=True)
    ids2, ovf2 = kb.prepass(cs, rays, T0, w)
    ids_r, ovf_r, words_r = kb.prepass_ref(cs, rays, T0, w, emit_words=True)
    check(torch.equal(ids, ids_r) and torch.equal(ovf, ovf_r) and torch.equal(words, words_r),
          f"{label}, W={w}: prepass differs from its twin")
    check(torch.equal(ids2, ids) and torch.equal(ovf2, ovf),
          f"{label}, W={w}: prepass without words differs")
    p_ids, p_ovf, p_words = kb.peel(words, w)
    for a, b in zip((p_ids, p_ovf, p_words), kb.peel_ref(words, w)):
        check(torch.equal(a, b), f"{label}, W={w}: peel differs from its twin")
    n_real = int((ids != kb.SENTINEL).sum())
    sortd, pair_ray = kb.sort_pairs(ids, n_real)
    blocks = kb.blocks_for(sortd, cs.n_clusters // kb.BIN)
    err = [0.0, 0.0, 0.0, 0.0]
    for wt in (False, True):
        keys = kb.leaf(cs, sortd, pair_ray, rays, T0, wt)
        keys_s = kb.leaf_streamed(cs, blocks, pair_ray, rays, T0, wt)
        keys_r = kb.leaf_ref(cs, sortd, pair_ray, rays, T0, wt)
        keys_sr = kb.leaf_streamed_ref(cs, blocks, pair_ray, rays, T0, wt)
        torch.cuda.synchronize()
        t_r = kb.decode(keys_r)[1]
        for i, (k, k_r) in enumerate(((keys, keys_r), (keys_s, keys_sr)), start=2):
            hit = k_r != kb.MISS_KEY
            dt = (kb.decode(k)[1] - t_r)[hit].abs()
            err[i] = max(err[i], float(dt.max()) if dt.numel() else 0.0)
        check(torch.equal(keys, keys_r), f"{label}, W={w}, wt={wt}: leaf keys differ")
        check(torch.equal(keys_s, keys_sr), f"{label}, W={w}, wt={wt}: streamed leaf keys differ")
    print(f"{label}, W={w}: prepass, peel bit-equal; {n_real} pairs "
          f"({int(ovf.sum())} rays overflow), {int((blocks[:, 0] >= 0).sum())} streamed blocks; "
          f"leaf and streamed leaf keys bit-equal (MT, watertight)", flush=True)
    return np.array(err)


def compare_binned_wrappers(kb, cl, cs, refs, label):
    """The public binned closest_hit / occluded, resident and streamed, W at
    its default and at 1, MT and watertight, against phase 6's sweep-twin
    results; returns the largest number of peel launches of one query."""
    ro, rd, t1 = refs["rays"]
    most_peels = 0
    for wt in (False, True):
        hit_r, t_r, slot_r = refs[wt]
        face_r = cl.slot_to_face(cs, slot_r).to(torch.int32)
        for streamed in (False, True):
            for w in (kb._W_DEFAULT, 1):
                kb.W_SLOTS = w
                peels = kb.peel.launches
                hit, t, face = kb.closest_hit(cs, ro, rd, T0, t1, watertight=wt,
                                              streamed=streamed, exact_t=False)
                most_peels = max(most_peels, kb.peel.launches - peels)
                occ = kb.occluded(cs, ro, rd, T0, t1, watertight=wt, streamed=streamed)
                kb.W_SLOTS = kb._W_DEFAULT
                shown = kb._w_slots(streamed) if w == kb._W_DEFAULT else w
                tag = (f"{label}, {'watertight' if wt else 'MT'}, "
                       f"{'streamed' if streamed else 'resident'}, W={shown}")
                check(torch.equal(hit, hit_r), f"{tag}: hit masks differ from the sweep twin")
                check(torch.equal(occ, hit_r), f"{tag}: occlusion differs from the sweep twin")
                n_hit = int(hit.sum())
                same = (face == face_r) & hit
                n_same = int(same.sum())
                check(n_same >= 0.999 * n_hit, f"{tag}: faces equal on {n_same}/{n_hit} hits")
                torch.testing.assert_close(t[same], t_r[same], rtol=1e-5, atol=0.0)
                err_t = float((t - t_r).abs().max()) if t.numel() else 0.0
                print(f"{tag}: hits={n_hit} faces equal {n_same}/{n_hit} max|dt|={err_t:.3g}, "
                      "occlusion equal", flush=True)
    return most_peels


def binned_phases(dev, card, ctx):
    """Phases 10-12 (the binned traversal at terrain100k); returns the
    kernel-line entries of the four binned kernels."""
    from pyrenderer_tpu_torch.accel import clusters as cl
    from pyrenderer_tpu_torch.kernels import binned as kb
    from pyrenderer_tpu_torch.kernels import cluster as kc
    from pyrenderer_tpu_torch.kernels import intersect as ki
    from pyrenderer_tpu_torch.render import cli
    from pyrenderer_tpu_torch.render.driver import ProgressiveRenderer

    cs, refs = ctx["cs"], ctx["refs"]
    names = ("binned_prepass", "binned_peel", "binned_leaf", "binned_leaf_streamed")
    phase(f"10 binned kernels against twins on the card (terrain100k, {cs.n_clusters // kb.BIN}"
          f" bins, {cs.bin_box.shape[0]} box rows)")
    err = np.zeros(4)
    for label, ref in refs.items():
        rays = kc._prepare(cs, *ref["rays"], sort=False)[0]
        for w in (kb._W_DEFAULT, 1):
            err = np.maximum(err, compare_binned_kernels(kb, cs, rays, w, label))
    max_abs_err = dict(zip(names, (float(e) for e in err)))
    peels = {label: compare_binned_wrappers(kb, cl, cs, ref, label)
             for label, ref in refs.items()}
    print(f"most peel rounds of one streamed query (W=1): {peels}", flush=True)
    quad = ctx["quad"]
    edge_ro, edge_rd = ctx["edge"]
    for streamed in (False, True):
        hit, t, _ = kb.closest_hit(quad, edge_ro, edge_rd, T0, 10.0, watertight=True,
                                   streamed=streamed)
        occ = kb.occluded(quad, edge_ro, edge_rd, T0, 10.0, watertight=True, streamed=streamed)
        leaked, leaked_occ = int((~hit).sum()), int((~occ).sum())
        print(f"leak hunt, binned {'streamed' if streamed else 'resident'}: leaked {leaked} "
              f"(closest) and {leaked_occ} (occluded) of 4096 shared-edge rays", flush=True)
        check(leaked == 0 and leaked_occ == 0, "the binned watertight path leaks")
        torch.testing.assert_close(t, torch.ones_like(t), rtol=1e-4, atol=0.0)

    phase("11 binned path: ProgressiveRenderer, terrain100k, 512x512, 4 spp, 4 bounces")
    launches = dict.fromkeys(names, 0)
    mrays = {"cluster": ctx["mrays_cluster"]}
    expect = 4 * 4 * 4 * 2
    for backend, leaf_name in (("cluster_binned", "binned_leaf"),
                               ("cluster_streamed", "binned_leaf_streamed")):
        renderer = ProgressiveRenderer(ctx["scene"], ctx["camera"], ctx["cfg"],
                                       backend=backend, chunk=1 << 16, accel=cs)
        check(renderer.backend == backend and renderer.tables.cluster_watertight
              and not renderer.tables.cluster_sort,
              f"{backend}: resolved {renderer.backend}, watertight/sort not on/off")
        torch.cuda.synchronize()
        kb.reset_counters()
        kc.reset_counters()
        ki.reset_counters()
        film = renderer.run(quiet=True)
        run = {name: getattr(kb, name[len("binned_"):]).launches for name in names}
        twins = sum(fn.twin_calls for fn in (kb.prepass, kb.peel, kb.leaf, kb.leaf_streamed,
                                             kc.closest_hit, kc.occluded, ki.closest_hit,
                                             ki.occluded))
        whole_table = ki.closest_hit.launches + ki.occluded.launches
        residual = kc.closest_hit.launches + kc.occluded.launches
        hdr = film.hdr
        check(hdr.shape == (512, 512, 3) and bool(np.isfinite(hdr).all()), "HDR not finite")
        ref = ctx["hdr_cluster"]
        close = float(np.isclose(hdr, ref, rtol=1e-3, atol=0.0).mean())
        med = float(np.median(np.abs(hdr - ref)))
        print(f"{backend}: launches {run}, sweep residual launches {residual}, twin calls "
              f"{twins}, whole-table launches {whole_table}; against the cluster frame: close "
              f"fraction {close:.6f} (> 0.999), median |diff| {med:.3g} (0), HDR mean "
              f"{float(hdr.mean()):.6f}", flush=True)
        check(run["binned_prepass"] >= expect and run[leaf_name] >= expect,
              f"{backend}: prepass or leaf launched fewer than {expect} times")
        # at terrain100k some rays cross more than W bins on every bounce, so
        # each path also runs its overflow stage: the sweep or the peel
        overflow_stage = residual if backend == "cluster_binned" else run["binned_peel"]
        check(overflow_stage > 0, f"{backend}: the overflow stage never ran")
        check(twins == 0 and whole_table == 0, f"{backend}: the path left the kernels")
        check(close > 0.999 and med == 0.0, f"{backend}: frame differs from the cluster frame")
        for name in names:
            launches[name] += run[name]
        mrays[backend] = renderer.rays_traced / renderer.render_seconds / 1e6
    print("frames (terrain100k, 512x512, 4 spp, 4 bounces, Mrays/s as bench.py counts): "
          + ", ".join(f"{b} {m:.3f}" for b, m in mrays.items()) + f" ({card})", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "binned.png")
        kb.reset_counters()
        rc, log = run_cli(cli, [SCENE, "--estimator", "reference", "--backend",
                                "cluster_binned", "--res", "64", "64", "--spp", "2",
                                "--depth", "4", "--out", png,
                                "--hdr-out", os.path.join(tmp, "binned.exr")])
        check(rc == 0 and os.path.getsize(png) > 0, "the --backend cluster_binned CLI run failed")
        check("(cluster_binned backend)" in log and kb.prepass.launches == 2 * 4 * 2
              and kb.prepass.twin_calls == 0,
              f"the CLI run did not route to the binned kernels ({kb.prepass.launches} prepass "
              "launches)")
        print(f"CLI --backend cluster_binned: {kb.prepass.launches} prepass and "
              f"{kb.leaf.launches} leaf launches", flush=True)

    phase(f"12 binned timings on {card}")
    b_ro, b_rd, b_t1 = refs["bounce-1 wavefront"]["rays"]
    s_ro, s_rd, s_t1 = refs["bounce-1 shadow rays"]["rays"]
    rays = kc._prepare(cs, b_ro, b_rd, b_t1, sort=False)[0]
    w = kb._w_slots()
    ids, ovf, words = kb.prepass(cs, rays, T0, w, emit_words=True)
    n_real = int((ids != kb.SENTINEL).sum())
    sortd, pair_ray = kb.sort_pairs(ids, n_real)
    blocks = kb.blocks_for(sortd, cs.n_clusters // kb.BIN)
    print(f"bounce-1 wavefront: {int((b_t1 > 0).sum())} live rays, {n_real} pairs at W={w}, "
          f"{int(ovf.sum())} overflow rays", flush=True)
    ms, plain_ms = {}, {}
    ms["binned_prepass"], plain_ms["binned_prepass"] = cuda_ms_pair(
        lambda: kb.prepass(cs, rays, T0, w), lambda: kb.prepass_ref(cs, rays, T0, w))
    ms["binned_peel"], plain_ms["binned_peel"] = cuda_ms_pair(
        lambda: kb.peel(words, w), lambda: kb.peel_ref(words, w))
    ms["binned_leaf"], plain_ms["binned_leaf"] = cuda_ms_pair(
        lambda: kb.leaf(cs, sortd, pair_ray, rays, T0, True),
        lambda: kb.leaf_ref(cs, sortd, pair_ray, rays, T0, True), twin_reps=2)
    ms["binned_leaf_streamed"], plain_ms["binned_leaf_streamed"] = cuda_ms_pair(
        lambda: kb.leaf_streamed(cs, blocks, pair_ray, rays, T0, True),
        lambda: kb.leaf_streamed_ref(cs, blocks, pair_ray, rays, T0, True), twin_reps=2)
    for name in names:
        print(f"{name}: kernel {ms[name]:.4f} ms, plain {plain_ms[name]:.4f} ms (bounce-1 "
              f"wavefront of {N_RAYS} rays, terrain100k, watertight, {card})", flush=True)
    wrappers = {
        "closest, binned": lambda: kb.closest_hit(cs, b_ro, b_rd, T0, b_t1, watertight=True,
                                                  exact_t=False),
        "closest, streamed": lambda: kb.closest_hit(cs, b_ro, b_rd, T0, b_t1, watertight=True,
                                                    streamed=True, exact_t=False),
        "closest, sweep sorted": lambda: kc.closest_hit(cs, b_ro, b_rd, T0, b_t1, sort=True,
                                                        watertight=True, exact_t=False),
        "closest, sweep unsorted": lambda: kc.closest_hit(cs, b_ro, b_rd, T0, b_t1,
                                                          watertight=True, exact_t=False),
        "occluded, binned": lambda: kb.occluded(cs, s_ro, s_rd, T0, s_t1, watertight=True),
        "occluded, streamed": lambda: kb.occluded(cs, s_ro, s_rd, T0, s_t1, watertight=True,
                                                  streamed=True),
        "occluded, sweep sorted": lambda: kc.occluded(cs, s_ro, s_rd, T0, s_t1, sort=True,
                                                      watertight=True),
        "occluded, sweep unsorted": lambda: kc.occluded(cs, s_ro, s_rd, T0, s_t1,
                                                        watertight=True),
    }
    order = list(wrappers) + list(reversed(wrappers))
    times = {name: [] for name in wrappers}
    for name in order:
        times[name].append(cuda_ms(wrappers[name]))
    for name in wrappers:
        print(f"wrapper {name}: {float(np.median(times[name])):.4f} ms (median of 2 x 20, "
              f"bounce-1 {'shadow rays' if name.startswith('occluded') else 'wavefront'}, "
              f"watertight, {card})", flush=True)
    return {"launches": launches, "max_abs_err": max_abs_err, "ms": ms,
            "plain_ms": plain_ms}


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
