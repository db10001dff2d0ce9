"""Headline benchmark of the port: Mrays/s at 4 bounces on one GPU.

    python -m pyrenderer_tpu_torch.bench

Counterpart of bench.py. Prints ONE JSON line on stdout:
{"metric", "value", "unit", "calib_ns_per_leaf", "device", "rays",
"seconds", "launches", "twin_calls"}, the metric named as bench.py names
it. Rays counted = live closest-hit rays plus NEE shadow rays (dead masked
lanes excluded), as the integrator's with_stats counts them. "launches"
and "twin_calls" are the kernel wrappers' counts over the timed pass and
the calibration ({kernel name: count}, nonzero counts only; see
kernels.counts): on the card every query launches a kernel and no twin
runs.

Env knobs (bench.py's):
  BENCH_SCENE      cornell (default) | spheres | terrain8k | terrain100k |
                   terrain330k | terrain500k | blob82k (SCENES)
  BENCH_BACKEND    auto (default) | cuda | brute | matmul | bvh | cluster |
                   cluster_binned | cluster_streamed | cluster_chunked |
                   watertight; "pallas" raises (its port is "cuda")
  BENCH_SPP        timed samples per pixel (the row's default)
  BENCH_RES        square resolution (the row's default)
  BENCH_CHUNK      rays per chunk (default 2^16, Morton-ordered screen
                   blocks; the last chunk of a frame may be short, where the
                   JAX bench pads it with pixel (0, 0) for static shapes)
  BENCH_ESTIMATOR  reference (default) | pbrt
  BENCH_WATERTIGHT 1 | 0 forces the cluster leaves (default "auto")
  BENCH_SORT       0 | 1 | auto (default)
  BENCH_ROUNDS     cluster suspend/resume passes (default 1; cluster_rounds)
  BENCH_BUDGET     pass-1 supercluster visit budget per ray (default 8;
                   read only with rounds > 1)
  PYRENDERER_PIXEL_ORDER  morton (default) | hilbert | row
  BENCH_DEVICE     cuda:0 (default) | cpu; without a GPU and without
                   BENCH_DEVICE=cpu it exits non-zero (the tests use cpu)

terrain330k and terrain500k resolve through "auto" to "cluster" like every
scene above 4096 triangles: the JAX package sends them to
"cluster_streamed" only because they overflow a TPU's VMEM, a ceiling this
card does not have.

The loop is bench.py's: per sample, the Morton-ordered chunks through
render_sample with with_stats (trace_reference or trace_pbrt). One
warm-up sample, which builds the kernels and the accelerator, is not
timed; then spp samples run under a host clock that ends in
torch.cuda.synchronize().

"calib_ns_per_leaf" is the leaf probe of perf/kernelbench.py at L = 64
(calibrate()): ns per full-width 128 x 128 leaf on the same card in the
same process, null on the CPU. The probe's kernel gives each ray 8 lanes:
it reads about 37 ns on an H100, where the one-thread-a-ray kernel before
it read about 67, so rows from either side of that change do not compare
on it. bench.py's "vs_baseline" (value / 100
against a TPU target) and its 820 ns normaliser (a TPU reading) are not
carried over.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from pyrenderer_tpu_torch import kernels

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCENES = {
    # name -> (procgen kwargs or None for a scene file, default res,
    #          default spp, metric name)
    "cornell": (None, 1024, 16, "cornell_box_4bounce_mrays_per_sec_per_chip"),
    "spheres": (None, 1024, 16, "spheres_4bounce_mrays_per_sec_per_chip"),
    "terrain8k": (dict(kind="terrain", res=64), 512, 4,
                  "terrain8k_4bounce_mrays_per_sec_per_chip"),
    "terrain100k": (dict(kind="terrain", res=224), 512, 4,
                    "terrain100k_4bounce_mrays_per_sec_per_chip"),
    "terrain330k": (dict(kind="terrain", res=406), 512, 2,
                    "terrain330k_4bounce_mrays_per_sec_per_chip"),
    "terrain500k": (dict(kind="terrain", res=501), 512, 2,
                    "terrain500k_4bounce_mrays_per_sec_per_chip"),
    "blob82k": (dict(kind="blob", subdivisions=6), 512, 4,
                "blob82k_4bounce_mrays_per_sec_per_chip"),
}

CALIB_LEAVES = 64
CALIB_WARMUP, CALIB_REPS = 2, 20    # leaf-probe launches of one calibration


def load_bench_scene(name):
    """(host Scene, Camera, default res, default spp, metric) of a SCENES
    row, through the port's loaders."""
    from pyrenderer_tpu_torch.scene import load_tungsten, procgen
    from pyrenderer_tpu_torch.scene.tungsten import build_scene

    procgen_kw, res, spp, metric = SCENES[name]
    if procgen_kw is None:
        json_name = "cornell_box.json" if name == "cornell" else f"{name}.json"
        scene, camera, _ = load_tungsten(os.path.join(ROOT, "scenes", json_name))
    else:
        scene, camera, _ = build_scene(procgen.big_scene_data(**procgen_kw))
    return scene, camera, res, spp, metric


def calibrate(device):
    """ns per full-width (128 x 128) Moeller-Trumbore leaf of the leaf probe
    at L = 64 over 256 tiles (CUDA events, perf/kernelbench.py), measured in
    this process on `device`; None on a CPU device."""
    from pyrenderer_tpu_torch.perf import kernelbench as kb

    device = torch.device(device)
    if device.type != "cuda":
        return None
    rcol, tri = kb.inputs(kb.N_TILES, device)
    ms = kb.cuda_ms(lambda: kb.leaf(rcol, tri, CALIB_LEAVES), reps=CALIB_REPS,
                    warmup=CALIB_WARMUP)
    return ms * 1e6 / (kb.N_TILES * CALIB_LEAVES)


def _device(env):
    name = env.get("BENCH_DEVICE", "cuda:0")
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        return None
    return device


def run(env=None, dtype=torch.float32):
    """The benchmark as BENCH_* in `env` (default os.environ) configure it,
    the scene in `dtype` (the tests count rays in float64); returns the
    JSON row. Raises RuntimeError without the CUDA device it asks for."""
    from pyrenderer_tpu_torch.config import RenderConfig
    from pyrenderer_tpu_torch.core.camera import pixel_order
    from pyrenderer_tpu_torch.core.integrator import TraceTables, render_sample
    from pyrenderer_tpu_torch.scene import to_device

    env = os.environ if env is None else env
    device = _device(env)
    if device is None:
        raise RuntimeError("no CUDA device: the benchmark runs on a GPU "
                           "(BENCH_DEVICE=cpu runs it on the CPU, for tests)")
    scene_name = env.get("BENCH_SCENE", "cornell")
    estimator = env.get("BENCH_ESTIMATOR", "reference")
    watertight = {"0": False, "1": True}.get(env.get("BENCH_WATERTIGHT", ""),
                                             RenderConfig.cluster_watertight)
    sort = {"0": False, "1": True}.get(env.get("BENCH_SORT", "auto"), "auto")
    host, camera, def_res, def_spp, metric = load_bench_scene(scene_name)
    res = int(env.get("BENCH_RES", str(def_res)))
    spp = int(env.get("BENCH_SPP", str(def_spp)))
    chunk = int(env.get("BENCH_CHUNK", str(1 << 16)))
    backend = env.get("BENCH_BACKEND", "auto")
    cfg = RenderConfig(max_bounces=4, spp=spp, seed=0, estimator=estimator,
                       cluster_watertight=watertight, cluster_sort=sort,
                       cluster_rounds=int(env.get("BENCH_ROUNDS", "1")),
                       cluster_budget=int(env.get("BENCH_BUDGET", "8")))

    scene, camera = to_device(host, camera._replace(resolution=(res, res)), device, dtype)
    w, h = camera.resolution
    perm, _ = pixel_order(w, h, env.get("PYRENDERER_PIXEL_ORDER", "morton"))
    ys, xs = np.mgrid[0:h, 0:w]
    xs = torch.as_tensor(xs.reshape(-1)[perm], device=device)
    ys = torch.as_tensor(ys.reshape(-1)[perm], device=device)
    chunks = [(xs[s:s + chunk], ys[s:s + chunk]) for s in range(0, w * h, chunk)]
    tag = "" if estimator == "reference" else f",{estimator}"
    tag += {True: ",watertight", False: ",nowatertight"}.get(watertight, "")
    tag += ",nosort" if sort is False else ""
    tag += f",rounds={cfg.cluster_rounds}" if cfg.cluster_rounds > 1 else ""

    def samples(first, count, tables):
        total = torch.zeros(3, dtype=dtype, device=device)
        rays = torch.zeros((), dtype=torch.float64, device=device)
        for s in range(first, first + count):
            for px, py in chunks:
                rad, n_rays = render_sample(scene, camera, cfg, cfg.seed, s, px, py,
                                            tables=tables, with_stats=True)
                total = total + rad.sum(dim=0)
                rays = rays + n_rays
        return total, rays

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # warm-up: the accelerator build and the kernels' build and first launch
    t0 = time.perf_counter()
    tables = TraceTables(scene, cfg, backend)
    samples(0, 1, tables)
    sync()
    print(f"bench[{scene_name}{tag}]: {w}x{h}, {host.faces.shape[0]} tris, {spp} passes, "
          f"chunk={chunk} ({len(chunks)} chunks/pass), backend={tables.backend}, "
          f"device={device}, warmup {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    kernels.reset_counters()
    t0 = time.perf_counter()
    total, rays = samples(0, spp, tables)
    sync()
    dt = time.perf_counter() - t0
    rays = float(rays)
    mrays = rays / dt / 1e6
    mean = float(total.sum()) / (w * h * spp * 3)
    print(f"{dt:.3f}s, {rays / 1e6:.3f} Mrays, mean radiance {mean:.5f}", file=sys.stderr)
    calib = calibrate(device)
    if calib is not None:
        print(f"calib {calib:.1f} ns/leaf", file=sys.stderr)
    launches, twin_calls = kernels.counts()
    return {
        "metric": metric
        + ("_" + estimator if estimator != "reference" else "")
        + ("_watertight" if watertight is True else "")
        + ("_nowatertight" if watertight is False else "")
        + ("_nosort" if sort is False else ""),
        "value": mrays,
        "unit": "Mrays/s",
        "calib_ns_per_leaf": calib,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "rays": rays,
        "seconds": dt,
        "launches": launches,
        "twin_calls": twin_calls,
    }


def main() -> int:
    if _device(os.environ) is None:
        print("no CUDA device: the benchmark runs on a GPU "
              "(BENCH_DEVICE=cpu runs it on the CPU, for tests)", file=sys.stderr)
        return 2
    print(json.dumps(run()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
