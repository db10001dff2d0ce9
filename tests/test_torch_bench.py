"""pyrenderer_tpu_torch.bench on the CPU: its JSON line, its ray count
against the JAX integrator's, and its refusal to run without a GPU."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyrenderer_tpu.config import RenderConfig as JaxConfig
from pyrenderer_tpu.core import integrator as integ_jax
from pyrenderer_tpu.core.camera import generate_rays as generate_rays_jax
from pyrenderer_tpu.core.camera import pixel_order
from pyrenderer_tpu.core.integrator_pbrt import trace_pbrt as trace_pbrt_jax
from pyrenderer_tpu_torch import bench

torch.set_num_threads(2)

RES = 16


def _env(scene, estimator="reference", **extra):
    env = {"BENCH_DEVICE": "cpu", "BENCH_SCENE": scene, "BENCH_ESTIMATOR": estimator,
           "BENCH_RES": str(RES), "BENCH_SPP": "1"}
    env.update(extra)
    return env


def _jax_rays(scene_name, estimator):
    """The rays JAX's trace_reference / trace_pbrt count (with_stats) for
    sample 0 of every pixel of the RES x RES frame, in float64, on the
    whole-table brute backend."""
    host, camera, _, _, _ = bench.load_bench_scene(scene_name)
    host = host._replace(vertices=host.vertices.astype(np.float64),
                         albedo=host.albedo.astype(np.float64),
                         emission=host.emission.astype(np.float64),
                         ior=host.ior.astype(np.float64),
                         roughness=host.roughness.astype(np.float64))
    cfg = JaxConfig(max_bounces=4, spp=1, seed=0, estimator=estimator)
    perm, _ = pixel_order(RES, RES, "morton")
    ys, xs = np.mgrid[0:RES, 0:RES]
    px = jnp.asarray(xs.reshape(-1)[perm], jnp.int32)
    py = jnp.asarray(ys.reshape(-1)[perm], jnp.int32)
    with jax.enable_x64(True):
        scene = jax.tree.map(jnp.asarray, host)
        camera = camera._replace(resolution=(RES, RES), iview=jnp.asarray(camera.iview,
                                                                          jnp.float64))
        tables = integ_jax.TraceTables(scene, cfg, "brute")
        pixel_id = (py * RES + px).astype(jnp.uint32)
        sample = jnp.zeros_like(pixel_id)
        ro, rd = generate_rays_jax(camera, px, py, sample, cfg.seed)
        trace = integ_jax.trace_reference if estimator == "reference" else trace_pbrt_jax
        _, n_rays = trace(scene, cfg, ro, rd, pixel_id, sample, cfg.seed, tables=tables,
                          with_stats=True)
        return float(n_rays)


WHOLE_TABLE = ("closest_hit", "occluded")
CLUSTER = ("cluster_closest_hit", "cluster_occluded")


@pytest.mark.parametrize("scene,estimator,backend,queries", [
    # "auto" is "brute" on the CPU up to 4096 triangles: no kernel wrapper
    pytest.param("cornell", "reference", "auto", (), id="cornell-reference"),
    pytest.param("cornell", "pbrt", "auto", (), id="cornell-pbrt"),
    pytest.param("cornell", "pbrt", "cuda", WHOLE_TABLE, id="cornell-pbrt-cuda"),
    pytest.param("terrain8k", "reference", "cluster", CLUSTER, id="terrain8k-reference")])
def test_bench_json_line_on_cpu(scene, estimator, backend, queries, monkeypatch, capsys):
    """BENCH_DEVICE=cpu at 16x16, 1 spp: one JSON line with bench.py's
    metric name, a finite value, device "cpu", no calibration, and the
    wrappers' counts of the timed pass: no launch, one twin call of each
    query of a kernel backend per bounce of the one chunk, and one of the
    Threefry wrapper per draw: two for the camera, then three a bounce
    (reference) or four (pbrt; no roulette draw before bounce 4)."""
    for key, value in _env(scene, estimator, BENCH_BACKEND=backend).items():
        monkeypatch.setenv(key, value)
    assert bench.main() == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    metric = bench.SCENES[scene][3] + ("_pbrt" if estimator == "pbrt" else "")
    assert row["metric"] == metric and row["unit"] == "Mrays/s"
    assert np.isfinite(row["value"]) and row["value"] > 0
    assert row["device"] == "cpu" and row["calib_ns_per_leaf"] is None
    assert row["rays"] >= RES * RES
    draws = 2 + 4 * (3 if estimator == "reference" else 4)
    assert row["launches"] == {}
    assert row["twin_calls"] == {**dict.fromkeys(queries, 4), "threefry": draws}


@pytest.mark.parametrize("scene,estimator", [
    ("cornell", "reference"), ("cornell", "pbrt"), ("terrain8k", "reference")])
def test_bench_ray_count_matches_jax(scene, estimator):
    """The bench's ray count equals the JAX integrator's with_stats count for
    the same pixels and sample, both in float64 (where no grazing ray
    flips)."""
    row = bench.run(_env(scene, estimator), dtype=torch.float64)
    assert row["rays"] == _jax_rays(scene, estimator)


def test_bench_metric_suffixes():
    row = bench.run(_env("cornell", BENCH_WATERTIGHT="1", BENCH_SORT="0", BENCH_RES="8"))
    assert row["metric"] == "cornell_box_4bounce_mrays_per_sec_per_chip_watertight_nosort"


def test_bench_rounds_raise():
    """BENCH_ROUNDS=2 runs suspend/resume rounds: on terrain8k with backend
    "cluster" it counts the rays of rounds 1, and each closest-hit query
    runs two twin passes (one suspend, one resume); the draws, 2 + 3 a
    bounce, are the same."""
    env = _env("terrain8k", BENCH_BACKEND="cluster", BENCH_RES="8")
    one = bench.run(env)
    two = bench.run(dict(env, BENCH_ROUNDS="2", BENCH_BUDGET="1"))
    assert two["rays"] == one["rays"] > 0 and two["metric"] == one["metric"]
    assert two["twin_calls"] == {"cluster_closest_hit": 8, "cluster_closest_suspend": 4,
                                 "cluster_closest_resume": 4, "cluster_occluded": 4,
                                 "threefry": 14}
    assert two["launches"] == {}


def test_calibrate_is_none_on_cpu():
    assert bench.calibrate("cpu") is None


def test_bench_without_gpu_exits_nonzero(monkeypatch, capsys):
    """Without BENCH_DEVICE the bench needs a GPU; with none it exits
    non-zero and prints no result, it does not fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("BENCH_DEVICE", raising=False)
    monkeypatch.setenv("BENCH_RES", "8")
    assert bench.main() != 0
    out = capsys.readouterr()
    assert out.out == "" and "GPU" in out.err
    with pytest.raises(RuntimeError):
        bench.run({"BENCH_RES": "8"})
