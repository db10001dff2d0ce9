"""perf/estbench.py's stages in pyrenderer_tpu_torch.perf.estbench against
their JAX counterparts on the CPU: the same inputs (the JAX harness's draws
from numpy.random.default_rng(0), 512 rays) through each stage of the port
and through the JAX package's public functions, which the JAX harness calls
inside closures of its main()."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyrenderer_tpu import rng as prng
from pyrenderer_tpu.config import RenderConfig as JaxConfig
from pyrenderer_tpu.core import integrator as integ_jax
from pyrenderer_tpu.core import lut, sampling
from pyrenderer_tpu.core.camera import generate_rays as generate_rays_jax
from pyrenderer_tpu.core.integrator_pbrt import trace_pbrt as trace_pbrt_jax
from pyrenderer_tpu.core.sampling import INV_PI
from pyrenderer_tpu.kernels import pallas_intersect as pk
from pyrenderer_tpu.ref import scalar as ref
from pyrenderer_tpu.ref import scalar_pbrt as ref_pbrt
from pyrenderer_tpu.scene.tungsten import load_tungsten
from pyrenderer_tpu_torch.core.integrator import trace_reference
from pyrenderer_tpu_torch.core.integrator_pbrt import trace_pbrt
from pyrenderer_tpu_torch.perf import estbench

torch.set_num_threads(2)

N = 512
C4_N = 2048
SEED = estbench.SEED


@pytest.fixture(scope="module")
def setup():
    """(port inputs, JAX namespace): the same scene, configs and arrays."""
    return _setup(N)


def _setup(n):
    x = estbench.inputs("cpu", n)
    host, camera, _ = load_tungsten(estbench.SCENE, dtype=np.float32)
    scene = jax.tree.map(jnp.asarray, host)
    cfg = JaxConfig(max_bounces=4, spp=1, seed=SEED)
    cfg_pbrt = cfg.replace(estimator="pbrt")
    h = x.host
    j = dict(host=host, scene=scene, camera=camera, cfg=cfg, cfg_pbrt=cfg_pbrt,
             tables=integ_jax.TraceTables(scene, cfg, "brute"),
             tables_pbrt=integ_jax.TraceTables(scene, cfg_pbrt, "brute"),
             pixel=jnp.asarray(h["pixel"]), sample=jnp.zeros((n,), jnp.uint32),
             ro=jnp.asarray(h["ro"]), rd=jnp.asarray(h["rd"]), tri=jnp.asarray(h["tri"]),
             px=jnp.asarray(h["px"]), py=jnp.asarray(h["py"]))
    return x, j


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def test_inputs_are_the_jax_harness_draws(setup):
    x, _ = setup
    rngs = np.random.default_rng(0)
    assert np.array_equal(x.host["pixel"], rngs.integers(0, 1 << 20, N).astype(np.uint32))
    ro = rngs.uniform(-0.8, 0.8, (N, 3))
    assert np.array_equal(x.ro.numpy(), np.asarray(jnp.asarray(ro, jnp.float32)))
    assert x.pixel.dtype == torch.int64 and np.array_equal(x.pixel.numpy(), x.host["pixel"])


@pytest.mark.parametrize("stage", ["rng1", "rng2", "rng_bounce"])
def test_rng_stages_bit_for_bit(setup, stage):
    """The uniforms' float32 bits (the top 24 bits of the Threefry words)."""
    x, j = setup
    p, s, b = j["pixel"], j["sample"], jnp.uint32(1)
    want = {
        "rng1": lambda: [prng.uniform(SEED, p, s, b, prng.U_LIGHT_FACE)],
        "rng2": lambda: [prng.uniform2(SEED, p, s, b, prng.U_BSDF_0)[0]],
        "rng_bounce": lambda: [*prng.uniform2(SEED, p, s, b, prng.U_BSDF_0),
                               prng.uniform(SEED, p, s, b, prng.U_LIGHT_FACE),
                               *prng.uniform2(SEED, p, s, b, prng.U_LIGHT_U)],
    }[stage]()
    got = getattr(estbench, stage)(x.pixel, x.sample)
    got = list(got) if isinstance(got, tuple) else [got]
    assert len(got) == len(want)
    for a, b_ in zip(got, want):
        assert np.array_equal(_bits(a.numpy()), _bits(b_))


def test_fetch_face_bit_for_bit(setup):
    x, j = setup
    assert np.array_equal(x.tables.face_data.numpy(), np.asarray(j["tables"].face_data))
    got = estbench.fetch_face(x.tables.face_data, x.tri).numpy()
    want = np.asarray(lut.fetch_rows(j["tables"].face_data, j["tri"]))
    assert np.array_equal(_bits(got), _bits(want))


def test_fetch_light_matches_jax(setup):
    """The light point, its normal and emission: the integrator tests'
    tolerance (rtol 1e-4, atol 1e-6)."""
    x, j = setup
    got = estbench.fetch_light(x.scene, x.tables, x.pixel, x.sample)
    want = integ_jax._sample_light_point(j["scene"], j["tables"], j["pixel"], j["sample"],
                                         jnp.uint32(1), SEED, jnp.float32)[:3]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-6)


def _shade_jax(j):
    """perf/estbench.py's shade closure, without its scan carry."""
    tables, tri, ro, rd = j["tables"], j["tri"], j["ro"], j["rd"]
    row = lut.fetch_rows(tables.face_data, tri)
    v0, e1, e2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
    albedo, sign = row[:, 9:12], row[:, 12]
    s = ro - v0
    det = jnp.sum(jnp.cross(e1, rd) * e2, axis=-1)
    safe_det = jnp.where(det == 0, 1.0, det)
    t = -jnp.sum(jnp.cross(s, e2) * e1, axis=-1) / safe_det
    hp = ro + t[:, None] * rd
    n_geo = sign[:, None] * sampling.safe_normalize(jnp.cross(e1, e2))
    u1, u2 = prng.uniform2(SEED, j["pixel"], j["sample"], jnp.uint32(1), prng.U_BSDF_0)
    wi = sampling.rotate_z_to(n_geo, sampling.cosine_sample_hemisphere(u1, u2))
    cos_wi = jnp.sum(n_geo * wi, axis=-1)
    pdf = jnp.abs(cos_wi) * INV_PI
    safe_pdf = jnp.where(pdf == 0, 1.0, pdf)
    scale = jnp.maximum(0.0, cos_wi) / safe_pdf * INV_PI
    return albedo * scale[:, None], hp


def test_shade_matches_jax(setup):
    """beta and the re-derived hit point: rtol 1e-4, atol 1e-6 (the
    integrator tests' tolerance)."""
    x, j = setup
    got = estbench.shade(x.tables.face_data, x.tri, x.pixel, x.sample, x.ro, x.rd)
    for a, b in zip(got, _shade_jax(j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-6)


def test_camera_matches_jax(setup):
    """ro and rd at the camera tests' float32 tolerance (atol 1e-6)."""
    x, j = setup
    ro, rd = estbench.camera_rays(x.camera, x.px, x.py, x.sample)
    ro_j, rd_j = generate_rays_jax(j["camera"], j["px"], j["py"], j["sample"], SEED)
    np.testing.assert_allclose(ro.numpy(), np.asarray(ro_j), atol=1e-6)
    np.testing.assert_allclose(rd.numpy(), np.asarray(rd_j), atol=1e-6)


def _mismatched_rays(a, b):
    return int((~np.isclose(a, b, rtol=1e-4, atol=1e-6).all(axis=1)).sum())


def _jax_trace(j, estimator, tables):
    trace = integ_jax.trace_reference if estimator == "reference" else trace_pbrt_jax
    cfg = j["cfg"] if estimator == "reference" else j["cfg_pbrt"]
    return np.asarray(trace(j["scene"], cfg, j["ro"], j["rd"], j["pixel"], j["sample"], SEED,
                            tables=tables))


def _jax_stub(j, estimator):
    """The JAX harness's _Stub through TraceTables.custom: a live lane hits
    face tri at t = 1; a shadow ray is blocked only when dead."""
    tables = j["tables"] if estimator == "reference" else j["tables_pbrt"]
    t_hit = jnp.ones(j["tri"].shape, jnp.float32)
    return integ_jax.TraceTables.custom(
        tables.face_data, tables.light_data,
        closest_fn=lambda ro, rd, t1: (t1 > 0, t_hit, j["tri"]),
        any_hit_fn=lambda ro, rd, t1: t1 <= 0)


@pytest.mark.parametrize("estimator", ["reference", "pbrt"])
def test_trace4_stub_matches_jax(setup, estimator):
    """Both estimators with the intersection stubbed, against the JAX trace
    through the same stub: rays at rtol 1e-4, atol 1e-6 on at least 98% of
    the rays (the integrator tests' criterion)."""
    x, j = setup
    trace = trace_reference if estimator == "reference" else trace_pbrt
    cfg, tables = (x.cfg, x.tables) if estimator == "reference" else (x.cfg_pbrt, x.tables_pbrt)
    got = estbench.trace4(trace, x.scene, cfg, estbench.stub_tables(tables, x.tri), x.ro, x.rd,
                          x.pixel, x.sample).numpy()
    want = _jax_trace(j, estimator, _jax_stub(j, estimator))
    assert got.shape == (N, 3) and float(np.abs(want).max()) > 0.05
    assert _mismatched_rays(got, want) <= 0.02 * N


def _pallas_tables(j, estimator):
    """JAX tables whose queries run the TPU kernels in interpret mode."""
    tables = j["tables"] if estimator == "reference" else j["tables_pbrt"]
    cfg = j["cfg"]
    table = pk.pack_triangles(j["scene"].vertices, j["scene"].faces)
    return integ_jax.TraceTables.custom(
        tables.face_data, tables.light_data,
        closest_fn=lambda ro, rd, t1: pk.closest_hit(table, ro, rd, cfg.t_min, t1,
                                                     interpret=True),
        any_hit_fn=lambda ro, rd, t1: pk.occluded(table, ro, rd, cfg.t_min, t1,
                                                  interpret=True))


@pytest.fixture(scope="module")
def setup_c4():
    """The harness's inputs at C4_N rays, on both sides."""
    return _setup(C4_N)


@pytest.mark.parametrize("estimator", ["reference", "pbrt"])
def test_trace4_full_matches_jax_and_oracle(setup_c4, estimator):
    """Both estimators with the kernels (their twins here) against the JAX
    trace driving the TPU kernels in interpret mode, by ROADMAP C4's
    criterion as tests/test_torch_integrator.py applies it: at most 2% of
    the rays differ (rtol 1e-4, atol 1e-6), and the port differs from the
    float32 NumPy oracle on no more rays than the JAX path does.

    The count is taken over C4_N = 2,048 rays, the sample C4 states its
    counts on. These rays start anywhere in the box, many on a box's face,
    and a grazing shadow ray flips with the last ulp of its origin: on the
    first 512 the port differs from the oracle on 1 ray and JAX on none; on
    2,048, 2 and 3 (float64 oracle: 2 and 1); on 8,192, 6 and 9 (float64: 8
    and 9)."""
    x, j = setup_c4
    n = C4_N
    trace = trace_reference if estimator == "reference" else trace_pbrt
    cfg, tables = (x.cfg, x.tables) if estimator == "reference" else (x.cfg_pbrt, x.tables_pbrt)
    got = estbench.trace4(trace, x.scene, cfg, tables, x.ro, x.rd, x.pixel, x.sample).numpy()
    want = _jax_trace(j, estimator, _pallas_tables(j, estimator))
    assert float(np.abs(want).max()) > 0.05
    assert _mismatched_rays(got, want) <= 0.02 * n
    oracle = ref.trace_reference if estimator == "reference" else ref_pbrt.trace_pbrt
    cfg_j = j["cfg"] if estimator == "reference" else j["cfg_pbrt"]
    h = x.host
    rad_np = np.array([oracle(j["host"], cfg_j, h["ro"][i], h["rd"][i], int(h["pixel"][i]), 0,
                              SEED, np.float32) for i in range(n)])
    assert _mismatched_rays(got, rad_np) <= _mismatched_rays(want, rad_np)


def test_kernel_pair_matches_jax_and_oracle(setup):
    """B1 + B2 (their twins here) against the TPU kernels in interpret mode
    by C4's criterion: at most 2% of the rays differ, and no more rays off
    the float64 oracle (ref/scalar.intersect_ray, occluded) than JAX's."""
    x, j = setup
    got = estbench.kernel_pair(x.tables.tri_table, x.cfg, x.ro, x.rd).numpy()
    table = pk.pack_triangles(j["scene"].vertices, j["scene"].faces)
    cfg = j["cfg"]
    _, t_j, _ = pk.closest_hit(table, j["ro"], j["rd"], cfg.t_min, cfg.t_max, interpret=True)
    occ_j = pk.occluded(table, j["ro"], j["rd"], cfg.t_min, 1.0, interpret=True)
    want = np.asarray(t_j) + np.asarray(occ_j).astype(np.float32)
    host64 = j["host"]._replace(vertices=j["host"].vertices.astype(np.float64))
    h = x.host
    oracle = []
    for i in range(N):
        ro, rd = h["ro"][i].astype(np.float64), h["rd"][i].astype(np.float64)
        hit, t, _ = ref.intersect_ray(host64, ro, rd, cfg.t_min, cfg.t_max)
        oracle.append((t if hit else 0.0) + float(ref.occluded(host64, ro, rd, cfg.t_min, 1.0)))
    oracle = np.array(oracle)[:, None]
    assert float(np.abs(want).max()) > 0.5
    off = lambda a: int((~np.isclose(a[:, None], oracle, rtol=1e-4, atol=1e-6)).sum())
    assert _mismatched_rays(got[:, None], want[:, None]) <= 0.02 * N
    assert off(got) <= off(want)


ROWS = ["rng1", "rng2", "rng_bounce", "fetch_face", "fetch_light", "shade", "camera",
        "trace4_full", "trace4_stub", "pbrt_trace4_full", "pbrt_trace4_stub", "kernel_pair"]


def test_main_on_the_cpu_prints_every_row(capsys):
    """main(["--device", "cpu", ...]) prints every row and ends with one JSON
    line; the trace rows count 4 twin calls of each whole-table query, the
    pair one, the stub rows and the other stages none."""
    assert estbench.main(["--device", "cpu", "--n", "256", "--reps", "1"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    for name in ROWS:
        assert any(line.startswith(name + " ") for line in out), name
    result = json.loads(out[-1])
    assert sum(line.startswith("{") for line in out) == 1
    assert result["harness"] == "estbench" and result["card"] == "cpu"
    rows = {r["name"]: r for r in result["rows"]}
    assert list(rows) == ROWS
    # the whole run's counts: no launch on the CPU, the twins of both queries
    assert result["launches_total"] == {}
    assert result["twin_calls_total"]["closest_hit"] == result["twin_calls_total"]["occluded"] > 8
    for name, r in rows.items():
        assert r["launches"] == {} and r["graph_ms"] is None
        want = {"trace4_full": 4, "pbrt_trace4_full": 4, "kernel_pair": 1}.get(name)
        assert r["twin_calls"] == ({"closest_hit": want, "occluded": want} if want else {})
